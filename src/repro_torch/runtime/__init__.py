"""Runtime pieces of the port: the cluster/queueing engines (the
discrete-event oracle, the batched lane engine and the chunked fleet
engine with its streaming statistics and surface cache), straggler
sampling, the FR-coded step's expected completion time, the telemetry
windows the control loop fits, and the coded data-parallel training step
with its elastic re-planning."""
from .cluster import (ClusterConfig, ClusterResult, latency_vs_redundancy,
                      optimal_k_vs_load, simulate)
from .coded_step import (CodedStepConfig, CodedTrainer, make_coded_train_step,
                         make_eval_step, make_train_step, weighted_loss_fn)
from .elastic import failure_adjusted_model, resize_plan, round_unique_batch
from .straggler import (StragglerSim, best_fr_policy, fr_completion_survival,
                        fr_expected_completion, plan_fr)
from .telemetry import (ArrivalStats, FleetHealth, InsufficientTelemetry,
                        StraggleStats, Telemetry)

__all__ = ["ArrivalStats", "ClusterConfig", "ClusterResult",
           "CodedStepConfig", "CodedTrainer", "FleetHealth",
           "InsufficientTelemetry", "StraggleStats", "StragglerSim",
           "Telemetry", "best_fr_policy", "failure_adjusted_model",
           "fr_completion_survival", "fr_expected_completion",
           "latency_vs_redundancy", "make_coded_train_step",
           "make_eval_step", "make_train_step", "optimal_k_vs_load",
           "plan_fr", "resize_plan", "round_unique_batch", "simulate",
           "weighted_loss_fn"]
