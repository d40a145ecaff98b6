"""Runtime pieces of the port: the cluster/queueing engines (the
discrete-event oracle, the batched lane engine and the chunked fleet
engine with its streaming statistics and surface cache), straggler
sampling, the FR-coded step's expected completion time and the
telemetry windows the control loop fits."""
from .cluster import (ClusterConfig, ClusterResult, latency_vs_redundancy,
                      optimal_k_vs_load, simulate)
from .straggler import (StragglerSim, best_fr_policy, fr_completion_survival,
                        fr_expected_completion, plan_fr)
from .telemetry import (ArrivalStats, FleetHealth, InsufficientTelemetry,
                        StraggleStats, Telemetry)

__all__ = ["ArrivalStats", "ClusterConfig", "ClusterResult", "FleetHealth",
           "InsufficientTelemetry", "StraggleStats", "StragglerSim",
           "Telemetry", "best_fr_policy", "fr_completion_survival",
           "fr_expected_completion", "latency_vs_redundancy",
           "optimal_k_vs_load", "plan_fr", "simulate"]
