"""Runtime pieces of the port: the cluster/queueing engines (the
discrete-event oracle, the batched lane engine and the chunked fleet
engine with its streaming statistics and surface cache), straggler
sampling and the FR-coded step's expected completion time."""
from .cluster import (ClusterConfig, ClusterResult, latency_vs_redundancy,
                      optimal_k_vs_load, simulate)
from .straggler import (StragglerSim, best_fr_policy, fr_completion_survival,
                        fr_expected_completion, plan_fr)

__all__ = ["ClusterConfig", "ClusterResult", "StragglerSim",
           "best_fr_policy", "fr_completion_survival",
           "fr_expected_completion", "latency_vs_redundancy",
           "optimal_k_vs_load", "plan_fr", "simulate"]
