"""Runtime pieces of the port: straggler sampling and the FR-coded step's
expected completion time."""
from .straggler import (StragglerSim, best_fr_policy, fr_completion_survival,
                        fr_expected_completion, plan_fr)

__all__ = ["StragglerSim", "best_fr_policy", "fr_completion_survival",
           "fr_expected_completion", "plan_fr"]
