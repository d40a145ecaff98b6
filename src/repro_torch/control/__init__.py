"""Closed-loop adaptive redundancy control.

The paper's result — the optimal (n, k) depends sharply on the
service-time family and scaling model — becomes actionable only when the
system LEARNS the distribution online and re-plans when it drifts.  This
package closes that loop on top of the planner and the queueing engines:

  estimators.py   streaming sufficient-statistic estimators for the three
                  families with exponential forgetting + exact-likelihood
                  model selection (``OnlineSelector``, ``FittedModel``)
  detector.py     change-point detection on the service-time stream: CUSUM
                  on standardized log-survival residuals + a
                  straggle-fraction EWMA, emitting typed ``DriftEvent``s;
                  a failure-drift CUSUM on the task-outcome stream
  controller.py   ``RedundancyController``: drift -> windowed refit ->
                  closed-form re-plan (microseconds) or a load-aware
                  queueing surface on the device -> hysteresis /
                  switching-cost gate -> actuation into the runtime;
                  graceful fleet degradation (quarantine + rule-of-three
                  redundancy floor + oracle fallback) on task losses
  replay.py       closed-loop evaluation: replay a ``RegimeTrace`` through
                  the controller and score regret vs. the clairvoyant
                  per-regime oracle

Estimators, detectors and closed-form re-plans are host numpy; load-aware
re-plans and replay's static lanes run on the ``device`` the controller
and ``replay`` are given (default ``"cuda"``).  The typed front door is
``repro_torch.api.AdaptivePlanner``.
"""
from .controller import (ControlEvent, ControllerConfig,  # noqa: F401
                         HedgedServeActuator, RedundancyController,
                         TrainerActuator)
from .detector import (DriftDetector, DriftEvent,  # noqa: F401
                       FailureDriftDetector, LoadDriftDetector,
                       SojournDriftDetector)
from .estimators import (ArrivalEstimator, ArrivalModel,  # noqa: F401
                         BiModalEstimator, FittedModel, LossModel,
                         LossRateEstimator, OnlineSelector,
                         ParetoEstimator, ShiftedExpEstimator, SojournModel,
                         SojournEstimator, fit_window)
from .replay import ReplayResult, replay  # noqa: F401

__all__ = [
    "ArrivalEstimator", "ArrivalModel", "BiModalEstimator", "ControlEvent",
    "ControllerConfig", "DriftDetector", "DriftEvent",
    "FailureDriftDetector", "FittedModel", "HedgedServeActuator",
    "LoadDriftDetector", "LossModel", "LossRateEstimator", "OnlineSelector",
    "ParetoEstimator", "RedundancyController", "ReplayResult",
    "ShiftedExpEstimator", "SojournDriftDetector", "SojournEstimator",
    "SojournModel", "TrainerActuator", "fit_window", "replay",
]
