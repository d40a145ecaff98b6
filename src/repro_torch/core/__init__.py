"""Core library: the paper's diversity/parallelism contribution.

Public API re-exports for the service-time models, order statistics,
expected completion times, the k* planner, MDS/gradient coding, and the
Monte-Carlo simulator.
"""
from .distributions import (FAMILIES, BiModal, Pareto, Scaling, ServiceTime,
                            ShiftedExp, bimodal_low_mode, fit_service_time,
                            sample_resolution, select_service_time,
                            service_loglik)
from .expectations import completion_curve, expected_completion_time
from .planner import Plan, Strategy, divisors, plan, plan_grid, strategy_table, theorem_kstar
from .policy import Policy, RetryPolicy
from .scenario import (
    ArrivalProcess,
    DeterministicArrivals,
    FailureModel,
    MMPPArrivals,
    PoissonArrivals,
    Scenario,
    task_survival,
)
from .coding import (
    FractionalRepetitionCode,
    decode_blocks,
    decode_matrix,
    encode_blocks,
    fractional_repetition_code,
    gc_decode_weights,
    mds_generator,
    task_size_gradient,
    task_size_linear,
)
from .simulator import (
    completion_curve_mc,
    completion_curves_grid_mc,
    curve_compile_count,
    expected_completion_mc,
    job_completion_times,
    sample_task_times,
    straggler_mask,
)

__all__ = [
    "BiModal", "Pareto", "Scaling", "ServiceTime", "ShiftedExp", "fit_service_time",
    "bimodal_low_mode", "sample_resolution", "select_service_time",
    "service_loglik", "FAMILIES",
    "completion_curve", "expected_completion_time",
    "Plan", "Strategy", "divisors", "plan", "plan_grid", "strategy_table",
    "theorem_kstar", "Policy", "RetryPolicy", "Scenario", "task_survival",
    "ArrivalProcess", "PoissonArrivals", "DeterministicArrivals",
    "FailureModel", "MMPPArrivals",
    "FractionalRepetitionCode", "decode_blocks", "decode_matrix", "encode_blocks",
    "fractional_repetition_code", "gc_decode_weights", "mds_generator",
    "task_size_gradient", "task_size_linear",
    "completion_curve_mc", "completion_curves_grid_mc", "curve_compile_count",
    "expected_completion_mc", "job_completion_times",
    "sample_task_times", "straggler_mask",
]
