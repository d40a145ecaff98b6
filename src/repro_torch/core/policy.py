"""The canonical redundancy decision: ``Policy(n, k)``.

The paper's single decision object is the redundancy level k for an
[n, k] dispatch; every other quantity the layers speak is a lossless
re-expression of it:

  * code rate        r = k / n        (planner, figures)
  * task size        s = n / k        (CUs per worker, Sec. II-D)
  * replication/FR factor  c = n / k  (runtime.coded_step's ``c``; for the
    fractional-repetition gradient code each of the k part groups is served
    by c workers, so the "replication factor" and the task size coincide)

Because k must divide n, ``c = n // k`` is exact and ``Policy.from_c``
inverts it losslessly — this replaces the ad-hoc k<->c arithmetic that
previously lived in ``runtime.straggler.plan_fr`` and
``runtime.elastic.resize_plan``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .batched import divisors

__all__ = ["Policy", "RetryPolicy"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a lost or timed-out task attempt is relaunched.

    The redundancy decision (k of n) buys DIVERSITY; this object is the
    orthogonal RELAUNCH axis ("Straggler Mitigation at Scale"): when a
    worker crash kills the attempt in service — or an attempt exceeds
    ``timeout`` — the task is retried, attempt i+1 launching after an
    exponential backoff

        delay(i) = min(backoff_base * backoff_mult**i, backoff_cap)
                   * (1 + jitter * (2u - 1)),   u ~ U[0, 1)

    until ``max_attempts`` total attempts are spent, at which point the
    task is permanently lost for its job.  ``hedge_on_timeout`` marks the
    timeout as a HEDGE trigger (launch a second copy, keep the original
    running) rather than a kill; the cluster engines model one exclusive
    server per task, where a same-worker hedge is meaningless, so they
    treat it as "no timeout kill" — the serving/trainer layers implement
    the actual hedge (see DESIGN.md §9).

    Frozen and hashable: it rides ``Policy``.
    """

    max_attempts: int = 3
    backoff_base: float = 0.5
    backoff_mult: float = 2.0
    backoff_cap: float = 30.0
    jitter: float = 0.0
    timeout: Optional[float] = None
    hedge_on_timeout: bool = False

    def __post_init__(self):
        if int(self.max_attempts) < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base < 0:
            raise ValueError(
                f"backoff_base must be >= 0, got {self.backoff_base}")
        if self.backoff_mult < 1.0:
            raise ValueError(
                f"backoff_mult must be >= 1, got {self.backoff_mult}")
        if self.backoff_cap < self.backoff_base:
            raise ValueError(
                f"backoff_cap must be >= backoff_base, got "
                f"{self.backoff_cap} < {self.backoff_base}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {self.timeout}")

    def delay(self, retry_index: int, u=0.5):
        """Backoff delay before retry ``retry_index`` (0-based: the delay
        between the first failure and the second attempt is index 0).

        ``u`` in [0, 1) spreads the jittered delay across the band
        ``base_i * [1 - jitter, 1 + jitter]``; the default midpoint 0.5
        is the deterministic (jitter-free) schedule.  Plain arithmetic,
        so ``u`` may be a numpy array or a tensor.
        """
        if retry_index < 0:
            raise ValueError(f"retry_index must be >= 0, got {retry_index}")
        base = min(self.backoff_base * self.backoff_mult ** retry_index,
                   self.backoff_cap)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def schedule(self, us=None) -> List[float]:
        """The full per-retry delay list (length ``max_attempts - 1``)."""
        if us is None:
            us = [0.5] * (self.max_attempts - 1)
        if len(us) != self.max_attempts - 1:
            raise ValueError(
                f"need {self.max_attempts - 1} jitter draws, got {len(us)}")
        return [float(self.delay(i, u)) for i, u in enumerate(us)]

    @property
    def kills_on_timeout(self) -> bool:
        """Whether the engines should abort an attempt at ``timeout``
        (a hedging timeout leaves the original attempt running)."""
        return self.timeout is not None and not self.hedge_on_timeout


@dataclasses.dataclass(frozen=True, order=True)
class Policy:
    """An [n, k] redundancy decision (k divides n).

    ``retry`` attaches the relaunch axis (``RetryPolicy``) and
    ``assignment`` the placement axis (``assign.Assignment``) to the
    redundancy decision; both are excluded from ordering/equality so the
    decision identity stays the (n, k) pair — two plans that dispatch
    the same amount of redundancy compare equal even if their retry
    schedules or placements differ.
    """

    n: int
    k: int
    retry: Optional[RetryPolicy] = dataclasses.field(
        default=None, compare=False)
    #: task-to-worker placement; None = all-workers fan-out (the paper's
    #: dispatch and the backward-compatible engine default)
    assignment: Optional["Assignment"] = dataclasses.field(
        default=None, compare=False)

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if not (1 <= self.k <= self.n):
            raise ValueError(f"require 1 <= k <= n={self.n}, got k={self.k}")
        if self.n % self.k:
            raise ValueError(
                f"k={self.k} must divide n={self.n} (integer task size)")
        if self.retry is not None and not isinstance(self.retry, RetryPolicy):
            raise TypeError(
                f"retry must be a RetryPolicy, got {self.retry!r}")
        if self.assignment is not None:
            from ..assign.strategies import Assignment
            if not isinstance(self.assignment, Assignment):
                raise TypeError(f"assignment must be an Assignment "
                                f"strategy, got {self.assignment!r}")
            self.assignment.validate(self.n, self.k)

    def with_retry(self, retry: Optional[RetryPolicy]) -> "Policy":
        """The same [n, k] decision under a different relaunch schedule."""
        return dataclasses.replace(self, retry=retry)

    def with_assignment(self, assignment: Optional["Assignment"]) -> "Policy":
        """The same [n, k] decision under a different task placement."""
        return dataclasses.replace(self, assignment=assignment)

    # -- lossless re-expressions -------------------------------------------
    @property
    def c(self) -> int:
        """Replication / FR factor c = n/k (runtime.coded_step's knob)."""
        return self.n // self.k

    @property
    def task_size(self) -> int:
        """s = n/k CUs per worker (numerically equal to ``c``)."""
        return self.n // self.k

    @property
    def code_rate(self) -> float:
        """r = k/n (1 = splitting, 1/n = replication)."""
        return self.k / self.n

    @property
    def num_groups(self) -> int:
        """Part groups of the FR code (= k)."""
        return self.k

    @property
    def strategy(self) -> str:
        if self.k == 1:
            return "replication"
        if self.k == self.n:
            return "splitting"
        return "coding"

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_k(cls, n: int, k: int) -> "Policy":
        return cls(n=n, k=k)

    @classmethod
    def from_c(cls, n: int, c: int) -> "Policy":
        """Invert the runtime's replication factor: k = n/c (exact)."""
        if c < 1 or n % c:
            raise ValueError(f"c={c} must be a positive divisor of n={n}")
        return cls(n=n, k=n // c)

    @classmethod
    def legal(cls, n: int) -> List["Policy"]:
        """Every legal policy on n workers, ascending in k."""
        return [cls(n=n, k=k) for k in divisors(n)]

    @classmethod
    def nearest_legal(cls, n: int, rate: float, axis: str = "code") -> "Policy":
        """The legal policy whose rate is nearest ``rate``.

        ``axis="code"`` matches on the code rate k/n; ``axis="replication"``
        matches on the replication fraction c/n (what ``elastic.resize_plan``
        preserves across a worker-count change).  Ties resolve to the
        smaller k (resp. smaller c), matching the legacy inline argmins.
        """
        divs = divisors(n)
        if axis == "code":
            k = min(divs, key=lambda d: (abs(d / n - rate), d))
            return cls(n=n, k=k)
        if axis == "replication":
            c = min(divs, key=lambda d: (abs(d / n - rate), d))
            return cls.from_c(n, c)
        raise ValueError(f"axis must be 'code' or 'replication', got {axis!r}")
