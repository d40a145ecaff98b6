"""The metrics plane: named counters, gauges, and streaming histograms.

A process-global :data:`REGISTRY` replaces module-local accounting (the
surface cache's hit/miss globals, the controller's fallback counter)
with one queryable namespace.  Metrics are *state*, the flight recorder
(``obs.recorder``) is *timeline* — instrumented code typically updates
both: the counter for cheap always-on aggregation, the event only when
a recorder is installed.

``StreamHist`` is the host-side scalar twin of the fleet engine's
streaming statistics (``runtime/streamstats.py``): the same Welford
count/mean/M2 recursion for moments and the same Vitter Algorithm-R
reservoir for quantiles — bounded memory at any stream length, and
EXACT quantiles whenever the count is at most the reservoir capacity
(the property the SLO monitor's 2%-of-exact bench gate leans on).  The
acceptance uniforms come from a deterministic splitmix64 stream seeded
per histogram, so two identically-fed histograms hold identical
reservoirs — metric state is replay-deterministic, like every other
piece of controller state.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "MetricsRegistry", "REGISTRY", "StreamHist"]


class Counter:
    """A monotonically increasing count (resettable for test brackets)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount: int = 1) -> None:
        self.value += amount

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """A last-write-wins scalar (RSS, queue depth, current k, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def reset(self) -> None:
        self.value = None


def _splitmix64(state: int) -> tuple:
    """One splitmix64 step -> (new_state, uniform in [0, 1))."""
    state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z ^= z >> 31
    return state, (z >> 11) * (1.0 / (1 << 53))


class StreamHist:
    """Streaming moments + reservoir quantiles in O(capacity) memory.

    Welford update per sample (count/mean/M2, the serial special case
    of ``streamstats.welford_merge_chunk``); Algorithm-R reservoir with
    deterministic splitmix64 acceptance uniforms.  ``quantile(q)`` is
    exact while ``count <= capacity`` (the reservoir then holds every
    sample) and an unbiased uniform subsample beyond.
    """

    __slots__ = ("capacity", "count", "mean", "_m2", "_res", "_rng",
                 "vmin", "vmax")

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self._res: List[float] = []
        self._rng = (int(seed) * 0x9E3779B97F4A7C15 + 1) \
            & 0xFFFFFFFFFFFFFFFF
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def update(self, x: float) -> None:
        x = float(x)
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        res = self._res
        if len(res) < self.capacity:
            res.append(x)
        else:
            # Vitter Algorithm R: replace slot floor(u * t) w.p. R/t
            self._rng, u = _splitmix64(self._rng)
            pos = int(u * self.count)
            if pos < self.capacity:
                res[pos] = x

    @property
    def var(self) -> float:
        return self._m2 / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self._res:
            raise ValueError("quantile of an empty histogram")
        return float(np.quantile(np.asarray(self._res), q))

    def values(self) -> np.ndarray:
        """The reservoir contents (== every sample when count <=
        capacity)."""
        return np.asarray(self._res, dtype=np.float64)

    def snapshot(self) -> dict:
        out = {"count": self.count, "mean": self.mean, "var": self.var,
               "min": self.vmin if self.count else None,
               "max": self.vmax if self.count else None}
        if self._res:
            out.update({f"p{int(q * 100)}": self.quantile(q)
                        for q in (0.50, 0.95, 0.99)})
        return out

    def reset(self) -> None:
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self._res = []
        self.vmin = float("inf")
        self.vmax = float("-inf")


class MetricsRegistry:
    """Named metric namespace.  ``counter``/``gauge``/``hist`` create on
    first use and return the same object afterwards; a name collision
    across types raises instead of silently shadowing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def hist(self, name: str, capacity: int = 4096) -> StreamHist:
        # seed derived from the name so identically named histograms in
        # two processes draw the same acceptance stream
        seed = sum(name.encode()) + len(name)
        return self._get(name, StreamHist,
                         lambda: StreamHist(capacity=capacity, seed=seed))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """All metrics as plain JSON-able values."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            if isinstance(m, StreamHist):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

    def reset(self) -> None:
        """Zero every metric (tests bracket with this; names persist)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()


#: The process-global default registry.
REGISTRY = MetricsRegistry()
