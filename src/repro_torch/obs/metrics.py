"""Counters, gauges, and histograms for the flight recorder.

Deliberately tiny and dependency-free: metrics must never perturb the
simulation, so every instrument is a plain Python accumulator with O(1)
updates and a deterministic, sorted snapshot.  The ``Observability`` engine
samples a registry on the sim-clock cadence and streams each sample as one
``{"k": "metrics", ...}`` NDJSON record.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Sequence, Tuple


class Counter:
    """Monotonic event count."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written level (queue depth, data at risk, ...)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


# default duration buckets, in sim seconds: 1 min .. 32 days, powers of two
_DEF_BOUNDS = tuple(60.0 * 2 ** i for i in range(0, 16))


class Histogram:
    """Fixed-bound bucket histogram with quantile estimates (upper-bound of
    the covering bucket, which is exact enough for p50/p99 reporting and —
    unlike a sample reservoir — needs no RNG)."""
    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds: Sequence[float] = _DEF_BOUNDS):
        self.bounds: Tuple[float, ...] = tuple(sorted(bounds))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        if self.total == 0:
            return 0.0
        rank = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return (self.bounds[i] if i < len(self.bounds)
                        else math.inf)
        return math.inf

    def summary(self) -> dict:
        return {
            "count": self.total,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.total, 6) if self.total else 0.0,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named instruments, created on first use, snapshotted in sorted
    order so every float reduction over a snapshot is process-stable."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Sequence[float] = _DEF_BOUNDS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(bounds)
        return h

    def snapshot(self) -> dict:
        out: dict = {}
        if self._counters:
            out["counters"] = {k: self._counters[k].value
                               for k in sorted(self._counters)}
        if self._gauges:
            out["gauges"] = {k: self._gauges[k].value
                             for k in sorted(self._gauges)}
        if self._histograms:
            out["histograms"] = {k: self._histograms[k].summary()
                                 for k in sorted(self._histograms)}
        return out
