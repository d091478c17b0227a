"""Ensemble reductions: per-metric quantile bands over lane results.

The reduction is permutation-invariant by construction — every statistic
(quantiles, mean, min/max) sorts or sums over the lane axis, so shuffling
lane order cannot change a single output bit (summation order is fixed by
the sort, not by lane arrival)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

#: metrics pulled from a lane result (attribute or mapping key) by default
DEFAULT_METRICS = ("sim_days", "faults_total", "quarantined")
DEFAULT_QUANTILES = (5.0, 50.0, 95.0)


def _metric(row, name: str):
    if isinstance(row, Mapping):
        return row[name]
    return getattr(row, name)


def quantile_bands(rows: Sequence, metrics: Sequence[str] = DEFAULT_METRICS,
                   quantiles: Sequence[float] = DEFAULT_QUANTILES
                   ) -> Dict[str, Dict[str, float]]:
    """Per-metric confidence bands over ``rows`` (lane results: objects or
    mappings).  Returns ``{metric: {"p5": ..., "p50": ..., "p95": ...,
    "mean": ..., "min": ..., "max": ..., "n": ...}}``.  Values are sorted
    before every reduction, so the result is invariant under any
    permutation of ``rows``."""
    if not rows:
        raise ValueError("no lane results to reduce")
    out: Dict[str, Dict[str, float]] = {}
    for m in metrics:
        v = np.sort(np.asarray([float(_metric(r, m)) for r in rows]))
        band = {f"p{q:g}": float(np.percentile(v, q)) for q in quantiles}
        band.update(mean=float(v.mean()), min=float(v[0]), max=float(v[-1]),
                    n=int(v.size))
        out[m] = band
    return out
