"""Deterministic synthetic request workload.

Millions of users are modeled at O(catalog) cost per admission wave, not
O(requests): the wave's total request count is one Poisson draw around the
diurnally-modulated population rate, and its split across datasets is one
multinomial draw over a Zipf probability vector.  Popularity is a seeded
permutation of the catalog — rank 0 is the hottest dataset — and optional
drift reshuffles a fraction of the permutation on a fixed sim-time cadence.

The RNG is a dedicated ``np.random.default_rng`` stream, seeded from the
scenario seed plus a demand-stream discriminator so it can never interleave
with the fault injector's stream; its bit-generator state serializes in
snapshots exactly like ``FaultInjector``'s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.pause import DAY
from repro_torch.demand.spec import DemandSpec

# demand RNG stream discriminator ("DEMD"): keeps the demand stream disjoint
# from the fault injector's default_rng(seed) for every scenario seed
_DEMAND_STREAM = 0x44454D44


class RequestWorkload:
    def __init__(self, spec: DemandSpec, paths: Sequence[str], seed: int = 0):
        if not paths:
            raise ValueError("request workload needs a non-empty catalog")
        self.spec = spec
        self.paths: List[str] = list(paths)
        n = len(self.paths)
        self.rng = np.random.default_rng([seed, _DEMAND_STREAM])
        # _order[r] = catalog index of the dataset with popularity rank r
        self._order: List[int] = [int(i) for i in self.rng.permutation(n)]
        w = np.arange(1, n + 1, dtype=float) ** (-spec.zipf_s)
        self._p = w / w.sum()
        self._next_drift = (spec.drift_interval_days * DAY
                            if spec.drift_interval_days > 0 else None)
        self.drifts = 0
        self._rebuild_ranks()

    def _rebuild_ranks(self) -> None:
        self._rank: Dict[str, int] = {
            self.paths[j]: r for r, j in enumerate(self._order)}

    # -------------------------------------------------------------- queries
    @property
    def n(self) -> int:
        return len(self.paths)

    def path_at_rank(self, rank: int) -> str:
        return self.paths[self._order[rank]]

    def rank_of(self, path: str) -> int:
        """Popularity rank (0 = hottest); unknown paths (mid-run top-ups)
        rank below the whole catalog."""
        return self._rank.get(path, len(self.paths))

    def probabilities(self) -> np.ndarray:
        """Per-rank request probability (rank-monotone by construction)."""
        return self._p.copy()

    def diurnal(self, t: float) -> float:
        """Load factor at sim time ``t``: 1 +/- amplitude over a 24 h cycle,
        peaking mid-day."""
        a = self.spec.diurnal_amplitude
        if a <= 0:
            return 1.0
        return 1.0 + a * math.sin(2 * math.pi * (t / DAY - 0.25))

    # ------------------------------------------------------------- sampling
    def sample_wave(self, t0: float, t1: float) -> np.ndarray:
        """Request counts by popularity rank for the interval [t0, t1):
        one Poisson draw for the wave total (rate = population rate at the
        interval midpoint), one multinomial split over the Zipf vector."""
        dt = max(0.0, t1 - t0)
        lam = (self.spec.users * self.spec.requests_per_user_day
               * (dt / DAY) * self.diurnal(0.5 * (t0 + t1)))
        total = int(self.rng.poisson(lam)) if lam > 0 else 0
        if total == 0:
            return np.zeros(len(self.paths), dtype=np.int64)
        return self.rng.multinomial(total, self._p)

    def maybe_drift(self, now: float) -> bool:
        """Reshuffle ``drift_fraction`` of the popularity ranks once per
        drift interval; returns True when the permutation changed (the
        engine then re-keys the scheduler's priority heaps)."""
        if self._next_drift is None:
            return False
        drifted = False
        n = len(self.paths)
        while now + 1e-9 >= self._next_drift:
            k = min(n, max(2, int(round(self.spec.drift_fraction * n))))
            idx = np.sort(self.rng.choice(n, size=k, replace=False))
            vals = [self._order[int(i)] for i in idx]
            shuffled = [vals[int(j)] for j in self.rng.permutation(k)]
            for i, v in zip(idx, shuffled):
                self._order[int(i)] = v
            self._next_drift += self.spec.drift_interval_days * DAY
            self.drifts += 1
            drifted = True
        if drifted:
            self._rebuild_ranks()
        return drifted

    # ---------------------------------------------------------- checkpoints
    def state_dict(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "order": list(self._order),
                "next_drift": self._next_drift,
                "drifts": self.drifts}

    def load_state_dict(self, d: dict) -> None:
        self.rng.bit_generator.state = d["rng"]
        self._order = [int(i) for i in d["order"]]
        self._next_drift = d["next_drift"]
        self.drifts = int(d["drifts"])
        self._rebuild_ranks()
