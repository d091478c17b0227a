"""Declarative demand (user-traffic) specification.

Mirrors ``repro_torch.control.policy.TransferPolicySpec``: a frozen dataclass a
``ScenarioSpec`` carries, whose default (``NO_DEMAND``, zero users) compiles
to **no demand engine at all** — a scenario that does not opt in runs exactly
the code path (and trajectory) it ran before this subsystem existed.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.routes import GB

KNOWN_EVICTION = ("lru", "popularity", "pin")


@dataclass(frozen=True)
class DemandSpec:
    """A synthetic user population reading the campaign's catalog.

    Request volume is ``users * requests_per_user_day`` reads/day, Zipf-skewed
    over a seeded popularity permutation of the catalog and modulated by a
    diurnal curve.  Requests are admitted in waves every ``wave_interval_s``
    of sim time (the serving engine's wave-admission shape); each wave's
    non-cached reads register as concurrent reader streams on the serving
    site's read cap, where they contend with replication movers.
    """
    # ---- population and skew
    users: int = 0                       # 0 = no demand engine (NO_DEMAND)
    requests_per_user_day: float = 0.01  # mean dataset reads per user per day
    zipf_s: float = 1.1                  # popularity exponent (rank^-s)
    drift_interval_days: float = 0.0     # 0 = popularity never drifts
    drift_fraction: float = 0.2          # fraction of ranks reshuffled per drift
    diurnal_amplitude: float = 0.5       # load swing around the mean, [0, 1)
    # ---- admission and service model
    wave_interval_s: float = 6 * 3600.0  # request-admission cadence
    request_bytes: int = 4 * GB          # bytes served per read (capped at ds size)
    stream_bps: float = 0.25 * GB        # nominal per-reader-stream rate
    miss_penalty_s: float = 30.0         # redirect-to-source overhead on a miss
    hit_overhead_s: float = 0.05         # cache-hit service overhead
    # ---- per-replica read cache
    cache_bytes: int = 0                 # capacity per replica site; 0 = unbounded
    eviction: str = "lru"                # lru | popularity | pin
    warm_per_wave: int = 0               # proactive cache warm-ups per wave
    # ---- replication policy coupling
    prioritize: bool = True              # popular-first direct-heap priorities

    @property
    def enabled(self) -> bool:
        """True when this spec needs a live demand engine."""
        return self.users > 0

    def validate(self) -> None:
        if self.users < 0:
            raise ValueError(f"users must be >= 0, got {self.users}")
        if not self.enabled:
            return
        if self.requests_per_user_day < 0:
            raise ValueError("requests_per_user_day must be >= 0, got "
                             f"{self.requests_per_user_day}")
        if self.zipf_s <= 0:
            raise ValueError(f"zipf_s must be > 0, got {self.zipf_s}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        if not 0.0 <= self.drift_fraction <= 1.0:
            raise ValueError("drift_fraction must be in [0, 1], got "
                             f"{self.drift_fraction}")
        if self.drift_interval_days < 0:
            raise ValueError("drift_interval_days must be >= 0, got "
                             f"{self.drift_interval_days}")
        if self.wave_interval_s <= 0:
            raise ValueError("wave_interval_s must be > 0, got "
                             f"{self.wave_interval_s}")
        if self.request_bytes <= 0:
            raise ValueError("request_bytes must be > 0, got "
                             f"{self.request_bytes}")
        if self.stream_bps <= 0:
            raise ValueError(f"stream_bps must be > 0, got {self.stream_bps}")
        if self.cache_bytes < 0:
            raise ValueError(f"cache_bytes must be >= 0, got "
                             f"{self.cache_bytes}")
        if self.eviction not in KNOWN_EVICTION:
            raise ValueError(f"unknown eviction {self.eviction!r} "
                             f"(known: {', '.join(KNOWN_EVICTION)})")
        if self.warm_per_wave < 0:
            raise ValueError(f"warm_per_wave must be >= 0, got "
                             f"{self.warm_per_wave}")


NO_DEMAND = DemandSpec()
