"""Declarative observability configuration.

``ObsSpec`` rides on ``ScenarioSpec`` exactly like ``DemandSpec`` and
``ScrubSpec``: the default ``NO_OBS`` compiles to no engine at all — zero
listeners, zero event candidates, zero per-iteration work — so a scenario
that does not opt in replays its trajectory bit-identically, and a scenario
that *does* opt in must too (observation never mutates world state or
consumes RNG; the CI gate pins this).

Cadence semantics: metrics are sampled every ``sample_interval_days`` of
sim time.  By default (``strict_cadence=False``) samples are taken lazily
at the first driver iteration at or past each boundary, so the iteration
count — part of the trajectory bit-identity tuple — is untouched.  With
``strict_cadence=True`` the sampler registers each boundary as a
``run_world`` next-event candidate: samples land exactly on the cadence at
the cost of extra iterations (the physical trajectory — digest, faults,
bytes landed — is still identical, because the transport is segment-exact
under any time slicing).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ObsSpec:
    """Flight-recorder configuration for one campaign."""
    trace: bool = False             # record per-transfer lifecycle events
    metrics: bool = False           # sample the metrics registry on cadence
    sample_interval_days: float = 1.0
    # in-memory trace retention: oldest events are evicted once the ring
    # exceeds this many (approximate, serialized) bytes.  A streaming NDJSON
    # sink is unbounded — the budget bounds memory, not the file.
    trace_budget_bytes: int = 4 * 1024 * 1024
    # False: sample lazily at existing iterations (full trajectory-tuple
    # bit-identity, iterations included).  True: inject cadence boundaries
    # as next-event candidates (exact sample times, extra iterations).
    strict_cadence: bool = False

    @property
    def enabled(self) -> bool:
        """True when this spec needs a live observability engine."""
        return self.trace or self.metrics

    def validate(self) -> None:
        if not self.enabled:
            return
        if self.metrics and self.sample_interval_days <= 0:
            raise ValueError(
                f"sample_interval_days must be > 0, "
                f"got {self.sample_interval_days}")
        if self.trace and self.trace_budget_bytes <= 0:
            raise ValueError(
                f"trace_budget_bytes must be > 0, "
                f"got {self.trace_budget_bytes}")


NO_OBS = ObsSpec()

# the everything-on preset the CLI's --obs flag applies to scenarios that
# did not declare their own observability
FULL_OBS = ObsSpec(trace=True, metrics=True)
