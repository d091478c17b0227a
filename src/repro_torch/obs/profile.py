"""Per-phase wall-time profiling of the replay hot path.

``PhaseProfiler`` splits a run's wall clock into exclusive per-phase
buckets by temporarily wrapping class methods (scheduler step, transport
tick, table churn, ...).  Promoted out of ``benchmarks/campaign_replay.py``
so the scenario CLI's ``--profile`` and the bench's ``--profile`` share one
implementation; use it as a context manager:

    with PhaseProfiler() as prof:
        prof.instrument_standard()
        run_scenario(...)
    print(prof.report(wall_s))

Instrumentation only *times* the original calls — trajectories are
untouched — but the measured run is slower than a bare one, so profile
numbers belong alongside, never instead of, benchmark walls.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple


class PhaseProfiler:
    """Per-phase wall-time buckets via temporary class-method wrappers.

    Exclusive-time accounting: a stack tracks the active bucket, and time
    spent in a nested instrumented call (``TransferTable`` work inside
    ``ReplicationScheduler.step``, say) is charged to the inner bucket and
    subtracted from the outer one, so the buckets sum to at most the run's
    wall clock and never double-count.  Wrapping happens at class level so
    federation members (N schedulers over one transport) are all captured.
    """

    def __init__(self):
        self.buckets: Dict[str, float] = {}
        self._stack: List[list] = []
        self._patched: List[Tuple[type, str, object]] = []

    def wrap(self, cls, name: str, bucket: str) -> None:
        orig = getattr(cls, name)

        def timed(s, *a, _orig=orig, _b=bucket, **kw):
            t0 = time.perf_counter()
            self._stack.append([_b, 0.0])
            try:
                return _orig(s, *a, **kw)
            finally:
                dt = time.perf_counter() - t0
                b, child = self._stack.pop()
                self.buckets[b] = self.buckets.get(b, 0.0) + (dt - child)
                if self._stack:
                    self._stack[-1][1] += dt

        setattr(cls, name, timed)
        self._patched.append((cls, name, orig))

    def instrument_standard(self) -> "PhaseProfiler":
        """Wrap the canonical hot-path seams: sched (dispatch/poll),
        transport (tick + next-event hints), table (row/index churn),
        and the opt-in control/demand/scrub planes."""
        from repro_torch.control.plane import ControlPlane
        from repro_torch.core.scheduler import ReplicationScheduler
        from repro_torch.core.scrub import ScrubEngine
        from repro_torch.core.transfer_table import TransferTable
        from repro_torch.core.transport import SimulatedTransport
        from repro_torch.demand.engine import DemandEngine

        self.wrap(ReplicationScheduler, "step", "sched")
        self.wrap(SimulatedTransport, "tick", "transport")
        self.wrap(SimulatedTransport, "next_event_hint", "transport")
        self.wrap(TransferTable, "update_many", "table")
        self.wrap(TransferTable, "by_status", "table")
        self.wrap(ControlPlane, "step", "control")
        self.wrap(DemandEngine, "step", "demand")
        self.wrap(ScrubEngine, "step", "scrub")
        return self

    def restore(self) -> None:
        for cls, name, orig in self._patched:
            setattr(cls, name, orig)
        self._patched.clear()

    def __enter__(self) -> "PhaseProfiler":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    def report(self, wall_s: float) -> dict:
        """Bucket seconds and percentages, with the unattributed remainder
        of ``wall_s`` charged to a ``driver`` bucket."""
        phases = {b: round(t, 3) for b, t in sorted(self.buckets.items())}
        phases["driver"] = round(
            max(0.0, wall_s - sum(self.buckets.values())), 3)
        return {
            "wall_s": round(wall_s, 3),
            "phases_s": phases,
            "phases_pct": {b: round(100.0 * t / max(wall_s, 1e-9), 1)
                           for b, t in phases.items()},
        }
