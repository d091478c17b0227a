"""The observability runtime: one ``Observability`` per observed campaign.

``attach`` hangs a listener off the campaign's ``TransferTable`` (trace +
lifecycle counters), binds the scrub/demand ``obs_hook`` seams, and arms the
metrics sampler; ``run_world`` then drives ``step``/``next_action``/
``finalize`` exactly like the demand and scrub engines.  The engine is
strictly read-only with respect to world state: it consumes no RNG, mutates
nothing it observes, and is excluded from snapshots (a resumed campaign
rebuilds observability fresh), which is what makes the obs-on/obs-off
bit-identity contract hold.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.sink import ObsSink
from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.trace import TraceRecorder, lifecycle_event, to_chrome

DAY = 86400.0


class Observability:
    """Flight recorder for one campaign runtime."""

    def __init__(self, spec: ObsSpec, label: str = ""):
        spec.validate()
        self.spec = spec
        self.label = label
        self.trace: Optional[TraceRecorder] = (
            TraceRecorder(spec.trace_budget_bytes, campaign=label)
            if spec.trace else None)
        self.metrics: Optional[MetricsRegistry] = (
            MetricsRegistry() if spec.metrics else None)
        self.samples: List[dict] = []
        self.sink: Optional[ObsSink] = None
        self._rt = None
        self._clock = None
        self._next_sample = math.inf     # absolute sim time of next boundary
        self._anchored = False
        # last route-telemetry reading, for per-interval differencing
        self._last_route: Dict[Tuple[str, str], Tuple[float, int]] = {}
        self._last_sample_t = 0.0
        # dispatch time per in-flight (dataset, dest), for duration histograms
        self._dispatched_at: Dict[Tuple[str, str], float] = {}

    # ------------------------------------------------------------ wiring
    def attach(self, runtime, shared) -> None:
        """Bind to a built campaign.  Called after ``build_campaign`` has
        populated the table, so the initial NULL-row flood never reaches
        the trace."""
        self._rt = runtime
        self._clock = shared.clock
        runtime.table.add_listener(self._on_row)
        if runtime.scrub is not None:
            runtime.scrub.obs_hook = self._on_scrub_pass
        if runtime.demand is not None:
            runtime.demand.obs_hook = self._on_demand_wave

    def attach_sink(self, sink: ObsSink) -> None:
        self.sink = sink
        if self.trace is not None:
            self.trace.sink = sink
        sink.emit("meta", {
            "campaign": self.label,
            "scenario": self._rt.spec.name if self._rt is not None else "",
            "trace": self.spec.trace,
            "metrics": self.spec.metrics,
            "sample_interval_days": self.spec.sample_interval_days,
        })

    # ------------------------------------------------------------ driver
    def next_action(self, now: float) -> float:
        """Absolute sim time this engine wants the world to visit — only
        finite under ``strict_cadence`` (the default lazy sampler rides on
        iterations the physics already produces, keeping the iteration
        count bit-identical to an obs-off run)."""
        if self.metrics is None or not self.spec.strict_cadence:
            return math.inf
        return self._next_sample

    def step(self, now: float) -> None:
        if self.metrics is None:
            return
        if not self._anchored:
            self._anchored = True
            self._last_sample_t = now
            self._sample(now)
            self._next_sample = now + self.spec.sample_interval_days * DAY
            return
        if now >= self._next_sample:
            self._sample(now)
            while self._next_sample <= now:
                self._next_sample += self.spec.sample_interval_days * DAY

    def finalize(self, now: float) -> None:
        """Campaign end: one closing sample plus an end-of-stream marker."""
        if self.metrics is not None and self._anchored \
                and now > self._last_sample_t:
            self._sample(now)
        self._next_sample = math.inf
        if self.sink is not None:
            self.sink.emit("meta", {"campaign": self.label, "end_day":
                                    round(now / DAY, 6)})

    # ------------------------------------------------------------ hooks
    def _on_row(self, rec, old_status, old_source) -> None:
        # progress-only updates are the hot path's overwhelming majority
        # (every poll of every ACTIVE row): bail before any further work
        if old_status is rec.status and old_source == rec.source:
            return
        evt = lifecycle_event(rec, old_status, old_source)
        if evt is None:
            return
        event, fields = evt
        now = self._clock.now
        if self.metrics is not None:
            self.metrics.counter(f"lifecycle.{event}").inc()
            key = (rec.dataset, rec.destination)
            if event in ("dispatched", "resumed", "relay-hop"):
                self._dispatched_at.setdefault(key, now)
            elif event in ("succeeded", "failed", "quarantined", "paused"):
                t0 = self._dispatched_at.pop(key, None)
                if t0 is not None and event == "succeeded":
                    self.metrics.histogram("transfer_s").observe(now - t0)
        if self.trace is not None:
            self.trace.record(now, event, **fields)

    def _on_scrub_pass(self, now: float, stats: dict) -> None:
        if self.metrics is not None:
            self.metrics.counter("scrub.passes").inc()
        if self.trace is not None:
            self.trace.record(now, "scrub-pass", **stats)

    def _on_demand_wave(self, now: float, stats: dict) -> None:
        if self.metrics is not None:
            self.metrics.counter("demand.waves").inc()
        if self.trace is not None:
            self.trace.record(now, "demand-wave", **stats)

    # ------------------------------------------------------------ sampling
    def _sample(self, now: float) -> None:
        rt, transport = self._rt, self._rt and self._rt.sched.transport
        dt = max(now - self._last_sample_t, 1e-9)
        sample: dict = {
            "campaign": self.label,
            "t_day": round(now / DAY, 6),
            "bytes_at": {d: rt.table.bytes_at(d)
                         for d in rt.cfg.replicas},
            "status": rt.table.status_counts(),
            "queue_depth": rt.sched.queue_depth(),
            "backoff_depth": rt.sched.backoff_depth(),
        }
        tele = transport.route_telemetry()
        routes: dict = {}
        for route, (nbytes, faults) in tele.items():
            b0, f0 = self._last_route.get(route, (0.0, 0))
            routes[f"{route[0]}->{route[1]}"] = {
                "gbps": round((nbytes - b0) * 8.0 / dt / 1e9, 6),
                "faults": faults - f0,
            }
        self._last_route = tele
        self._last_sample_t = now
        sample["routes"] = routes
        sample["live"] = transport.live_route_counts()
        if rt.scrub is not None:
            s = rt.scrub.summary()
            sample["scrub"] = {k: s[k] for k in
                               ("detected", "repaired", "at_risk_replicas",
                                "data_at_risk_bytes")}
        if rt.demand is not None:
            d = rt.demand.summary()
            sample["demand"] = {k: d[k] for k in
                                ("requests", "hits", "hit_rate",
                                 "cache_hit_rate", "p99_s")}
        sample.update(self.metrics.snapshot())
        self.samples.append(sample)
        if self.sink is not None:
            self.sink.emit("metrics", sample)

    # ------------------------------------------------------------ exports
    def export_chrome(self) -> dict:
        """Chrome trace-event JSON of the retained trace window."""
        if self.trace is None:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        return to_chrome(self.trace.records())

    def summary(self) -> dict:
        out: dict = {"campaign": self.label,
                     "sample_interval_days": self.spec.sample_interval_days}
        if self.trace is not None:
            out["trace"] = self.trace.summary()
        if self.metrics is not None:
            out.update(self.metrics.snapshot())
            out["samples"] = len(self.samples)
            out["series"] = self.samples
        return out
