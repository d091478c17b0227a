"""The traced run: the profiler over the window, the harness's spans, and
the reduction of both to intervals the metric readers read.

With ``--trace 1`` the window runs under ``torch.profiler``: the device's
activity, and on the host the harness's spans alone (the user scope; the
per-operator host events, which double the time of a launch-bound step,
are not recorded).  The drivers open spans (``record_function`` ranges) at
the calls into the program's layers: ``audit.read`` (a file verified),
``audit.fold`` (one hash call), ``serve.prefill``, ``serve.decode``,
``train.fwd_bwd``, ``train.adamw``, ``prefill.scan`` (one B4 call).  A
span opened with ``sync=True`` synchronises the card at both ends, so the
device work inside its host interval is exactly the call's: that is how a
roofline finds the kernels a call launched, whatever their names.  A span
may carry attributes (bytes, shapes), kept in order beside it.

``tick()`` is called by a driver at unit boundaries (a file, a decode
step, a training step); once the traced seconds have passed it stops the
profiler, so the trace holds whole units and stays small enough to read.
A traffic may ask for an untraced lead (``trace_lead_seconds``): the
window then starts with the profiler off, so that a driver reads the
program's own spans and counters as they run untraced, and the profiler
begins at the first tick that ends a whole unit of the traffic (a wave)
once the lead has passed.  It is the lead and not a tail: once stopped,
the profiler leaves the launch-bound decode step slower, as if it were
still on.

Device time is given to a span by launch: a kernel counts in the span
whose host interval holds the runtime call that launched it (the two
joined by their correlation id), so a kernel of a few microseconds is not
lost to the offset between the host's and the device's clocks.
The raw kineto events are read directly (``kineto_results.events()``),
without building the profiler's event tree.

With ``--trace 0`` a ``Tracer`` is off: spans are no-ops and nothing is
synchronised.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


@dataclass
class Span:
    name: str
    start: int          # ns, the profiler's clock
    end: int
    attrs: dict


@dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    launch: Optional[int] = None          # its launch on the host, if seen

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class TraceData:
    window: Tuple[int, int]
    ops: List[DeviceOp]                   # sorted by start
    spans: Dict[str, List[Span]] = field(default_factory=dict)
    _starts: Optional[List[int]] = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the window."""
        w0, w1 = self.window
        out: List[List[int]] = []
        for op in self.ops:
            s, e = max(op.start, w0), min(op.end, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def in_span(self, span: Span) -> float:
        """Device seconds of the kernels (not copies or fills) launched in
        ``span`` (without a launch seen, whose midpoint lies in it)."""
        if self._starts is None:
            self._starts = [op.start for op in self.ops]
        i = bisect.bisect_left(self._starts, span.start - 10_000_000)
        total = 0
        for op in self.ops[i:]:
            if op.start > span.end + 10_000_000:
                break
            at = op.launch if op.launch is not None \
                else (op.start + op.end) // 2
            if span.start <= at <= span.end and op.is_kernel:
                total += op.end - op.start
        return total / 1e9

    def op_seconds(self, pred: Callable[[str], bool]) -> float:
        w0, w1 = self.window
        return sum(max(0, min(op.end, w1) - max(op.start, w0))
                   for op in self.ops if pred(op.name)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, by name, and the idle time
        inside the window by the innermost span the host was in."""
        by: Dict[str, int] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0) + (op.end - op.start)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((s for name, ss in self.spans.items()
                        if name != WINDOW for s in ss),
                       key=lambda s: s.start)
        idle: Dict[str, int] = {}
        w0, w1 = self.window
        prev = w0
        for s, e in self.busy() + [(w1, w1)]:
            if s > prev:
                mid = (prev + s) // 2
                inner = [sp for sp in spans if sp.start <= mid <= sp.end]
                label = max(inner, key=lambda sp: sp.start).name \
                    if inner else "harness"
                idle[label] = idle.get(label, 0) + (s - prev)
            prev = max(prev, e)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}


class Tracer:
    def __init__(self, on: bool, seconds: float, device: torch.device,
                 lead: float = 0.0):
        self.on = on
        self.seconds = seconds
        self.lead = lead
        self.device = device
        self.active = False
        self.waiting = False
        self.data: Optional[TraceData] = None
        self.on_start: List[Callable[[], None]] = []
        self.on_stop: List[Callable[[], None]] = []
        self._attrs: Dict[str, List[dict]] = {}
        self._prof = None
        self._window = None
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False, **attrs):
        if not self.active:
            yield
            return
        if sync:
            self._sync()
        self._attrs.setdefault(name, []).append(attrs)
        with torch.profiler.record_function(name):
            yield
            if sync:
                self._sync()

    @property
    def pending(self) -> bool:
        """The profiler is on, or waits for its lead to pass."""
        return self.waiting or self.active

    def start(self) -> None:
        """The window has started: trace now, or after the lead."""
        if not self.on:
            return
        self._t0 = time.perf_counter()
        self.waiting = True
        if self.lead <= 0:
            self._begin()

    def _begin(self) -> None:
        from torch.autograd import profiler as autograd_profiler
        from torch.profiler import ProfilerActivity, profile
        from torch._C._profiler import RecordScope
        self.waiting = False
        for fn in self.on_start:
            fn()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        # torch.profiler records every operator on the host; the user
        # scope alone keeps the spans and drops that cost
        enable, called = autograd_profiler._enable_profiler, []

        def user_scope(config, activities, scopes=frozenset()):
            called.append(True)
            return enable(config, activities, {RecordScope.USER_SCOPE})
        autograd_profiler._enable_profiler = user_scope
        try:
            self._prof.start()
        finally:
            autograd_profiler._enable_profiler = enable
        assert called, "torch.profiler no longer enables through " \
            "torch.autograd.profiler._enable_profiler"
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def tick(self, whole: bool = True) -> None:
        """A unit has ended (``whole``: one the traffic is made of, not a
        step inside it): begin once the lead has passed, stop once the
        traced seconds have."""
        now = time.perf_counter()
        if self.waiting and whole and now - self._t0 >= self.lead:
            self._begin()
        elif self.active and now - self._t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        self.waiting = False
        if not self.active:
            return
        self.active = False
        for fn in self.on_stop:
            fn()
        self._sync()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.data = _reduce(self._prof.profiler.kineto_results.events(),
                            self._attrs)
        self._prof = None


def _reduce(events, attrs: Dict[str, List[dict]]) -> TraceData:
    from torch.autograd import DeviceType
    ops: List[DeviceOp] = []
    spans: Dict[str, List[Span]] = {}
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != DeviceType.CUDA
                and not e.is_user_annotation() and e.correlation_id()}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append(DeviceOp(e.name(), e.start_ns(), e.end_ns(),
                                    launches.get(e.correlation_id())))
        elif e.is_user_annotation():
            name = e.name()
            if name == WINDOW or name in attrs:
                spans.setdefault(name, []).append(
                    Span(name, e.start_ns(), e.end_ns(), {}))
    for name, ss in spans.items():
        ss.sort(key=lambda s: s.start)
        for s, a in zip(ss, attrs.get(name, [])):
            s.attrs = a
    ops.sort(key=lambda op: op.start)
    win = spans.get(WINDOW)
    window = (win[0].start, win[0].end) if win else (
        ops[0].start if ops else 0, ops[-1].end if ops else 0)
    return TraceData(window, ops, spans)
