"""The program's own span log (``repro_torch.obs.spans.LOG``), read beside
a traced run.

The program stamps its spans and counts with ``time.time_ns()``, the clock
of the profiler's host events, so they lie on the trace as they are.  A
count is given as a ``Span`` of no length whose attrs hold its ``value``.
A device op belongs to a span when the host call that launched it
(``DeviceOp.launch``) falls inside the span.  The ops are looked up
through an index sorted by launch, so an op the device runs long after its
launch (a prefill the host runs ahead of) still counts in its span; an op
whose launch the trace lacks counts in none.

A program without the log gives no records, and the readers then return
None.
"""
from __future__ import annotations

import bisect
from typing import List

from perfbench.tracing import DeviceOp, Span, TraceData


def _records() -> list:
    try:
        from repro_torch.obs import spans
    except ImportError:
        return []
    return list(spans.LOG)


def _spans(name: str) -> List[Span]:
    """The closed spans and the counts named ``name``, by start."""
    out = []
    for r in _records():
        if r.name != name:
            continue
        if hasattr(r, "at"):
            out.append(Span(name, r.at, r.at, dict(r.attrs, value=r.value)))
        elif r.end >= r.start:
            out.append(Span(name, r.start, r.end, r.attrs))
    return out


def in_window(run, name: str) -> List[Span]:
    """The program's spans or counts named ``name`` that lie wholly inside
    the traced window."""
    if run.trace is None:
        return []
    w0, w1 = run.trace.window
    return [s for s in _spans(name) if w0 <= s.start and s.end <= w1]


def before_window(run, name: str, n: int) -> List[Span]:
    """The last ``n`` spans named ``name`` that ended before the traced
    window began (fewer where the log holds fewer)."""
    if run.trace is None or n <= 0:
        return []
    return [s for s in _spans(name) if s.end < run.trace.window[0]][-n:]


_index: list = [None, [], []]          # the trace, its launches, its ops


def launched(trace: TraceData, span: Span) -> List[DeviceOp]:
    """The device ops (kernels, copies, fills) launched inside ``span``."""
    if _index[0] is not trace:
        ops = sorted((op for op in trace.ops if op.launch is not None),
                     key=lambda op: op.launch)
        _index[:] = [trace, [op.launch for op in ops], ops]
    stamps, ops = _index[1], _index[2]
    return ops[bisect.bisect_left(stamps, span.start):
               bisect.bisect_right(stamps, span.end)]


def launches(trace: TraceData, span: Span) -> int:
    """The distinct host launches of the device ops launched inside
    ``span``."""
    return len({op.launch for op in launched(trace, span)})


def device_seconds(trace: TraceData, spans: List[Span]) -> float:
    """Device seconds of every op launched inside ``spans`` (disjoint):
    kernels, and the copies and fills that are part of the same work."""
    return sum(op.end - op.start for s in spans
               for op in launched(trace, s)) / 1e9
