"""The hot path's span log: spans and counts on the profiler's host clock.

Every stamp is ``time.time_ns()``, Unix nanoseconds: the clock kineto
stamps a profile's host events with (``record_function`` ranges, and the
runtime calls that launch device work).  A span in this log therefore lies
on a device trace as it is, with no synchronisation: a kernel belongs to
the span whose interval holds its launch.

There are two grades.  A coarse span (``span``) is recorded always; there
are O(1) of them a serving wave, a decode step or an optimizer step, and
each costs two clock reads and an append.  A fine span (``fine``) and a
count (``count``) are recorded only while a torch profiler runs
(``torch.autograd._profiler_enabled()``): they exist to attribute device
time, which needs the trace anyway.  With the profiler off a fine span
costs that one check and takes no timestamp, and a count keeps nothing.

``LOG`` holds the last ``CAPACITY`` records, oldest first; a record joins
it when it opens, so the log is ordered by start.  Each record has a
process-wide ``index``, and ``parent``, the index of the span open around
it on its thread (None at the top).  A span's attrs may be set while it is
open.

The rest of ``repro_torch.obs`` is the replication simulator's telemetry,
on the simulated clock (``TraceRecorder``, ``MetricsRegistry``,
``PhaseProfiler``); this module is the only one on the host's clock.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Any, List, Optional

import torch

CAPACITY = 16384
LOG: deque = deque(maxlen=CAPACITY)

_index = itertools.count()
_local = threading.local()
_profiling = torch.autograd._profiler_enabled


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    __slots__ = ("index", "name", "start", "end", "parent", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.index = -1
        self.start = self.end = 0
        self.parent: Optional[int] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.index = next(_index)
        self.parent = stack[-1].index if stack else None
        stack.append(self)
        LOG.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        _stack().pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class Count:
    __slots__ = ("index", "name", "at", "value", "parent", "attrs")

    def __init__(self, name: str, value: Any, attrs: dict):
        stack = _stack()
        self.index = next(_index)
        self.name = name
        self.at = time.time_ns()
        self.value = value
        self.parent = stack[-1].index if stack else None
        self.attrs = attrs


_OFF = contextlib.nullcontext()         # a fine span with the profiler off


def span(name: str, **attrs) -> Span:
    """A coarse span, recorded always: ``with span(...) as sp:``."""
    return Span(name, attrs)


def fine(name: str, **attrs):
    """A fine span, recorded only while a torch profiler runs."""
    return Span(name, attrs) if _profiling() else _OFF


def count(name: str, value: Any, **attrs) -> None:
    """A count of ``value`` (a number or a tensor, held as given), recorded
    only while a torch profiler runs."""
    if _profiling():
        LOG.append(Count(name, value, attrs))
