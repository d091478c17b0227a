"""NDJSON sink for the flight recorder's streams.

One file carries every record kind, discriminated by ``"k"`` (``meta`` /
``trace`` / ``metrics``); federation members share one sink and are told
apart by each record's ``campaign`` label.  Every line is serialized with
sorted keys, compact separators, and ``allow_nan=False`` after a
non-finite-float sweep, so the stream is byte-identical across processes
for identical (scenario, scale, seed, n_datasets) runs — the cross-process
determinism test diffs the raw bytes.  Timestamps are **sim-clock**
seconds; no wall clock, uuid, or pid ever reaches the stream.
"""
from __future__ import annotations

import json
import math
from typing import IO, Union


def sanitize(obj):
    """A copy of ``obj`` with every non-finite float replaced by ``None``
    (JSON has no NaN/inf; ``allow_nan=False`` would otherwise raise)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def json_line(obj: dict) -> str:
    """The canonical one-line serialization: sorted keys, compact, NaN-free.
    Stable byte-for-byte across processes for equal inputs."""
    return json.dumps(sanitize(obj), sort_keys=True,
                      separators=(",", ":"), allow_nan=False)


class ObsSink:
    """Append-only NDJSON writer shared by every obs engine of a run."""

    def __init__(self, target: Union[str, IO[str]]):
        if hasattr(target, "write"):
            self._f: IO[str] = target
            self._own = False
        else:
            self._f = open(target, "w")
            self._own = True
        self.records = 0

    def emit(self, kind: str, payload: dict) -> None:
        rec = dict(payload)
        rec["k"] = kind
        self._f.write(json_line(rec) + "\n")
        self.records += 1

    def emit_line(self, line: str) -> None:
        """Write an already-serialized record (the trace ring stores its
        events pre-serialized; re-encoding would only burn time)."""
        self._f.write(line + "\n")
        self.records += 1

    def close(self) -> None:
        self._f.flush()
        if self._own:
            self._f.close()
