"""Per-transfer lifecycle tracing.

``TraceRecorder`` turns ``TransferTable`` row transitions (via the table's
listener seam) plus scrub-pass and demand-wave hooks into a stream of
timestamped lifecycle events:

    queued → dispatched → (paused ⇄ resumed) → succeeded
                        ↘ failed (retry) ↘ quarantined / readmitted
    relay-hop              (source rewritten to a replica donor)
    scrub-detected         (a landed replica flipped back for repair)
    scrub-pass / demand-wave (subsystem instants)

Events are ring-buffered pre-serialized (one NDJSON line each) under a byte
budget, so in-memory retention is O(active window), never O(campaign
history); a streaming ``ObsSink`` receives every event regardless of ring
eviction.  ``to_chrome`` converts a stream into Chrome trace-event JSON
(load it at https://ui.perfetto.dev): **1 trace microsecond == 1 sim
second**, one process per campaign, one thread lane per (dataset,
destination) transfer, spans named by their closing transition.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.transfer_table import Status, TransferRecord
from repro_torch.obs.sink import ObsSink, json_line

# events that open an activity span / close one, for the Chrome exporter
_OPENING = ("dispatched", "resumed")
_CLOSING = ("paused", "succeeded", "failed", "scrub-detected", "quarantined")


def lifecycle_event(rec: TransferRecord, old_status: Optional[Status],
                    old_source: Optional[str]
                    ) -> Optional[Tuple[str, Dict]]:
    """Map one table row transition to a ``(event, fields)`` pair, or None
    for transitions that carry no lifecycle information (progress-only
    updates, which the hot path fires for every poll)."""
    if old_status is rec.status and old_source == rec.source:
        return None                      # progress-only update
    fields: Dict = {"dataset": rec.dataset, "dest": rec.destination,
                    "src": rec.source}
    s = rec.status
    if s is Status.NULL:
        return "created", fields         # a top-up row entering the table
    if s is Status.QUEUED:
        return "queued", fields
    if s is Status.ACTIVE:
        if old_status is Status.PAUSED:
            return "resumed", fields
        if old_source is not None and old_source != rec.source:
            fields["relay_from"] = old_source
            return "relay-hop", fields
        return "dispatched", fields
    if s is Status.PAUSED:
        return "paused", fields
    if s is Status.SUCCEEDED:
        fields["bytes"] = rec.bytes_transferred
        fields["faults"] = rec.faults
        return "succeeded", fields
    if s is Status.FAILED:
        if old_status is Status.SUCCEEDED:
            return "scrub-detected", fields   # repair re-admission
        if old_status is Status.QUARANTINED:
            return "readmitted", fields
        fields["retries"] = rec.retries
        fields["faults"] = rec.faults
        return "failed", fields
    if s is Status.QUARANTINED:
        fields["faults"] = rec.faults
        return "quarantined", fields
    return None


class TraceRecorder:
    """Byte-budgeted ring of pre-serialized trace events."""

    def __init__(self, budget_bytes: int, campaign: str = "",
                 sink: Optional[ObsSink] = None):
        self.budget_bytes = int(budget_bytes)
        self.campaign = campaign
        self.sink = sink
        self._ring: deque = deque()
        self._bytes = 0
        self.recorded = 0               # events seen (ring + stream)
        self.dropped = 0                # ring evictions (stream keeps all)

    def record(self, t: float, event: str, **fields) -> None:
        rec = {"t": round(t, 6), "campaign": self.campaign,
               "event": event, "k": "trace"}
        rec.update(fields)
        line = json_line(rec)
        self._ring.append(line)
        self._bytes += len(line)
        self.recorded += 1
        while self._bytes > self.budget_bytes and len(self._ring) > 1:
            self._bytes -= len(self._ring.popleft())
            self.dropped += 1
        if self.sink is not None:
            self.sink.emit_line(line)

    def on_row(self, t: float, rec: TransferRecord,
               old_status: Optional[Status],
               old_source: Optional[str]) -> None:
        """The ``TransferTable`` listener body (the engine binds the sim
        clock and forwards here)."""
        evt = lifecycle_event(rec, old_status, old_source)
        if evt is not None:
            self.record(t, evt[0], **evt[1])

    def lines(self) -> List[str]:
        """The retained window, oldest first (NDJSON lines)."""
        return list(self._ring)

    def records(self) -> List[Dict]:
        return [json.loads(s) for s in self._ring]

    def summary(self) -> dict:
        return {
            "events": self.recorded,
            "retained": len(self._ring),
            "dropped": self.dropped,
            "ring_bytes": self._bytes,
            "budget_bytes": self.budget_bytes,
        }


# ------------------------------------------------------------ Chrome export
def to_chrome(records: Iterable[Dict]) -> Dict:
    """Chrome trace-event JSON from a stream of parsed obs records (trace
    records are used, others ignored).  Timestamps map 1 trace µs == 1 sim
    second, so Perfetto's "1.234 ms" reads as 1234 sim seconds; spans cover
    a transfer's active periods and are named by the transition that closed
    them; everything else lands as an instant on the transfer's lane."""
    events: List[Dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[int, str, str], int] = {}
    open_at: Dict[Tuple[int, int], float] = {}      # (pid, tid) -> span start

    def pid_of(campaign: str) -> int:
        pid = pids.get(campaign)
        if pid is None:
            pid = pids[campaign] = len(pids) + 1
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": campaign or "campaign"}})
        return pid

    def tid_of(pid: int, dataset: str, dest: str) -> int:
        key = (pid, dataset, dest)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = sum(1 for k in tids if k[0] == pid) + 1
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"{dataset} -> {dest}"}})
        return tid

    trace = sorted((r for r in records if r.get("k") == "trace"),
                   key=lambda r: r.get("t", 0.0))
    for r in trace:
        event = r.get("event", "?")
        t = float(r.get("t", 0.0))
        pid = pid_of(r.get("campaign", ""))
        ds, dest = r.get("dataset"), r.get("dest")
        if ds is None or dest is None:          # subsystem instants
            events.append({"ph": "i", "s": "p", "pid": pid, "tid": 0,
                           "ts": t, "name": event,
                           "args": {k: v for k, v in r.items()
                                    if k not in ("k", "t", "campaign",
                                                 "event")}})
            continue
        tid = tid_of(pid, ds, dest)
        args = {k: v for k, v in r.items()
                if k not in ("k", "t", "campaign", "event",
                             "dataset", "dest")}
        if event in _OPENING:
            open_at.setdefault((pid, tid), t)
        elif event in _CLOSING and (pid, tid) in open_at:
            start = open_at.pop((pid, tid))
            events.append({"ph": "X", "pid": pid, "tid": tid, "ts": start,
                           "dur": max(0.0, t - start), "name": event,
                           "cat": "transfer", "args": args})
            continue
        events.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                       "ts": t, "name": event, "cat": "transfer",
                       "args": args})
    # close dangling spans at their last event time (kill mid-campaign)
    for (pid, tid), start in sorted(open_at.items()):
        events.append({"ph": "X", "pid": pid, "tid": tid, "ts": start,
                       "dur": 0.0, "name": "unterminated",
                       "cat": "transfer", "args": {}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"timebase": "1 trace us == 1 sim second"}}
