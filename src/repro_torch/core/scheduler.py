"""The replication scheduler — a faithful implementation of paper Figure 4,
generalized to N replica sites.

Figure 4 logic (2291 ESGF paths × 2 destinations):
  1.  populate table with (dataset, LLNL→ALCF) and (dataset, LLNL→OLCF), NULL.
  2a. start source→primary transfers while < 2 active on the route.
  2b. poll actives; mark SUCCEEDED/FAILED.
  2c. if any transfer to primary is PAUSED, start source→secondary instead.
  2d. start replica→replica relays for datasets present at one LCF only.
  2e. symmetric relay in the other direction.
  2f. terminate when no row is NULL/ACTIVE/FAILED/PAUSED.

Key properties preserved from the paper:
  * ≤ ``max_active_per_route`` concurrent transfers per route, so one
    transfer's metadata scan overlaps another's data movement (C5);
  * the slow source is read once per dataset whenever a relay is possible (C2);
  * FAILED rows are retried with bounded retries, then QUARANTINED with a
    notification (C3);
  * re-routing rewrites the row's *source*, never loses the row (C4).

Per-step cost is O(live transfers), not O(catalog): instead of re-SELECTing
the table every pass, the scheduler subscribes to ``TransferTable`` row
transitions and maintains

  * per-destination min-heaps of datasets startable from the source
    (``_direct``), popped lazily in dataset order — the order the old
    ``SELECT ... ORDER BY dataset`` produced;
  * per-(destination, donor) heaps of relay candidates (``_relay``): a
    dataset enters when it SUCCEEDs at some replica while still outstanding
    elsewhere, bucketed by the donor the Figure-4 scan would pick (the
    first succeeded replica in priority order);
  * a retry-backoff min-heap with expired entries pruned on the way out.

Heap entries are validated against the live row when popped (lazy deletion),
so stale entries cost O(log n) once and the common-case step touches only
rows that can actually change state.

Determinism invariants (relied on by snapshots, the engine-equivalence tests,
and the ensemble lanes engine):

* **Submission order is the RNG order.**  Every ``_start`` calls
  ``transport.submit``, which consumes the shared fault stream; therefore
  the order rows are started — direct pops in (priority, dataset) order per
  destination, primary before secondaries, relays in replica/donor priority
  order, re-admitted quarantined rows strictly after the ordinary eligibles
  of the same pass — is part of the trajectory, not an implementation
  detail.
* **Poll order is (dataset, destination) order.**  ``_poll`` walks
  ``by_status`` rows in sorted order and commits one batched transaction,
  so listener-driven queue insertions happen in a reproducible sequence.
* **Retry disposition is a pure function** (``retry_disposition``): a
  FAILED poll result maps to (retries+1, QUARANTINED-vs-FAILED) from the
  row's retry count and the policy alone, with no hidden state.
* **Relay donors are historical.**  A relay candidate is bucketed under the
  donor ``_first_donor`` picked when it was *enqueued* and only migrates
  when popped; with ≤ 2 replicas the donor is unique and the bucketing is a
  pure function of table state — the property the ensemble lanes engine
  asserts before vectorizing.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple,
                    Union)

from repro_torch.core.faults import Notifier, RetryPolicy
from repro_torch.core.routes import Dataset, RouteGraph
from repro_torch.core.transfer_table import (RETRYABLE, Status, TransferRecord,
                                       TransferTable)
from repro_torch.core.transport import Transport


@dataclass
class ReplicationPolicy:
    source: str                       # e.g. "LLNL"
    replicas: Sequence[str]           # priority order, e.g. ("ALCF", "OLCF")
    max_active_per_route: int = 2     # paper: two per route (scan/move overlap)
    # live per-route overrides, written by the control plane's concurrency
    # tuner (repro.control) and serialized in its snapshot block; routes
    # without an entry use the static ``max_active_per_route``
    route_caps: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def cap(self, source: str, destination: str) -> int:
        return self.route_caps.get((source, destination),
                                   self.max_active_per_route)


OCCUPYING = (Status.ACTIVE, Status.QUEUED, Status.PAUSED)
_RETRYABLE_SET = frozenset(RETRYABLE)


def retry_disposition(retries_done, max_retries):
    """Pure retry/quarantine rule for a FAILED poll result: returns
    ``(retries, quarantine)`` where ``retries`` is the incremented count and
    ``quarantine`` is True once it exceeds ``max_retries``.  Elementwise on
    arrays (numpy/jax) so the ensemble lanes engine applies the identical
    rule to a whole batch of worlds at once."""
    retries = retries_done + 1
    return retries, retries > max_retries

# direct-queue heap entry: a bare dataset name (dataset order, the seed
# model) or a (priority, dataset) pair once a priority function is installed
_DirectEntry = Union[str, Tuple[int, str]]


def _entry_ds(entry: _DirectEntry) -> str:
    return entry if isinstance(entry, str) else entry[1]


class ReplicationScheduler:
    def __init__(self, table: TransferTable, transport: Transport,
                 catalog: Dict[str, Dataset], policy: ReplicationPolicy,
                 retry: RetryPolicy = RetryPolicy(),
                 notifier: Optional[Notifier] = None):
        self.table = table
        self.transport = transport
        self.catalog = catalog
        self.policy = policy
        self.retry = retry
        self.notifier = notifier or Notifier()
        self._backoff_until: Dict[Tuple[str, str], float] = {}
        self._backoff_heap: List[Tuple[float, Tuple[str, str]]] = []
        # per-destination queues of datasets startable direct from the source
        self._direct: Dict[str, List[_DirectEntry]] = {}
        self._direct_member: Dict[str, Set[str]] = {}
        # optional dataset -> priority mapping (lower starts first); installed
        # by the demand engine to start popular datasets before catalog order
        self._priority: Optional[Callable[[str], int]] = None
        # per-(destination, donor) relay-candidate queues
        self._relay: Dict[Tuple[str, str], List[str]] = {}
        self._relay_donor: Dict[str, Dict[str, str]] = {}  # dst -> ds -> donor
        # when re-admitting quarantined rows, the listener diverts their
        # queue insertions here: Figure 4's scan considers them *after* the
        # ordinary eligible rows of the same pass (they were appended to the
        # SELECT result), and submit order feeds the shared fault RNG, so the
        # placement must be preserved exactly
        self._defer_queue: Optional[List[str]] = None
        table.add_listener(self._on_row)
        # adopt rows that predate this scheduler (e.g. a table re-opened from
        # disk); normally the table is empty here and this is a no-op
        for rec in table.all():
            self._on_row(rec, None, None)

    # ------------------------------------------------------------------ setup
    def populate(self) -> int:
        return self.table.populate(
            sorted(self.catalog), self.policy.source, list(self.policy.replicas))

    # --------------------------------------------------------------- priority
    def set_priority(self, fn: Optional[Callable[[str], int]]) -> None:
        """Install (or clear, with None) a dataset-priority function for the
        direct-start queues: lower values start first, ties break in dataset
        order via the (priority, dataset) heap entry.  Existing entries are
        re-keyed in place, so this works whether the queues were populated
        before or after installation."""
        self._priority = fn
        self.reprioritize()

    def reprioritize(self) -> None:
        """Rebuild every direct heap under the current priority function —
        the demand engine calls this when popularity drifts.  Entry
        *multiset* is preserved (including lazy-stale entries); only the pop
        order changes."""
        for dst, heap in self._direct.items():
            self._direct[dst] = rebuilt = [
                self._direct_entry(_entry_ds(e)) for e in heap]
            heapq.heapify(rebuilt)

    def _direct_entry(self, ds: str) -> _DirectEntry:
        if self._priority is None:
            return ds
        return (int(self._priority(ds)), ds)

    # ------------------------------------------------------------------- step
    def step(self, now: float) -> List[str]:
        """One pass of the Figure-4 loop.  Returns human-readable actions."""
        actions: List[str] = []
        self._poll(now, actions)                                  # 2b
        pol = self.policy
        primary = pol.replicas[0]
        self._start_route(pol.source, primary, now, actions)      # 2a
        if self._any_paused(primary):                             # 2c
            for sec in pol.replicas[1:]:
                self._start_route(pol.source, sec, now, actions)
        self._start_relays(now, actions)                          # 2d / 2e
        return actions

    def done(self) -> bool:                                       # 2f
        return self.table.done()

    def teardown(self) -> int:
        """Cancel every transfer this scheduler still has in flight
        (slot-occupying rows), releasing their route/site fair shares to
        whoever else is using the transport — the shutdown path a federated
        campaign takes when it ends (completes or times out) while other
        campaigns keep running.  The table rows are left as they are: the
        report shows exactly how far the campaign got.  Returns the number
        of transfers cancelled."""
        n = 0
        for rec in self.table.by_status(*OCCUPYING):
            if rec.uuid is not None:
                self.transport.cancel(rec.uuid)
                n += 1
        return n

    # ----------------------------------------------------- incremental state
    def _on_row(self, rec: TransferRecord, old_status: Optional[Status],
                old_source: Optional[str]) -> None:
        """TransferTable listener: keep the pending queues current.  Heaps
        hold dataset names; entries going stale (row started elsewhere,
        succeeded, quarantined) are dropped lazily when popped."""
        if rec.status in _RETRYABLE_SET:
            if self._defer_queue is not None:
                self._defer_queue.append(rec.dataset)
                return
            self._queue_row(rec)
        elif rec.status == Status.SUCCEEDED and old_status != Status.SUCCEEDED:
            self._on_success(rec.dataset, rec.destination)

    def _queue_row(self, rec: TransferRecord) -> None:
        """Enter a retryable row into the direct and/or relay queues."""
        dst = rec.destination
        if rec.source == self.policy.source:
            member = self._direct_member.setdefault(dst, set())
            if rec.dataset not in member:
                member.add(rec.dataset)
                heapq.heappush(self._direct.setdefault(dst, []),
                               self._direct_entry(rec.dataset))
        donor = self._first_donor(rec.dataset, dst)
        if donor is not None:
            self._relay_add(dst, rec.dataset, donor)

    def _on_success(self, dataset: str, destination: str) -> None:
        """A dataset just landed at ``destination``: every other replica
        still holding a retryable row for it gains a relay candidate."""
        for dst in self.policy.replicas:
            if dst == destination:
                continue
            rec = self.table.peek(dataset, dst)
            if rec is None or rec.status not in _RETRYABLE_SET:
                continue
            donor = self._first_donor(dataset, dst)
            if donor is not None:
                self._relay_add(dst, dataset, donor)

    def _first_donor(self, dataset: str, dst: str) -> Optional[str]:
        """The donor Figure 4's relay scan would pick: the first replica in
        priority order (≠ dst) that already holds the dataset."""
        for r in self.policy.replicas:
            if r != dst and dataset in self.table.succeeded_set(r):
                return r
        return None

    def _relay_add(self, dst: str, dataset: str, donor: str) -> None:
        tracked = self._relay_donor.setdefault(dst, {})
        if tracked.get(dataset) == donor:
            return
        tracked[dataset] = donor
        heapq.heappush(self._relay.setdefault((dst, donor), []), dataset)

    # ----------------------------------------------------------------- 2b poll
    def _poll(self, now: float, actions: List[str]) -> None:
        updates: List[Tuple[str, str, dict]] = []
        for rec in self.table.by_status(Status.ACTIVE, Status.QUEUED, Status.PAUSED):
            st = self.transport.poll(rec.uuid)
            upd = dict(bytes_transferred=st.bytes_done, files=st.files_done,
                       directories=st.dirs_done, faults=st.faults, rate=st.rate)
            if st.status == Status.SUCCEEDED:
                upd.update(status=Status.SUCCEEDED, completed=now)
                actions.append(f"SUCCEEDED {rec.source}->{rec.destination} {rec.dataset}")
            elif st.status == Status.FAILED:
                retries, quarantine = retry_disposition(
                    rec.retries, self.retry.max_retries)
                if quarantine:
                    upd.update(status=Status.QUARANTINED, retries=retries)
                    # release any transport-side residue of the quarantined
                    # transfer (no-op for transports whose FAILED is terminal)
                    self.transport.cancel(rec.uuid)
                    self.notifier.notify(
                        f"transfer {rec.dataset} -> {rec.destination} exceeded "
                        f"{self.retry.max_retries} retries ({st.detail})",
                        rec.dataset)
                    actions.append(f"QUARANTINED {rec.dataset} -> {rec.destination}")
                else:
                    upd.update(status=Status.FAILED, retries=retries)
                    self._set_backoff((rec.dataset, rec.destination),
                                      now + self.retry.backoff_s)
                    actions.append(f"FAILED (retry {retries}) {rec.dataset} "
                                   f"-> {rec.destination}: {st.detail}")
            else:
                upd.update(status=st.status)
            updates.append((rec.dataset, rec.destination, upd))
        # one transaction for the whole poll pass, not one commit per live row;
        # the table listener (_on_row) re-queues failures and registers relay
        # candidates for completions
        self.table.update_many(updates)

    # ------------------------------------------------------------ route starts
    def _slots(self, src: str, dst: str) -> int:
        used = self.table.count_route(src, dst, *OCCUPYING)
        return max(0, self.policy.cap(src, dst) - used)

    def _readmit_quarantined(self, dst: str) -> List[str]:
        """Paper §5: quarantined transfers are re-admitted once the human has
        fixed the underlying problem (permissions, fs config).  One batched
        transaction instead of one commit per re-admitted row.  Returns the
        re-admitted datasets in dataset order; the listener's queue pushes
        are deferred, because this pass must consider them *after* its
        ordinary eligible rows (the caller re-queues whatever it does not
        start)."""
        updates = [(r.dataset, r.destination, dict(status=Status.FAILED,
                                                   retries=0))
                   for r in self.table.by_status(Status.QUARANTINED,
                                                 destination=dst)
                   if self.notifier.is_fixed(r.dataset)]
        if not updates:
            return []
        self._defer_queue = tail = []
        try:
            self.table.update_many(updates)
        finally:
            self._defer_queue = None
        return tail

    def _backoff_active(self, key: Tuple[str, str], now: float) -> bool:
        """True while the row is still waiting out a retry backoff; prunes
        the entry once it has expired."""
        t = self._backoff_until.get(key, 0.0)
        if t > now:
            return True
        if t:
            del self._backoff_until[key]
        return False

    def _set_backoff(self, key: Tuple[str, str], until: float) -> None:
        self._backoff_until[key] = until
        heapq.heappush(self._backoff_heap, (until, key))

    def _start(self, rec: TransferRecord, src: str, now: float,
               actions: List[str]) -> None:
        ds = self.catalog[rec.dataset]
        uid = self.transport.submit(ds, src, rec.destination)
        self.table.update(rec.dataset, rec.destination, source=src, uuid=uid,
                          requested=now, status=Status.ACTIVE)
        actions.append(f"START {src}->{rec.destination} {rec.dataset}")

    def _start_route(self, src: str, dst: str, now: float,
                     actions: List[str]) -> None:
        slots = self._slots(src, dst)
        if slots <= 0:
            return
        heap = self._direct.get(dst)
        if heap:
            member = self._direct_member[dst]
            deferred: List[_DirectEntry] = []
            while heap and slots > 0:
                entry = heapq.heappop(heap)
                ds = _entry_ds(entry)
                rec = self.table.peek(ds, dst)
                if (rec is None or rec.status not in _RETRYABLE_SET
                        or rec.source != src):
                    member.discard(ds)             # stale entry
                    continue
                if self._backoff_active((ds, dst), now):
                    deferred.append(entry)         # still backing off
                    continue
                member.discard(ds)
                self._start(rec, src, now, actions)
                slots -= 1
            for entry in deferred:
                heapq.heappush(heap, entry)
            if not heap:
                # fully drained: drop the key so dispatch passes (and
                # ``reprioritize``) stop iterating dead destinations —
                # ``_queue_row`` recreates it on the next retryable row
                del self._direct[dst]
                self._direct_member.pop(dst, None)
        # freshly re-admitted quarantined rows come after the ordinary
        # eligibles, exactly where Figure 4's scan would see them
        for ds in self._readmit_quarantined(dst):
            rec = self.table.peek(ds, dst)
            if rec is None or rec.status not in _RETRYABLE_SET:
                continue
            if (slots > 0 and rec.source == src
                    and not self._backoff_active((ds, dst), now)):
                self._start(rec, src, now, actions)
                slots -= 1
            else:
                self._queue_row(rec)               # for later passes

    # -------------------------------------------------------------- 2d/2e relay
    def _start_relays(self, now: float, actions: List[str]) -> None:
        pol = self.policy
        for dst in pol.replicas:
            tracked = self._relay_donor.get(dst)
            if tracked:
                for donor in pol.replicas:
                    if donor == dst:
                        continue
                    heap = self._relay.get((dst, donor))
                    if not heap:
                        continue
                    slots = self._slots(donor, dst)
                    deferred: List[str] = []
                    while heap and slots > 0:
                        ds = heapq.heappop(heap)
                        if tracked.get(ds) != donor:
                            continue                # migrated or dropped
                        rec = self.table.peek(ds, dst)
                        if rec is None or rec.status not in _RETRYABLE_SET:
                            del tracked[ds]         # stale entry
                            continue
                        best = self._first_donor(ds, dst)
                        if best != donor:           # an earlier-priority
                            del tracked[ds]         # replica now holds it
                            if best is not None:
                                self._relay_add(dst, ds, best)
                            continue
                        if self._backoff_active((ds, dst), now):
                            deferred.append(ds)
                            continue
                        del tracked[ds]
                        self._start(rec, donor, now, actions)
                        slots -= 1
                    for ds in deferred:
                        heapq.heappush(heap, ds)
                    if not heap:
                        # drained relay bucket: drop the (dst, donor) key —
                        # ``_relay_add`` recreates it on the next candidate
                        del self._relay[(dst, donor)]
                if not tracked:
                    del self._relay_donor[dst]
            # freshly re-admitted rows are scanned after the ordinary
            # eligibles (Figure 4 ordering; see _start_route)
            for ds in self._readmit_quarantined(dst):
                rec = self.table.peek(ds, dst)
                if rec is None or rec.status not in _RETRYABLE_SET:
                    continue
                donor = self._first_donor(ds, dst)
                if (donor is not None and self._slots(donor, dst) > 0
                        and not self._backoff_active((ds, dst), now)):
                    self._start(rec, donor, now, actions)
                else:
                    self._queue_row(rec)            # for later passes

    # ---------------------------------------------------------------- helpers
    def _any_paused(self, dst: str) -> bool:
        return self.table.count_status(Status.PAUSED) > 0 and len(
            self.table.by_status(Status.PAUSED, destination=dst)) > 0

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        """JSON-serializable copy of the mutable scheduling state: retry
        backoffs (their heap order included), the per-destination direct
        queues, and the relay-candidate queues with their donor tracking.
        Restoring this verbatim — rather than re-deriving queues from the
        table — preserves heap entry order and lazy-stale entries, so a
        resumed campaign pops datasets in exactly the order the killed run
        would have."""
        assert self._defer_queue is None, "snapshot during re-admission pass"
        return {
            "backoff_until": [[ds, dst, t]
                              for (ds, dst), t in self._backoff_until.items()],
            "backoff_heap": [[t, ds, dst]
                             for t, (ds, dst) in self._backoff_heap],
            "direct": {dst: [e if isinstance(e, str) else list(e) for e in h]
                       for dst, h in self._direct.items()},
            "direct_member": {dst: sorted(m)
                              for dst, m in self._direct_member.items()},
            "relay": [[dst, donor, list(h)]
                      for (dst, donor), h in self._relay.items()],
            "relay_donor": {dst: dict(m)
                            for dst, m in self._relay_donor.items()},
        }

    def load_state_dict(self, d: dict) -> None:
        """Overwrite the queue state (normally right after construction over a
        restored table, replacing the constructor's adoption-derived queues
        with the exact serialized ones)."""
        self._backoff_until = {(ds, dst): t for ds, dst, t in d["backoff_until"]}
        self._backoff_heap = [(t, (ds, dst)) for t, ds, dst in d["backoff_heap"]]
        self._direct = {
            dst: [e if isinstance(e, str) else (int(e[0]), e[1]) for e in h]
            for dst, h in d["direct"].items()}
        self._direct_member = {dst: set(m)
                               for dst, m in d["direct_member"].items()}
        self._relay = {(dst, donor): list(h) for dst, donor, h in d["relay"]}
        self._relay_donor = {dst: dict(m)
                             for dst, m in d["relay_donor"].items()}

    # ------------------------------------------------------- next-event hints
    def next_backoff_expiry(self, now: float) -> float:
        """Earliest future retry-backoff expiry (event-driven simulation
        hint); ``inf`` when no failed transfer is waiting out a backoff.
        Expired and superseded heap entries are pruned on the way out."""
        heap = self._backoff_heap
        while heap:
            t, key = heap[0]
            current = self._backoff_until.get(key)
            if current != t:                        # superseded entry
                heapq.heappop(heap)
                continue
            if t <= now:                            # expired: prune
                heapq.heappop(heap)
                del self._backoff_until[key]
                continue
            return t
        return float("inf")

    # ------------------------------------------------------- observability
    def backoff_depth(self) -> int:
        """Failed transfers currently waiting out a retry backoff (read-only
        O(1) — the flight recorder samples this every metrics interval)."""
        return len(self._backoff_until)

    def queue_depth(self) -> int:
        """Datasets still queued for direct dispatch across destinations
        (read-only; the flight recorder samples this on cadence)."""
        return sum(len(h) for h in self._direct.values())
