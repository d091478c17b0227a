"""The transfer table — paper Table 1, backed by a real database (sqlite3).

One row per (dataset, source→destination) transfer.  The scheduler
(`core.scheduler`) is a pure state machine over this table, exactly as the
paper's replication tool tracked its 2×2291 transfers.

sqlite stays the durable store, but every query is answered from an
in-memory row cache with status/route indexes, so the scheduler's per-step
cost is proportional to the rows *matched* (live transfers), not to the
catalog.  All mutations go through this class; they update the cache
immediately, while the sqlite write for the hot-path ``update_many`` is
*write-behind*: dirty keys are coalesced and flushed as full-row
INSERT OR REPLACE before any durable copy (``dump``), connection close, or
direct database read (``_select_db``) — the only points where sqlite
contents are observable.  Because the cache mirrors the database row-for-row
between flushes, replaying only each dirty row's *final* state reproduces
exactly the database the per-update writes would have built.  Registered
listeners observe every row transition, which lets the scheduler maintain
its own incremental state (pending queues, relay donor sets) without
re-scanning the table.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import sqlite3
import threading
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)


class Status(str, enum.Enum):
    NULL = "NULL"            # not yet requested
    QUEUED = "QUEUED"        # submitted, not yet started by transport
    ACTIVE = "ACTIVE"
    PAUSED = "PAUSED"        # collection manager paused the endpoint
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"        # transient — eligible for retry
    QUARANTINED = "QUARANTINED"  # persistent failure, human notified (paper §5)


TERMINAL = (Status.SUCCEEDED, Status.QUARANTINED)
RETRYABLE = (Status.NULL, Status.FAILED)
OUTSTANDING = (Status.NULL, Status.QUEUED, Status.ACTIVE, Status.PAUSED,
               Status.FAILED)


@dataclass
class TransferRecord:
    """Schema of paper Table 1 (+ retry bookkeeping)."""
    dataset: str                      # directory path to be transferred
    source: str                       # e.g. LLNL / ALCF / OLCF
    destination: str
    uuid: Optional[str] = None        # transport transfer identifier
    requested: Optional[float] = None
    completed: Optional[float] = None
    status: Status = Status.NULL
    directories: int = 0
    files: int = 0
    rate: float = 0.0                 # bytes/s
    faults: int = 0
    bytes_transferred: int = 0
    retries: int = 0

    @property
    def route(self) -> Tuple[str, str]:
        return (self.source, self.destination)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS transfer (
  dataset TEXT NOT NULL,
  source TEXT NOT NULL,
  destination TEXT NOT NULL,
  uuid TEXT,
  requested REAL,
  completed REAL,
  status TEXT NOT NULL DEFAULT 'NULL',
  directories INTEGER NOT NULL DEFAULT 0,
  files INTEGER NOT NULL DEFAULT 0,
  rate REAL NOT NULL DEFAULT 0,
  faults INTEGER NOT NULL DEFAULT 0,
  bytes_transferred INTEGER NOT NULL DEFAULT 0,
  retries INTEGER NOT NULL DEFAULT 0,
  PRIMARY KEY (dataset, destination)
);
CREATE INDEX IF NOT EXISTS idx_status ON transfer (status);
CREATE INDEX IF NOT EXISTS idx_route ON transfer (source, destination, status);
"""

_FIELDS = [f.name for f in dataclasses.fields(TransferRecord)]

Key = Tuple[str, str]                         # (dataset, destination)
# listener(record, old_status, old_source); old_status None == new row
Listener = Callable[[TransferRecord, Optional[Status], Optional[str]], None]


class TransferTable:
    """sqlite3-backed transfer table with a write-through row cache.

    Note the primary key is (dataset, destination): the *source* of a row may
    be rewritten by the scheduler when it re-routes (e.g. LLNL→OLCF relay
    becomes ALCF→OLCF once the dataset lands at ALCF) — exactly the
    flexibility the paper calls out as important.
    """

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._rows: Dict[Key, TransferRecord] = {}
        self._by_status: Dict[Status, Set[Key]] = {s: set() for s in Status}
        self._route_counts: Dict[Tuple[str, str, Status], int] = {}
        self._succeeded: Dict[str, Set[str]] = {}   # destination -> datasets
        self._bytes_ok: Dict[str, int] = {}         # destination -> bytes
        self._listeners: List[Listener] = []
        # keys whose cached row is newer than its sqlite row; flushed (sorted,
        # one executemany) before dump/close/_select_db
        self._dirty: Set[Key] = set()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()
            self._rebuild_cache()                   # resume from a disk store

    def close(self) -> None:
        """Release the sqlite connection (a disk-backed table's file is then
        safe to reopen or copy; pending write-behind rows are flushed
        first)."""
        with self._lock:
            self._flush_locked()
            self._conn.close()

    # --------------------------------------------------------- durable copies
    def dump(self, path: str) -> None:
        """Write a consistent copy of the whole database to ``path``
        atomically (temp file + rename): readers either see the previous
        complete table or the new one, never a torn write.  Campaign
        checkpoints call this once per snapshot."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp"
        with self._lock:
            self._flush_locked()
            dst = sqlite3.connect(tmp)
            try:
                self._conn.backup(dst)
                dst.commit()
            finally:
                dst.close()
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "TransferTable":
        """An in-memory table initialized from a copy of the sqlite file at
        ``path``.  The file itself is left untouched, so a checkpoint can be
        resumed any number of times; cache/index/counter state is rebuilt
        from the copied rows."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        table = cls()
        src = sqlite3.connect(path)
        try:
            with table._lock:
                src.backup(table._conn)
                table._rebuild_cache()
        finally:
            src.close()
        return table

    def add_listener(self, fn: Listener) -> None:
        """Observe every row mutation: ``fn(record, old_status, old_source)``
        is called after the cache/database update (``old_status is None`` for
        newly inserted rows).  The record passed is the live cached row —
        treat it as read-only."""
        self._listeners.append(fn)

    # ------------------------------------------------------------------ CRUD
    def populate(self, datasets: Iterable[str], source: str,
                 destinations: Sequence[str]) -> int:
        """Step 1 of Figure 4: two rows per path, status NULL."""
        n = 0
        fresh: List[TransferRecord] = []
        with self._lock:
            for ds in datasets:
                for dst in destinations:
                    n += 1
                    if (ds, dst) in self._rows:     # INSERT OR IGNORE
                        continue
                    self._conn.execute(
                        "INSERT OR IGNORE INTO transfer "
                        "(dataset, source, destination, status) VALUES (?,?,?,?)",
                        (ds, source, dst, Status.NULL.value))
                    rec = TransferRecord(ds, source, dst)
                    self._index_insert(rec)
                    fresh.append(rec)
            self._conn.commit()
        for rec in fresh:
            self._notify(rec, None, None)
        return n

    def upsert(self, rec: TransferRecord) -> None:
        key = (rec.dataset, rec.destination)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO transfer "
                f"({','.join(_FIELDS)}) VALUES ({','.join('?' * len(_FIELDS))})",
                self._row(rec))
            self._conn.commit()
            old = self._rows.get(key)
            old_status = old.status if old else None
            old_source = old.source if old else None
            if old is not None:
                self._index_remove(old)
            rec = dataclasses.replace(rec)
            self._index_insert(rec)
        self._notify(rec, old_status, old_source)

    def update(self, dataset: str, destination: str, **kw) -> None:
        self.update_many([(dataset, destination, kw)])

    def update_many(
            self, updates: Sequence[Tuple[str, str, dict]]) -> None:
        """Apply many ``(dataset, destination, columns)`` updates to the
        cache, deferring the sqlite writes: each touched key is marked dirty
        and its *final* row is flushed (one INSERT OR REPLACE executemany, in
        sorted key order) the next time the database itself must be current
        — a durable ``dump``, ``close``, or ``_select_db``.  An update whose
        key matches no row is a no-op in cache and database alike, exactly
        as the former per-update SQL was."""
        if not updates:
            return
        events: List[Tuple[TransferRecord, Optional[Status], Optional[str]]] = []
        with self._lock:
            for dataset, destination, kw in updates:
                rec = self._rows.get((dataset, destination))
                if rec is None:
                    continue                         # UPDATE matches no row
                old_status, old_source = rec.status, rec.source
                self._index_remove(rec)
                for k, v in kw.items():
                    setattr(rec, k,
                            v if k != "status" or isinstance(v, Status)
                            else Status(v))
                self._index_insert(rec)
                self._dirty.add((dataset, destination))
                events.append((rec, old_status, old_source))
        for rec, old_status, old_source in events:
            self._notify(rec, old_status, old_source)

    # ---------------------------------------------------------------- queries
    @staticmethod
    def _copy(rec: TransferRecord) -> TransferRecord:
        """Shallow field copy, several times faster than
        ``dataclasses.replace`` (which re-runs the generated ``__init__``).
        Equivalent because ``TransferRecord`` has no ``__post_init__``."""
        new = TransferRecord.__new__(TransferRecord)
        new.__dict__.update(rec.__dict__)
        return new

    def get(self, dataset: str, destination: str) -> Optional[TransferRecord]:
        with self._lock:
            rec = self._rows.get((dataset, destination))
            return self._copy(rec) if rec is not None else None

    def peek(self, dataset: str, destination: str) -> Optional[TransferRecord]:
        """The live cached row (no copy) — read-only, O(1).  The scheduler's
        hot path uses this instead of ``get`` to avoid per-step allocation."""
        return self._rows.get((dataset, destination))

    def by_status(self, *statuses: Status, destination: Optional[str] = None,
                  source: Optional[str] = None, limit: int = 0
                  ) -> List[TransferRecord]:
        """Matching rows in dataset order.  Served from the status index:
        cost is O(matched · log matched), independent of table size."""
        with self._lock:
            keys: List[Key] = []
            for s in statuses:
                bucket = self._by_status.get(s, ())
                if destination is not None:
                    keys.extend(k for k in bucket if k[1] == destination)
                else:
                    keys.extend(bucket)
            keys.sort()
            out = []
            for k in keys:
                rec = self._rows[k]
                if source is not None and rec.source != source:
                    continue
                out.append(self._copy(rec))
                if limit and len(out) >= limit:
                    break
            return out

    def count_route(self, source: str, destination: str, *statuses: Status) -> int:
        with self._lock:
            return sum(self._route_counts.get((source, destination, s), 0)
                       for s in statuses)

    def count_status(self, *statuses: Status) -> int:
        with self._lock:
            return sum(len(self._by_status.get(s, ())) for s in statuses)

    def status_counts(self) -> Dict[str, int]:
        """Row count per status, keyed by status value in enum order —
        served from the status index (O(#statuses), the flight recorder
        samples this every metrics interval)."""
        with self._lock:
            return {s.value: len(self._by_status.get(s, ()))
                    for s in Status}

    def succeeded_datasets(self, destination: str) -> List[str]:
        with self._lock:
            return list(self._succeeded.get(destination, ()))

    def succeeded_set(self, destination: str) -> Set[str]:
        """Live set of datasets SUCCEEDED at ``destination`` (read-only view,
        O(1)); the scheduler's relay planner keys off this."""
        return self._succeeded.setdefault(destination, set())

    def bytes_at(self, destination: str) -> int:
        """Total bytes_transferred over SUCCEEDED rows at ``destination``,
        maintained incrementally (O(1) — the per-day timeline snapshot and
        dashboards poll this every iteration)."""
        with self._lock:
            return self._bytes_ok.get(destination, 0)

    def all(self) -> List[TransferRecord]:
        with self._lock:
            return [self._copy(self._rows[k])
                    for k in sorted(self._rows)]

    def done(self) -> bool:
        """Figure 4 step 2f: terminate when nothing is outstanding.  O(1)."""
        with self._lock:
            return all(not self._by_status[s] for s in OUTSTANDING)

    # ------------------------------------------------------ cache maintenance
    def _rebuild_cache(self) -> None:
        """Repopulate the row cache and every derived index/counter from the
        database (lock held).  Used at construction — including cold-opening
        a populated disk store — and after ``load`` replaces the db."""
        self._dirty.clear()     # the database is the authority here
        self._rows.clear()
        self._by_status = {s: set() for s in Status}
        self._route_counts.clear()
        self._succeeded.clear()
        self._bytes_ok.clear()
        for rec in self._select_db("", ()):
            self._index_insert(rec)

    def _index_insert(self, rec: TransferRecord) -> None:
        key = (rec.dataset, rec.destination)
        self._rows[key] = rec
        self._by_status[rec.status].add(key)
        rkey = (rec.source, rec.destination, rec.status)
        self._route_counts[rkey] = self._route_counts.get(rkey, 0) + 1
        if rec.status == Status.SUCCEEDED:
            self._succeeded.setdefault(rec.destination, set()).add(rec.dataset)
            self._bytes_ok[rec.destination] = (
                self._bytes_ok.get(rec.destination, 0) + rec.bytes_transferred)

    def _index_remove(self, rec: TransferRecord) -> None:
        key = (rec.dataset, rec.destination)
        self._by_status[rec.status].discard(key)
        rkey = (rec.source, rec.destination, rec.status)
        n = self._route_counts.get(rkey, 0) - 1
        if n > 0:
            self._route_counts[rkey] = n
        else:
            self._route_counts.pop(rkey, None)
        if rec.status == Status.SUCCEEDED:
            self._succeeded.get(rec.destination, set()).discard(rec.dataset)
            self._bytes_ok[rec.destination] = (
                self._bytes_ok.get(rec.destination, 0) - rec.bytes_transferred)

    def _notify(self, rec: TransferRecord, old_status: Optional[Status],
                old_source: Optional[str]) -> None:
        for fn in self._listeners:
            fn(rec, old_status, old_source)

    # ---------------------------------------------------------------- helpers
    def _flush_locked(self) -> None:
        """Write every dirty cached row to sqlite (caller holds the lock, or
        is single-threaded): one INSERT OR REPLACE executemany in sorted key
        order, one commit.  Restores the cache == database invariant."""
        if not self._dirty:
            return
        rows = [self._row(self._rows[k])
                for k in sorted(self._dirty) if k in self._rows]
        self._dirty.clear()
        if rows:
            self._conn.executemany(
                "INSERT OR REPLACE INTO transfer "
                f"({','.join(_FIELDS)}) VALUES ({','.join('?' * len(_FIELDS))})",
                rows)
            self._conn.commit()

    def _select_db(self, where: str, args: tuple) -> List[TransferRecord]:
        """Read rows straight from sqlite (cache bootstrap + consistency
        tests).  Flushes pending write-behind rows first, so the database
        read is always current."""
        self._flush_locked()
        cur = self._conn.execute(
            f"SELECT {','.join(_FIELDS)} FROM transfer {where}", args)
        rows = cur.fetchall()
        out = []
        for r in rows:
            d = dict(zip(_FIELDS, r))
            d["status"] = Status(d["status"])
            out.append(TransferRecord(**d))
        return out

    @staticmethod
    def _row(rec: TransferRecord) -> tuple:
        vals = []
        for f in _FIELDS:
            v = getattr(rec, f)
            vals.append(v.value if isinstance(v, Status) else v)
        return tuple(vals)
