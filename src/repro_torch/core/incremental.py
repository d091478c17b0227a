"""Incremental replication (paper C7): after the initial campaign, newly
published datasets are detected daily and replicated to all replicas.

``PublishFeed`` abstracts the index node (here: an in-memory/jsonl feed);
``IncrementalReplicator`` polls it, inserts fresh rows into the transfer
table, and lets the Figure-4 scheduler move them.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from repro_torch.core.routes import Dataset
from repro_torch.core.scheduler import ReplicationScheduler
from repro_torch.core.transfer_table import Status


class PublishFeed:
    """Datasets published over (simulated) time."""

    def __init__(self):
        self._events: List[tuple] = []   # (publish_time, Dataset)

    def publish(self, at: float, ds: Dataset) -> None:
        self._events.append((at, ds))

    def new_since(self, t0: float, t1: float) -> List[Dataset]:
        return [d for (t, d) in self._events if t0 < t <= t1]

    def all_events(self) -> List[tuple]:
        """Every ``(publish_time, Dataset)`` ever published."""
        return list(self._events)

    def count(self) -> int:
        """Number of publications so far — an O(1) growth cursor, so pollers
        can notice new events without copying the feed."""
        return len(self._events)

    def events_since(self, cursor: int) -> List[tuple]:
        """Publications appended at or after position ``cursor``."""
        return self._events[cursor:]


@dataclass
class IncrementalReplicator:
    feed: PublishFeed
    scheduler: ReplicationScheduler
    check_interval: float = 86400.0      # daily (paper §3)

    def __post_init__(self):
        self._last_check = 0.0

    def maybe_check(self, now: float) -> List[str]:
        """Call from the daemon loop; enqueues any newly published datasets."""
        if now - self._last_check < self.check_interval:
            return []
        new = self.feed.new_since(self._last_check, now)
        self._last_check = now
        added = []
        pol = self.scheduler.policy
        for ds in new:
            self.scheduler.catalog[ds.path] = ds
            self.scheduler.table.populate([ds.path], pol.source,
                                          list(pol.replicas))
            added.append(ds.path)
        return added
