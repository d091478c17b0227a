"""Replica catalog: which datasets are materialized at which sites.

In the spirit of Allcock et al.'s replica management layer: the serving tier
asks "where can this dataset be read from?" and the answer must stay current
as replication lands copies.  Rather than re-scanning the transfer table per
request, the catalog subscribes to row transitions — a SUCCEEDED row at a
destination materializes the dataset there — so updates cost O(1) per
transition and lookups are a dict probe.  The source site implicitly holds
everything; replica holdings are a pure function of the table, which is why
this object is never serialized: on resume it is rebuilt by adopting the
restored table's rows (the same pattern ``ReplicationScheduler.__init__``
uses for its queues).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.core.transfer_table import (Status, TransferRecord, TransferTable)


class ReplicaCatalog:
    def __init__(self, table: TransferTable, source: str,
                 replicas: Sequence[str]):
        self.source = source
        self.replicas: Tuple[str, ...] = tuple(replicas)
        self._holders: Dict[str, Set[str]] = {}
        table.add_listener(self._on_row)
        # adopt rows that predate this catalog (checkpoint resume: the
        # restored table already carries the campaign's history)
        for rec in table.all():
            self._on_row(rec, None, None)

    # ------------------------------------------------------------- listener
    def _on_row(self, rec: TransferRecord, old_status: Optional[Status],
                old_source: Optional[str]) -> None:
        if rec.status == Status.SUCCEEDED:
            self._holders.setdefault(rec.dataset, set()).add(rec.destination)
        elif old_status == Status.SUCCEEDED:
            # a replica leaving SUCCEEDED (scrub found it corrupt and flipped
            # it back into the repair path) is unserveable until re-landed:
            # reads fall back to other holders or the source, so the hit rate
            # dips during repair and recovers when the re-transfer lands
            held = self._holders.get(rec.dataset)
            if held is not None:
                held.discard(rec.destination)
                if not held:
                    del self._holders[rec.dataset]

    # -------------------------------------------------------------- queries
    def materialized(self, dataset: str) -> bool:
        """True once at least one replica holds the dataset."""
        return dataset in self._holders

    def holders(self, dataset: str) -> Set[str]:
        return self._holders.get(dataset, set())

    def serving_site(self, dataset: str) -> Optional[str]:
        """The replica a user read is directed to: the first replica in
        priority order that holds the dataset, or None (source read)."""
        held = self._holders.get(dataset)
        if not held:
            return None
        for r in self.replicas:
            if r in held:
                return r
        return None

    def materialized_count(self) -> int:
        return len(self._holders)
