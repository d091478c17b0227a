"""Demand engine: the consumer half of the replication story.

The paper moved 7.3 PB so that ESGF nodes could *serve* the climate
community; ``repro_torch.demand`` models that community.  A ``RequestWorkload``
generates deterministic, Zipf-skewed, diurnally-modulated user read traffic
against the campaign catalog; a ``ReplicaCatalog`` tracks which datasets are
materialized where (fed by transfer-table row transitions, O(active)); a
per-replica ``ReadCache`` serves hot datasets; and the ``DemandEngine`` ties
them together — user reads contend with replication movers for the same
fair-share site read caps, and the demand policy re-prioritizes the
scheduler's direct-start heaps popular-first so that replication chases the
request distribution instead of catalog order.
"""
from repro_torch.demand.cache import ReadCache
from repro_torch.demand.catalog import ReplicaCatalog
from repro_torch.demand.engine import DemandEngine
from repro_torch.demand.spec import NO_DEMAND, DemandSpec
from repro_torch.demand.workload import RequestWorkload

__all__ = ["DemandEngine", "DemandSpec", "NO_DEMAND", "ReadCache",
           "ReplicaCatalog", "RequestWorkload"]
