"""Cross-site checkpoint replication — the paper's scheduler guarding training
state.

After each checkpoint commit, the directory is registered as a *dataset* with
the Figure-4 scheduler and replicated to every replica site (pods / regions /
cold store) over ``LocalFSTransport`` with checksum verification.  A pod loss
then never costs more than the steps since the last commit: restart verifies
the local manifest, and if the local copy is corrupt or gone, restores from
the nearest replica (relay order, slow store last — C2 applied to recovery).

Every byte copied, re-read or verified is hashed on ``device`` (default
``"cuda"``: the integrity-hash kernel).
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.core.faults import Notifier, RetryPolicy
from repro_torch.core.routes import Dataset
from repro_torch.core.scheduler import ReplicationPolicy, ReplicationScheduler
from repro_torch.core.transfer_table import Status, TransferTable
from repro_torch.core.transport import LocalFSTransport
from repro_torch.kernels.device import Device


@dataclass
class CheckpointReplicator:
    root: str                           # parent of site dirs
    primary: str = "POD0"               # where training writes checkpoints
    replicas: tuple = ("POD1", "STORE")
    device: Device = "cuda"

    def __post_init__(self):
        self.transport = LocalFSTransport(self.root, device=self.device)
        self.table = TransferTable()
        self.notifier = Notifier()
        self.catalog: Dict[str, Dataset] = {}
        self.scheduler = ReplicationScheduler(
            self.table, self.transport, self.catalog,
            ReplicationPolicy(self.primary, self.replicas),
            RetryPolicy(max_retries=3, backoff_s=0.0), self.notifier)
        for site in (self.primary, *self.replicas):
            os.makedirs(os.path.join(self.root, site), exist_ok=True)

    def site_dir(self, site: str) -> str:
        return os.path.join(self.root, site)

    # ------------------------------------------------------------------- api
    def replicate(self, ckpt_rel: str, max_steps: int = 1000) -> bool:
        """Replicate ``<primary>/<ckpt_rel>`` to all replicas; True if all
        copies verified."""
        base = os.path.join(self.site_dir(self.primary), ckpt_rel.lstrip("/"))
        nbytes = nfiles = ndirs = 0
        for dirpath, _, files in os.walk(base):
            ndirs += 1
            for fn in files:
                nfiles += 1
                nbytes += os.path.getsize(os.path.join(dirpath, fn))
        self.catalog[ckpt_rel] = Dataset(ckpt_rel, nbytes, nfiles, ndirs)
        self.table.populate([ckpt_rel], self.primary, list(self.replicas))
        now = 0.0
        for _ in range(max_steps):
            self.scheduler.step(now)
            now += 1.0
            if all((self.table.get(ckpt_rel, r) or None) is not None
                   and self.table.get(ckpt_rel, r).status
                   in (Status.SUCCEEDED, Status.QUARANTINED)
                   for r in self.replicas):
                break
        return all(self.table.get(ckpt_rel, r).status == Status.SUCCEEDED
                   for r in self.replicas)

    def restore_anywhere(self, ckpt_rel: str, example_tree,
                         step: Optional[int] = None):
        """Restore from the primary if its copy verifies, else walk replicas
        in relay-priority order (fast pods first, slow store last)."""
        for site in (self.primary, *self.replicas):
            root = os.path.join(self.site_dir(site), ckpt_rel.lstrip("/"))
            if not os.path.isdir(root):
                continue
            got = restore_checkpoint(root, example_tree, step=step,
                                     device=self.device)
            if got is not None:
                return got + (site,)
        return None
