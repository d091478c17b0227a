"""Dataset staging: the paper's replication machinery as the training-data
path.

A 1000-node job stages dataset shards from the persistent store (= LLNL, the
slow source) to pod-local staging areas (= ALCF/OLCF).  The Figure-4 scheduler
moves them: the store is read once, pods relay among themselves, transfers
overlap training, and pod maintenance re-routes instead of stalling the job.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.faults import Notifier, RetryPolicy
from repro_torch.core.routes import Dataset
from repro_torch.core.scheduler import ReplicationPolicy, ReplicationScheduler
from repro_torch.core.transfer_table import Status, TransferTable
from repro_torch.core.transport import LocalFSTransport
from repro_torch.kernels.device import Device


@dataclass
class StagingArea:
    """Replicates dataset directories from ``store`` to each pod's area;
    every file is checksummed on ``device`` (default ``"cuda"``, which
    raises when CUDA is not available)."""
    root: str                       # parent of site dirs
    store: str = "STORE"
    pods: tuple = ("POD0", "POD1")
    device: Device = "cuda"

    def __post_init__(self):
        self.transport = LocalFSTransport(self.root, device=self.device)
        self.table = TransferTable()
        self.notifier = Notifier()
        self.catalog: Dict[str, Dataset] = {}
        self.scheduler = ReplicationScheduler(
            self.table, self.transport, self.catalog,
            ReplicationPolicy(self.store, self.pods),
            RetryPolicy(max_retries=3, backoff_s=0.0), self.notifier)
        for site in (self.store, *self.pods):
            os.makedirs(os.path.join(self.root, site), exist_ok=True)

    # ------------------------------------------------------------------ api
    def register(self, rel_path: str) -> None:
        """Register a dataset directory (already present under the store)."""
        base = os.path.join(self.root, self.store, rel_path.lstrip("/"))
        nbytes = nfiles = ndirs = 0
        for dirpath, _, files in os.walk(base):
            ndirs += 1
            for fn in files:
                nfiles += 1
                nbytes += os.path.getsize(os.path.join(dirpath, fn))
        ds = Dataset(rel_path, nbytes, nfiles, ndirs)
        self.catalog[rel_path] = ds
        self.table.populate([rel_path], self.store, list(self.pods))

    def run_until_staged(self, max_steps: int = 10_000) -> int:
        """Drive the scheduler to completion (LocalFSTransport is immediate,
        so each step completes submissions).  Returns steps used."""
        now = 0.0
        for i in range(max_steps):
            self.scheduler.step(now)
            now += 1.0
            if self.scheduler.done():
                return i + 1
        raise RuntimeError("staging did not converge")

    def pod_path(self, pod: str, rel_path: str) -> str:
        return os.path.join(self.root, pod, rel_path.lstrip("/"))

    def staged_ok(self, rel_path: str) -> bool:
        return all(
            (self.table.get(rel_path, pod) or None) is not None
            and self.table.get(rel_path, pod).status == Status.SUCCEEDED
            for pod in self.pods)
