"""File-backed sharded dataset with per-host assignment, prefetch/straggler
handling, and exact resumable iterator state — the at-scale data pipeline.

Layout: a dataset directory holds ``shard-%05d.npy`` token files plus an
``index.json``.  Hosts take shards round-robin by ``host_id`` (on a real
cluster, the process's rank).  Iterator state is the *complete* delivery
state — remaining shard order, epoch, and the leftover token buffer — so
restart resumes with no token skipped or repeated, even if straggler
requeuing reordered shards.  Shard reads run under a deadline: a read that
exceeds it is requeued to the back of the order and logged (host-level
straggler mitigation; the training loop never stalls on one slow disk).

A copy of the JAX package's ``data/sharded.py``, numpy and the standard
library operation for operation.
"""
from __future__ import annotations

import io
import json
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def write_shards(root: str, tokens: np.ndarray, shard_len: int) -> int:
    os.makedirs(root, exist_ok=True)
    n = len(tokens) // shard_len
    names = []
    for i in range(n):
        name = f"shard-{i:05d}.npy"
        np.save(os.path.join(root, name),
                tokens[i * shard_len:(i + 1) * shard_len])
        names.append(name)
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump({"shards": names, "shard_len": shard_len}, f)
    return n


@dataclass
class IterState:
    """Exact delivery state (serializes into the training checkpoint)."""
    pending: List[str] = field(default_factory=list)  # shards left this epoch
    epoch: int = 0
    leftover: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))

    def save(self, path: str) -> None:
        np.savez(path, pending=np.array(self.pending), epoch=self.epoch,
                 leftover=self.leftover)

    @classmethod
    def load(cls, path: str) -> "IterState":
        z = np.load(path, allow_pickle=False)
        return cls(pending=[str(s) for s in z["pending"]],
                   epoch=int(z["epoch"]),
                   leftover=z["leftover"].astype(np.int32))


class ShardedDataset:
    def __init__(self, root: str, host_id: int = 0, n_hosts: int = 1,
                 straggler_deadline_s: float = 30.0):
        with open(os.path.join(root, "index.json")) as f:
            idx = json.load(f)
        self.root = root
        self.all_shards: List[str] = idx["shards"]
        self.shard_len: int = idx["shard_len"]
        self.my_shards = self.all_shards[host_id::n_hosts]
        if not self.my_shards:
            raise ValueError(f"host {host_id}/{n_hosts}: no shards")
        self.deadline = straggler_deadline_s
        self.slow_shards: List[str] = []   # straggler log
        self.load_hook = None              # tests inject delays/failures here

    # ------------------------------------------------------------------ load
    def _load(self, name: str) -> np.ndarray:
        if self.load_hook is not None:
            self.load_hook(name)
        return np.load(os.path.join(self.root, name))

    def _load_with_deadline(self, name: str) -> Optional[np.ndarray]:
        result: queue.Queue = queue.Queue()

        def work():
            try:
                result.put(("ok", self._load(name)))
            except Exception as e:  # noqa: BLE001
                result.put(("err", e))

        th = threading.Thread(target=work, daemon=True)
        th.start()
        try:
            kind, val = result.get(timeout=self.deadline)
        except queue.Empty:
            self.slow_shards.append(name)
            return None
        if kind == "err":
            self.slow_shards.append(name)
            return None
        return val

    # -------------------------------------------------------------- iterate
    def batches(self, batch: int, seq: int, state: Optional[IterState] = None
                ) -> Iterator[Tuple[Dict[str, np.ndarray], IterState]]:
        """Yields (batch_dict, state_after_batch).  Feeding the yielded state
        back into ``batches`` resumes exactly after that batch."""
        st = state if state is not None else IterState(
            pending=list(self.my_shards))
        pending = list(st.pending) or list(self.my_shards)
        epoch = st.epoch
        buf = st.leftover.copy()
        need = batch * (seq + 1)
        while True:
            while len(buf) < need:
                if not pending:
                    pending = list(self.my_shards)
                    epoch += 1
                name = pending.pop(0)
                data = self._load_with_deadline(name)
                if data is None:
                    pending.append(name)   # straggler: requeue at the back
                    continue
                buf = np.concatenate([buf, data.astype(np.int32)])
            used = buf[:need].reshape(batch, seq + 1)
            buf = buf[need:]
            out_state = IterState(pending=list(pending), epoch=epoch,
                                  leftover=buf.copy())
            yield ({"tokens": used[:, :-1].copy(),
                    "labels": used[:, 1:].copy()}, out_state)
