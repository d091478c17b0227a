"""Integrity checking: per-file checksums and transfer manifests (paper C3).

Globus computes and compares checksums at source and destination for every
file, retransmitting corrupted ones.  We implement the same contract with a
streaming hash whose reference lives in ``repro_torch.kernels.checksum.ref``
(numpy and plain PyTorch, exact uint32 arithmetic) and whose production
implementation is the CUDA kernel behind
``repro_torch.kernels.checksum.checksum`` (held bit-exact to the plain
version on the card).

``StreamingChecksum`` feeds the hash chunk by chunk: because the fold is an
XOR-reduction of position-mixed words, partial folds over consecutive chunks
combine exactly to the whole-buffer hash, so transports and manifest scans
never need to hold a file in memory.  The running fold lives in a
one-element accumulator on the device; only ``digest()`` reads it back.

Every entry point that touches bytes takes ``device`` (default ``"cuda"``,
which raises when CUDA is not available); ``device="cpu"`` runs the plain
PyTorch version.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.kernels.checksum.ops import (accumulator_value,
                                              checksum_bytes, fold_words,
                                              new_accumulator, words_tensor)
from repro_torch.kernels.checksum.ref import finalize32_np
from repro_torch.kernels.device import Device, require_device

_SCAN_CHUNK = 4 * 1024 * 1024


def file_checksum(data: bytes, device: Device = "cuda") -> int:
    return checksum_bytes(data, device)


class StreamingChecksum:
    """Incremental ``checksum_bytes_np``: ``update()`` chunks in any split,
    then ``digest()`` — bit-identical to hashing the concatenation whole.
    Chunks need not be word-aligned; a ≤3-byte tail is carried on the host
    between updates and only the final partial word is zero-padded.
    ``update()`` sends whole words to ``device`` and folds them there
    without synchronising; ``digest()`` is the one read-back."""

    def __init__(self, device: Device = "cuda"):
        self.device = require_device(device)
        self._acc = new_accumulator(self.device)
        self._nwords = 0
        self._nbytes = 0
        self._tail = b""

    def update(self, chunk: bytes) -> "StreamingChecksum":
        self._nbytes += len(chunk)
        data = self._tail + chunk
        nwords = len(data) // 4
        if nwords:
            fold_words(words_tensor(data, nwords, self.device), self._nwords,
                       self._acc)
            self._nwords += nwords
        self._tail = data[nwords * 4:]
        return self

    def digest(self) -> int:
        acc = self._acc
        if self._tail:
            pad = self._tail + b"\0" * (-len(self._tail) % 4)
            acc = fold_words(words_tensor(pad, 1, self.device), self._nwords,
                             acc.clone())
        return finalize32_np(accumulator_value(acc), self._nbytes)


def stream_file_checksum(path: str, device: Device = "cuda") -> Tuple[int, int]:
    """(size, checksum) of a file, streamed in fixed-size chunks."""
    s = StreamingChecksum(device)
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_SCAN_CHUNK)
            if not chunk:
                break
            size += len(chunk)
            s.update(chunk)
    return size, s.digest()


@dataclass
class Manifest:
    """Checksums + sizes for a dataset (or checkpoint) directory tree."""
    entries: Dict[str, Tuple[int, int]] = field(default_factory=dict)  # path -> (size, csum)

    @classmethod
    def scan(cls, root: str, device: Device = "cuda") -> "Manifest":
        m = cls()
        for dirpath, _, files in os.walk(root):
            for fn in sorted(files):
                p = os.path.join(dirpath, fn)
                rel = os.path.relpath(p, root)
                m.entries[rel] = stream_file_checksum(p, device)
        return m

    def verify_many(self, root: str,
                    rels: Optional[Iterable[str]] = None,
                    device: Device = "cuda") -> Dict[str, dict]:
        """Batched (partial-scrub) verification: check ``rels`` — any subset
        of the manifest's entries, default all — and report BOTH the size and
        checksum status of every file checked, even when the size already
        mismatches.  Returns ``{relpath: {"ok", "size_ok", "checksum_ok",
        "problem"}}``; scrub engines call this with one batch of files per
        pass instead of walking the whole manifest serially."""
        report: Dict[str, dict] = {}
        for rel in (self.entries if rels is None else rels):
            size, csum = self.entries[rel]
            p = os.path.join(root, rel)
            if not os.path.exists(p):
                report[rel] = {"ok": False, "size_ok": False,
                               "checksum_ok": False, "problem": "missing"}
                continue
            got_size, got_csum = stream_file_checksum(p, device)
            size_ok = got_size == size
            csum_ok = got_csum == csum
            problems = []
            if not size_ok:
                problems.append(f"size {got_size} != {size}")
            if not csum_ok:
                problems.append("checksum mismatch")
            report[rel] = {"ok": size_ok and csum_ok, "size_ok": size_ok,
                           "checksum_ok": csum_ok,
                           "problem": "; ".join(problems)}
        return report

    def verify(self, root: str, device: Device = "cuda") -> Dict[str, str]:
        """Returns {relpath: problem} for every mismatch; empty dict == clean."""
        return {rel: r["problem"]
                for rel, r in self.verify_many(root, device=device).items()
                if not r["ok"]}

    # ------------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({k: list(v) for k, v in self.entries.items()}, f)

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path) as f:
            raw = json.load(f)
        return cls(entries={k: (int(v[0]), int(v[1])) for k, v in raw.items()})

    @property
    def total_bytes(self) -> int:
        return sum(s for s, _ in self.entries.values())
