"""Bundle composition: bin-packing a catalog's files/datasets into transfer
tasks under ``max_files``/``max_bytes`` caps.

The paper's replication tool moved 28.9 M files as a few thousand *large*
Globus tasks — never one task per file — because every task carries fixed
dispatch/scan overhead that tiny transfers cannot amortize.  The
``BundleComposer`` reproduces that: it walks the catalog in deterministic
(sorted-path) order and cuts it into **bundles**, synthetic ``Dataset``s the
scheduler treats exactly like ordinary catalog entries (one transfer-table
row per (bundle, destination), relays and retries included).

Two packers sit behind one ``BundlePolicy`` interface:

  * ``GreedyPacker``   — first-fit in catalog order: accumulate items until
    the next one would exceed the current soft targets or hard caps;
  * ``BalancedPacker`` — LPT batches: pull the next window of items (sized
    for ``balance_batch`` bundles), sort by bytes descending, and assign
    each to the lightest open bundle the hard caps allow.

Composition is **lazy**: bundles are cut on demand (the control plane keeps
``lookahead`` bundles ahead of the scheduler), so an online bundle-size
tuner can steer the targets for *future* cuts mid-campaign.  The cursor —
(dataset index, intra-dataset file index) plus the already-cut bundle
definitions — serializes into the campaign snapshot, and re-cutting from a
restored cursor is bit-deterministic: the item stream is a pure function of
the catalog and the scenario seed.

Invariants (pinned by a hypothesis property test): every item lands in
exactly one bundle; no bundle exceeds ``max_files``/``max_bytes`` unless a
single item already does; packing is deterministic for a fixed seed.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.routes import Dataset

BUNDLE_PREFIX = "/bundle/"


@dataclass(frozen=True)
class BundleItem:
    """One packable unit: a whole dataset, or a run of consecutive files of
    one (``<path>#<start>:<end>`` manifest indices).  File items come as
    runs — never one Python object per file — so composing a 29M-file
    catalog costs O(bundles) interpreter work, not O(files)."""
    key: str                  # dataset path, or "<dataset path>#<a>:<b>"
    bytes: int
    files: int
    dirs: float               # fractional for file items; summed per bundle
    unreadable: bool


@dataclass
class BundleCaps:
    """Effective per-bundle limits at cut time: the policy's hard caps
    min'd with the tuner's current soft targets."""
    max_files: int
    max_bytes: int


class BundlePolicy(abc.ABC):
    """A packer: consume items from the composer's cursor, emit bundles."""

    @abc.abstractmethod
    def pack(self, composer: "BundleComposer",
             caps: BundleCaps) -> List[List[BundleItem]]:
        """Cut the next bundle(s) from the cursor; each inner list is one
        bundle's membership, in emission order.  Must consume at least one
        item when any remain."""


class GreedyPacker(BundlePolicy):
    def pack(self, composer, caps):
        items: List[BundleItem] = []
        nbytes = nfiles = 0
        while True:
            it = composer.peek()
            if it is None:
                break
            if items and (nfiles + it.files > caps.max_files
                          or nbytes + it.bytes > caps.max_bytes):
                break
            composer.advance()
            items.append(it)
            nbytes += it.bytes
            nfiles += it.files
        return [items] if items else []


class BalancedPacker(BundlePolicy):
    """Longest-processing-time packing over a bounded item window: spreads
    the heavy tail of the (lognormal) size distribution across bundles so no
    single bundle serializes the route behind one giant task."""

    def __init__(self, batch: int):
        self.batch = max(1, batch)

    def pack(self, composer, caps):
        window: List[BundleItem] = []
        budget = caps.max_bytes * self.batch
        nbytes = 0
        while True:
            it = composer.peek()
            if it is None:
                break
            if window and nbytes + it.bytes > budget:
                break
            composer.advance()
            window.append(it)
            nbytes += it.bytes
        if not window:
            return []
        # LPT: largest first into the lightest bundle the caps allow;
        # ties break on window order (stable sort), so packing is a pure
        # function of the item stream
        order = sorted(range(len(window)),
                       key=lambda i: (-window[i].bytes, i))
        bundles: List[List[int]] = [[] for _ in range(self.batch)]
        loads = [0] * self.batch
        counts = [0] * self.batch
        for i in order:
            it = window[i]
            fit = [b for b in range(len(bundles))
                   if not bundles[b]
                   or (loads[b] + it.bytes <= caps.max_bytes
                       and counts[b] + it.files <= caps.max_files)]
            if not fit:
                bundles.append([])
                loads.append(0)
                counts.append(0)
                fit = [len(bundles) - 1]
            b = min(fit, key=lambda j: (loads[j], j))
            bundles[b].append(i)
            loads[b] += it.bytes
            counts[b] += it.files
        # emit in window order of each bundle's earliest item, so bundle
        # numbering (and hence table-row order) is deterministic
        out = [sorted(b) for b in bundles if b]
        out.sort(key=lambda idxs: idxs[0])
        return [[window[i] for i in idxs] for idxs in out]


def make_packer(policy) -> BundlePolicy:
    if policy.bundling == "greedy":
        return GreedyPacker()
    if policy.bundling == "balanced":
        return BalancedPacker(policy.balance_batch)
    raise ValueError(f"bundling {policy.bundling!r} has no packer")


class BundleComposer:
    """Lazy, checkpointable composition of a catalog into bundle datasets.

    ``bundle_catalog`` is the live dict the scheduler resolves transfer rows
    against; it grows as bundles are cut.  ``members`` maps each bundle path
    to its item keys for introspection (dashboards, tests) — it is NOT part
    of the snapshot; a resumed composer re-derives only what the trajectory
    needs (the bundle datasets themselves plus the cursor)."""

    def __init__(self, catalog: Dict[str, Dataset], policy, seed: int = 0,
                 namespace: str = ""):
        policy.validate()
        self.policy = policy
        self.seed = seed
        # bundle paths are namespaced per campaign so N federated members
        # bundling over one shared transport can never collide
        self.namespace = namespace
        self._catalog = catalog
        self._paths = sorted(catalog)
        self._packer = make_packer(policy)
        self.target_files = int(policy.target_files)
        self.target_bytes = int(policy.target_bytes)
        self.bundle_catalog: Dict[str, Dataset] = {}
        self.members: Dict[str, List[str]] = {}
        self._ds_i = 0                      # cursor: dataset index
        self._file_i = 0                    # cursor: file index within it
        self._emitted = 0
        self._sizes_cache: Tuple[int, Optional[np.ndarray]] = (-1, None)

    # file runs are bounded at 1/RUN_DIVISOR of the effective caps, so a
    # bundle still packs several items (LPT has something to balance) while
    # composition stays O(bundles)
    RUN_DIVISOR = 4

    # ------------------------------------------------------------ item stream
    def _file_cumsum(self, ds_i: int) -> np.ndarray:
        """Cumulative synthesized per-file byte sizes for dataset ``ds_i``
        (its manifest): lognormal weights, integer-partitioned to sum
        exactly to the dataset's bytes.  Pure function of
        (seed, ds_i, catalog)."""
        if self._sizes_cache[0] == ds_i:
            return self._sizes_cache[1]
        ds = self._catalog[self._paths[ds_i]]
        n = max(1, ds.files)
        rng = np.random.default_rng([self.seed, ds_i])
        w = rng.lognormal(mean=0.0, sigma=1.2, size=n)
        w = w / w.sum()
        sizes = np.floor(w * ds.bytes).astype(np.int64)
        sizes[0] += ds.bytes - int(sizes.sum())
        csum = np.cumsum(sizes)
        self._sizes_cache = (ds_i, csum)
        return csum

    def _file_run_end(self, ds_i: int, i: int) -> int:
        """End index (exclusive) of the file run starting at manifest index
        ``i``: as many consecutive files as fit under 1/RUN_DIVISOR of the
        current effective caps — always at least one file."""
        caps = self._caps()
        csum = self._file_cumsum(ds_i)
        base = int(csum[i - 1]) if i else 0
        limit = base + max(1, caps.max_bytes // self.RUN_DIVISOR)
        j = int(np.searchsorted(csum, limit, side="right"))
        j = min(j, i + max(1, caps.max_files // self.RUN_DIVISOR), len(csum))
        return max(j, i + 1)

    def peek(self) -> Optional[BundleItem]:
        """The item at the cursor, or None when the catalog is consumed."""
        if self._ds_i >= len(self._paths):
            return None
        path = self._paths[self._ds_i]
        ds = self._catalog[path]
        if self.policy.granularity == "dataset":
            return BundleItem(path, ds.bytes, ds.files,
                              float(ds.directories), ds.unreadable)
        csum = self._file_cumsum(self._ds_i)
        i = self._file_i
        j = self._file_run_end(self._ds_i, i)
        base = int(csum[i - 1]) if i else 0
        return BundleItem(f"{path}#{i}:{j}", int(csum[j - 1]) - base, j - i,
                          ds.directories * (j - i) / max(1, ds.files),
                          ds.unreadable)

    def advance(self) -> None:
        if self._ds_i >= len(self._paths):
            return
        if self.policy.granularity == "dataset":
            self._ds_i += 1
            return
        ds = self._catalog[self._paths[self._ds_i]]
        self._file_i = self._file_run_end(self._ds_i, self._file_i)
        if self._file_i >= max(1, ds.files):
            self._ds_i += 1
            self._file_i = 0

    @property
    def done(self) -> bool:
        return self._ds_i >= len(self._paths)

    # ------------------------------------------------------------------- cuts
    def _caps(self) -> BundleCaps:
        return BundleCaps(
            max_files=min(self.policy.max_files, max(1, self.target_files)),
            max_bytes=min(self.policy.max_bytes, max(1, self.target_bytes)))

    def _emit(self, items: List[BundleItem]) -> Dataset:
        ns = f"{self.namespace}/" if self.namespace else ""
        path = f"{BUNDLE_PREFIX}{ns}b-{self._emitted:06d}"
        self._emitted += 1
        ds = Dataset(
            path=path,
            bytes=sum(it.bytes for it in items),
            files=sum(it.files for it in items),
            directories=max(1, int(sum(it.dirs for it in items))),
            unreadable=any(it.unreadable for it in items))
        self.bundle_catalog[path] = ds
        self.members[path] = [it.key for it in items]
        return ds

    def cut_next(self) -> List[Dataset]:
        """Cut the next bundle (greedy) or batch of bundles (balanced) at
        the current targets; returns the emitted bundle datasets (empty only
        when the catalog is consumed)."""
        return [self._emit(items)
                for items in self._packer.pack(self, self._caps())]

    def compose_all(self) -> List[Dataset]:
        """Cut until the catalog is consumed (eager mode: tests, one-shot
        composition studies)."""
        out: List[Dataset] = []
        while not self.done:
            cut = self.cut_next()
            if not cut:
                break
            out.extend(cut)
        return out

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        """JSON-serializable cursor + targets + the already-cut bundle
        datasets (the scheduler's rows refer to them by path; memberships
        are derivable and not needed to continue the trajectory)."""
        return {
            "ds_i": self._ds_i,
            "file_i": self._file_i,
            "emitted": self._emitted,
            "target_files": self.target_files,
            "target_bytes": self.target_bytes,
            "bundles": [[d.path, d.bytes, d.files, d.directories,
                         d.unreadable]
                        for d in self.bundle_catalog.values()],
        }

    def load_state_dict(self, d: dict) -> None:
        self._ds_i = int(d["ds_i"])
        self._file_i = int(d["file_i"])
        self._emitted = int(d["emitted"])
        self.target_files = int(d["target_files"])
        self.target_bytes = int(d["target_bytes"])
        self.bundle_catalog.clear()
        self.members.clear()
        for path, nbytes, nfiles, dirs, unreadable in d["bundles"]:
            self.bundle_catalog[path] = Dataset(
                path=path, bytes=int(nbytes), files=int(nfiles),
                directories=int(dirs), unreadable=bool(unreadable))
        self._sizes_cache = (-1, None)
