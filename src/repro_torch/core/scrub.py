"""Silent-corruption injection and scrub/repair campaigns (paper §5 / C3).

The paper's campaign checksummed every one of 29 M files at source and
destination and retransmitted corrupted ones; long-lived replicas then need
the same treatment *over time* — media rots silently, and only periodic
re-verification (a "scrub") finds it.  This module adds both halves:

  * **Latent corruption**: when a replica lands (its row turns SUCCEEDED),
    a seeded per-(dataset, destination, incarnation) draw from
    ``FaultInjector.latent_corrupt_offsets`` decides which byte offsets rot
    on the destination media.  These blocks *survived* transfer — the
    in-flight ``INTEGRITY`` retransmit already caught wire corruption — and
    are detectable only by re-reading the replica.  The draw is a pure
    function of the campaign seed, so it is bit-identical across processes
    and never perturbs the shared transient-fault RNG stream.

  * **Scrub engine**: ``ScrubEngine`` schedules periodic re-verification
    passes on the sim clock (the ``ControlPlane`` interval-anchoring shape).
    Each pass selects a byte-budgeted batch of replicas round-robin via one
    ``np.cumsum`` + ``np.searchsorted`` — O(active replicas) per pass, never
    O(files) — and localizes corrupt blocks to files by searchsorting the
    draw's byte offsets into the dataset's lognormal file-size partition
    (the ``BundleComposer._file_cumsum`` treatment).  A detected-corrupt
    replica's row is flipped back to FAILED with ``retries=0`` (the
    quarantine re-admission precedent), which re-enters the ordinary
    ``ReplicationScheduler`` retry/relay path: repairs are just re-transfer
    work contending fairly with live replication and demand traffic, and the
    ``ReplicaCatalog`` drops the replica from serving until it re-lands.

Replica integrity states: **clean** (no latent draw), **at-risk** (bad
blocks present, not yet detected), **corrupt** (detected, repair in
flight).  ``summary()`` reports the data-at-risk metric — bytes, files, and
exposure-days (landed -> repaired) — that the dashboard and the
``integrity`` benchmark gate surface.

Like ``DemandSpec``, the default ``NO_SCRUB`` spec compiles to **no engine
at all**: a scenario that does not opt in replays its pre-scrub trajectory
bit-identically.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.faults import FaultInjector, stable_digest
from repro_torch.core.pause import DAY
from repro_torch.core.transfer_table import Status, TransferRecord, TransferTable

TB = 1024 ** 4

Key = Tuple[str, str]                      # (dataset, destination)


@dataclass(frozen=True)
class ScrubSpec:
    """Declarative silent-corruption + scrub configuration.

    ``latent_per_pb`` is the expected number of latently corrupt blocks per
    PB landed (0 = subsystem off).  ``interval_days`` is the scrub cadence;
    0 disables scrubbing while keeping corruption live — the bit-rot
    ablation, where corrupt replicas survive to the end of the campaign.
    ``scan_tb_per_pass`` bounds the bytes re-verified per pass (0 =
    unlimited), which is what stretches detection latency — and therefore
    exposure-days — on large catalogs.
    """
    latent_per_pb: float = 0.0      # E[corrupt blocks] per PB landed; 0 = off
    interval_days: float = 10.0     # scrub cadence; 0 = never scrub (bit rot)
    scan_tb_per_pass: float = 500.0  # re-verification byte budget; 0 = all

    @property
    def enabled(self) -> bool:
        """True when this spec needs a live scrub engine."""
        return self.latent_per_pb > 0

    @property
    def scrubbing(self) -> bool:
        """True when periodic re-verification (and repair) is scheduled."""
        return self.enabled and self.interval_days > 0

    def validate(self) -> None:
        if self.latent_per_pb < 0:
            raise ValueError(
                f"latent_per_pb must be >= 0, got {self.latent_per_pb}")
        if not self.enabled:
            return
        if self.interval_days < 0:
            raise ValueError(
                f"interval_days must be >= 0, got {self.interval_days}")
        if self.scan_tb_per_pass < 0:
            raise ValueError(
                f"scan_tb_per_pass must be >= 0, got {self.scan_tb_per_pass}")


NO_SCRUB = ScrubSpec()


class ScrubEngine:
    """Tracks every replica's integrity state off the transfer table's
    listener stream, runs cadenced scrub passes, and routes repairs through
    the ordinary scheduler retry path by flipping corrupt rows to FAILED."""

    def __init__(self, spec: ScrubSpec, catalog: Dict[str, object],
                 table: TransferTable, injector: FaultInjector,
                 source: str, replicas, label: str = ""):
        self.spec = spec
        self.catalog = catalog          # live reference: top-ups route too
        self.table = table
        self.injector = injector
        self.source = source
        self.replicas = tuple(replicas)
        self.label = label
        # scrub-pass scheduling (ControlPlane interval anchoring)
        self._anchor: Optional[float] = None
        self._next_scan = math.inf
        self._cursor = 0                # round-robin position over replicas
        self._now = 0.0
        # integrity ledger: landed-at sim time per replica with bad blocks
        self._incarnation: Dict[Key, int] = {}   # SUCCEEDED landings per key
        self._at_risk: Dict[Key, float] = {}     # undetected bad blocks
        self._repairing: Dict[Key, float] = {}   # detected; re-transfer queued
        # cached lognormal file partitions (size cumsums), built lazily per
        # corrupt dataset.  The pool is bounded: repairs usually revisit the
        # same few datasets, but a long campaign can eventually corrupt every
        # dataset in a 29M-file catalog, and an unbounded cache would grow
        # O(catalog files).  Entries beyond the budget are recomputed
        # transiently — same draw, same result, O(one manifest) memory.
        self._file_parts: Dict[str, np.ndarray] = {}
        self._file_part_entries = 0
        # counters
        self.scans = 0                  # completed scrub passes
        self.scanned_replicas = 0
        self.scanned_bytes = 0
        self.detected = 0               # corrupt replicas found by scans
        self.repaired = 0               # corrupt replicas re-landed clean
        self.corrupt_files = 0          # corrupt files localized, cumulative
        self.corrupt_bytes = 0          # their sizes, cumulative
        self._exposure_days = 0.0       # closed exposure (repaired replicas)
        # flight-recorder seam: called after each scrub pass with (now,
        # pass stats); plain attribute, None compiles to no observation
        self.obs_hook = None
        table.add_listener(self._on_row)
        # adopt rows that predate this engine (checkpoint resume: the
        # restored table already carries the campaign's history; a following
        # load_state_dict replaces the ledger with the snapshot's truth)
        for rec in table.all():
            self._on_row(rec, None, None)

    # --------------------------------------------------------------- listener
    def _on_row(self, rec: TransferRecord, old_status: Optional[Status],
                old_source: Optional[str]) -> None:
        if rec.status is not Status.SUCCEEDED or \
                old_status is Status.SUCCEEDED:
            return
        key = (rec.dataset, rec.destination)
        inc = self._incarnation.get(key, 0) + 1
        self._incarnation[key] = inc
        landed_at = self._repairing.pop(key, None)
        if landed_at is not None:       # a repair re-transfer just landed
            self.repaired += 1
            done_at = rec.completed if rec.completed is not None else self._now
            self._exposure_days += max(0.0, done_at - landed_at) / DAY
        ds = self.catalog.get(rec.dataset)
        if ds is None:
            return                      # not a scrubbed catalog entry
        offs = self.injector.latent_corrupt_offsets(
            rec.dataset, rec.destination, ds.bytes, self.spec.latent_per_pb,
            incarnation=inc)
        now = rec.completed if rec.completed is not None else self._now
        if len(offs):
            self._at_risk[key] = now
        else:
            self._at_risk.pop(key, None)

    # -------------------------------------------------------------- scheduling
    def step(self, now: float) -> None:
        """Run any due scrub pass.  Called once per driver iteration, before
        the scheduler step, so repair flips are dispatched the same pass."""
        self._now = now
        if not self.spec.scrubbing:
            return
        if self._anchor is None:
            self._anchor = now
            self._next_scan = now + self.spec.interval_days * DAY
            return
        while now >= self._next_scan:
            self._run_pass(now)
            self._next_scan += self.spec.interval_days * DAY

    def next_action(self, now: float) -> float:
        """Absolute sim time of the next scheduled scrub pass (inf when
        scrubbing is off or not yet anchored) — a ``run_world`` next-event
        candidate, so an otherwise-idle world hops straight to the scan."""
        if not self.spec.scrubbing or self._anchor is None:
            return math.inf
        return self._next_scan

    def exhausted(self) -> bool:
        """True when no replica holds undetected or unrepaired bad blocks —
        the campaign-completion condition.  A corruption-only spec
        (``interval_days=0``) is always exhausted: nothing will ever detect
        the rot, and the campaign ends with replicas still at risk (the
        bit-rot ablation's surviving-corruption measurement)."""
        if not self.spec.scrubbing:
            return True
        return not self._at_risk and not self._repairing

    # ------------------------------------------------------------- scrub pass
    def _scan_order(self) -> Tuple[List[Key], np.ndarray]:
        """Every scrubbable SUCCEEDED replica in canonical (site, dataset)
        order, with its byte size — the pass's selection universe."""
        keys: List[Key] = []
        sizes: List[int] = []
        for dest in self.replicas:
            for name in sorted(self.table.succeeded_set(dest)):
                ds = self.catalog.get(name)
                if ds is None:
                    continue
                keys.append((name, dest))
                sizes.append(ds.bytes)
        return keys, np.asarray(sizes, dtype=np.int64)

    def _run_pass(self, now: float) -> None:
        """One byte-budgeted re-verification batch: rotate the cursor over
        the replica universe, cut the batch with cumsum/searchsorted, and
        flip every at-risk replica the batch covers into the repair path."""
        self.scans += 1
        keys, sizes = self._scan_order()
        n = len(keys)
        if n == 0:
            if self.obs_hook is not None:
                self.obs_hook(now, {"pass": self.scans, "scanned": 0,
                                    "detected": 0})
            return
        start = self._cursor % n
        order = (start + np.arange(n)) % n
        csum = np.cumsum(sizes[order])
        budget = (self.spec.scan_tb_per_pass * TB
                  if self.spec.scan_tb_per_pass > 0 else math.inf)
        k = max(1, int(np.searchsorted(csum, budget, side="right")))
        k = min(k, n)
        self._cursor = (start + k) % n
        self.scanned_replicas += k
        self.scanned_bytes += int(csum[k - 1])
        repairs = []
        for i in order[:k]:
            key = keys[int(i)]
            landed_at = self._at_risk.pop(key, None)
            if landed_at is None:
                continue                # verified clean
            self._repairing[key] = landed_at
            self.detected += 1
            nfiles, nbytes = self._localize(key)
            self.corrupt_files += nfiles
            self.corrupt_bytes += nbytes
            repairs.append((key[0], key[1],
                            dict(status=Status.FAILED, retries=0)))
        if repairs:
            # FAILED + retries=0 is the quarantine re-admission shape: the
            # scheduler's row listener re-queues each repair, the relay
            # planner stops using the corrupt copy as a donor, and the
            # replica catalog marks it unserveable until it re-lands
            self.table.update_many(repairs)
        if self.obs_hook is not None:
            self.obs_hook(now, {"pass": self.scans, "scanned": k,
                                "detected": len(repairs),
                                "at_risk": len(self._at_risk)})

    # cached file-partition budget: total file entries held across all
    # cached cumsums.  ~16 MB of int64 — O(active corruptions), not O(files).
    FILE_PART_BUDGET = 2_000_000

    def _file_csum(self, name: str, nf: int, nbytes: int) -> np.ndarray:
        """The dataset's synthesized file-size cumsum (the
        ``BundleComposer._file_cumsum`` treatment, keyed by name so it is
        stable under catalog growth).  Cached under ``FILE_PART_BUDGET``;
        oversized or overflow entries are recomputed per call."""
        csum = self._file_parts.get(name)
        if csum is not None:
            return csum
        rng = np.random.default_rng([self.injector.seed, stable_digest(name)])
        w = rng.lognormal(mean=0.0, sigma=1.2, size=nf)
        w /= w.sum()
        sizes = np.floor(w * nbytes).astype(np.int64)
        sizes[0] += nbytes - int(sizes.sum())
        csum = np.cumsum(sizes)
        if nf <= self.FILE_PART_BUDGET // 4:
            if self._file_part_entries + nf > self.FILE_PART_BUDGET:
                self._file_parts.clear()
                self._file_part_entries = 0
            self._file_parts[name] = csum
            self._file_part_entries += nf
        return csum

    def _localize(self, key: Key) -> Tuple[int, int]:
        """Corrupt (files, bytes) for a detected replica: searchsort the
        draw's byte offsets into the dataset's file-size cumsum — per-block
        array ops charged per run, with the per-file remainder recovered
        exactly from adjacent cumsum entries.  No per-file walk, no
        materialized per-file size array."""
        name, dest = key
        ds = self.catalog[name]
        offs = self.injector.latent_corrupt_offsets(
            name, dest, ds.bytes, self.spec.latent_per_pb,
            incarnation=self._incarnation[key])
        csum = self._file_csum(name, max(1, int(ds.files)), ds.bytes)
        idx = np.unique(np.searchsorted(csum, offs, side="right"))
        idx = idx[idx < len(csum)]
        if not len(idx):
            return 0, 0
        lo = np.where(idx > 0, csum[idx - 1], 0)
        return int(len(idx)), int((csum[idx] - lo).sum())

    # ---------------------------------------------------------------- metrics
    def summary(self) -> dict:
        """The data-at-risk view: live integrity states plus cumulative scrub
        and repair counters.  ``exposure_days`` sums landed->repaired spans
        for repaired replicas and landed->now for replicas still dirty, in
        canonical key order (bit-stable across processes and resumes)."""
        live = dict(self._at_risk)
        live.update(self._repairing)
        exposure = self._exposure_days
        at_risk_bytes = 0
        for key in sorted(live):
            exposure += max(0.0, self._now - live[key]) / DAY
            ds = self.catalog.get(key[0])
            at_risk_bytes += ds.bytes if ds is not None else 0
        return {
            "scans": self.scans,
            "scanned_replicas": self.scanned_replicas,
            "scanned_bytes": self.scanned_bytes,
            "detected": self.detected,
            "repaired": self.repaired,
            "at_risk_replicas": len(self._at_risk),
            "repairing_replicas": len(self._repairing),
            "data_at_risk_bytes": at_risk_bytes,
            "corrupt_files": self.corrupt_files,
            "corrupt_bytes": self.corrupt_bytes,
            "exposure_days": round(exposure, 6),
            "clean": not self._at_risk and not self._repairing,
        }

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {
            "anchor": self._anchor,
            "next_scan": (None if math.isinf(self._next_scan)
                          else self._next_scan),
            "cursor": self._cursor,
            "now": self._now,
            "incarnation": [[d, r, i] for (d, r), i in
                            sorted(self._incarnation.items())],
            "at_risk": [[d, r, t] for (d, r), t in
                        sorted(self._at_risk.items())],
            "repairing": [[d, r, t] for (d, r), t in
                          sorted(self._repairing.items())],
            "counters": {
                "scans": self.scans,
                "scanned_replicas": self.scanned_replicas,
                "scanned_bytes": self.scanned_bytes,
                "detected": self.detected,
                "repaired": self.repaired,
                "corrupt_files": self.corrupt_files,
                "corrupt_bytes": self.corrupt_bytes,
                "exposure_days": self._exposure_days,
            },
        }

    def load_state_dict(self, d: dict) -> None:
        self._anchor = d["anchor"]
        self._next_scan = (math.inf if d["next_scan"] is None
                           else float(d["next_scan"]))
        self._cursor = int(d["cursor"])
        self._now = float(d["now"])
        self._incarnation = {(ds, r): int(i) for ds, r, i in d["incarnation"]}
        self._at_risk = {(ds, r): float(t) for ds, r, t in d["at_risk"]}
        self._repairing = {(ds, r): float(t) for ds, r, t in d["repairing"]}
        c = d["counters"]
        self.scans = int(c["scans"])
        self.scanned_replicas = int(c["scanned_replicas"])
        self.scanned_bytes = int(c["scanned_bytes"])
        self.detected = int(c["detected"])
        self.repaired = int(c["repaired"])
        self.corrupt_files = int(c["corrupt_files"])
        self.corrupt_bytes = int(c["corrupt_bytes"])
        self._exposure_days = float(c["exposure_days"])
