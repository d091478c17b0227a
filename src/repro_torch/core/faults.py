"""Fault taxonomy, injection, and retry policy (paper C3 / §5).

The paper recorded 4086 faults over 4582 transfers — all transient ("bad
permissions, system maintenance periods, packet corruption"), none fatal,
because the transfer fabric retried automatically and notified on repeated
failure.  Fault counts were heavily skewed: most transfers fault-free, a few
with hundreds (Fig. 6) — we model that skew with a per-dataset "fragility"
drawn from a heavy-tailed distribution.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.kernels.checksum.ref import checksum_bytes_np

_PB = 1024 ** 5


def stable_digest(text: str) -> int:
    """Process-independent 32-bit digest of a string, via the integrity
    hash.  Python's ``hash()`` is randomized per process (PYTHONHASHSEED),
    so anything derived from it silently differs between the sweep runner's
    workers and the main process; this is the seedable replacement.

    The strings are ~50 bytes, so this hashes on the host with the numpy
    ``checksum_bytes_np``, exactly as the JAX package does: it never reaches
    the device kernel in either package.  That is the design, not a CPU
    fallback; the digest is bit-identical either way."""
    return int(checksum_bytes_np(text.encode("utf-8")))


class FaultKind(str, enum.Enum):
    NETWORK = "network"            # packet corruption, connection reset
    FILESYSTEM = "filesystem"      # fs hiccup / metadata timeout
    PERMISSION = "permission"      # unreadable files (persistent until fixed)
    OOM_SCAN = "oom_scan"          # directory scan exhausted memory
    INTEGRITY = "integrity"        # checksum mismatch -> retransmit file


TRANSIENT = (FaultKind.NETWORK, FaultKind.FILESYSTEM, FaultKind.INTEGRITY)


@dataclass
class Fault:
    kind: FaultKind
    at: float                    # sim time
    detail: str = ""


@dataclass
class RetryPolicy:
    max_retries: int = 5         # per transfer, before QUARANTINE + notify
    backoff_s: float = 60.0      # requeue delay after FAILED
    fault_retry_cost_s: float = 30.0  # in-transfer stall per transient fault


class FaultInjector:
    """Seeded, deterministic fault model for the simulated transport."""

    def __init__(self, seed: int = 0,
                 transient_per_tb: float = 0.15,
                 fragility_tail: float = 2.5,
                 persistent_fraction: float = 0.01):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.transient_per_tb = transient_per_tb
        self.fragility_tail = fragility_tail
        self.persistent_fraction = persistent_fraction
        self._fragility: Dict[str, float] = {}

    def fragility(self, dataset: str) -> float:
        """Heavy-tailed multiplier reproducing Fig. 6's skew (most transfers
        fault-free; a few with dozens-to-hundreds of faults)."""
        if dataset not in self._fragility:
            # Pareto-ish: ~75% of datasets get ~0 faults, the tail gets many
            u = self.rng.random()
            if u < 0.75:
                f = 0.0
            else:
                f = float(self.rng.pareto(self.fragility_tail) + 1.0) * 4.0
            self._fragility[dataset] = f
        return self._fragility[dataset]

    def n_transient_faults(self, dataset: str, nbytes: int) -> int:
        lam = self.transient_per_tb * (nbytes / 1024 ** 4) * self.fragility(dataset)
        return int(self.rng.poisson(lam))

    def transient_marks(self, dataset: str, nbytes: int) -> List[float]:
        """The complete submit-time draw for one transfer: fault count, then
        the sorted byte positions of each transient fault.  This is the ONLY
        way a transfer may consume the shared stream — the scalar transport
        and the ensemble lanes engine both call it, so their per-seed RNG
        consumption is identical by construction.  Draw order (fragility
        memo, Poisson count, uniform positions) is part of the determinism
        contract; reordering it changes every trajectory after the first
        fault."""
        n = self.n_transient_faults(dataset, nbytes)
        if not n:
            return []
        return sorted(float(b) for b in self.rng.uniform(0, nbytes, n))

    def is_persistent_unreadable(self, dataset: str) -> bool:
        # deterministic per (seed, dataset) — and, unlike Python's hash(),
        # identical across processes regardless of PYTHONHASHSEED
        h = stable_digest(f"perm|{self.seed}|{dataset}") % 10_000
        return h < int(self.persistent_fraction * 10_000)

    # --------------------------------------------------------- latent corruption
    def latent_corrupt_offsets(self, dataset: str, destination: str,
                               nbytes: int, rate_per_pb: float,
                               incarnation: int = 1) -> np.ndarray:
        """Silent-corruption draw for one landed replica: sorted byte offsets
        of blocks that arrived intact (the in-flight INTEGRITY retransmit
        already caught transfer corruption) but rot on the destination media
        and are detectable only by a later re-verification scan.

        Pure function of ``(seed, dataset, destination, incarnation)`` —
        independent of ``self.rng``, so evaluating it lazily at scrub time
        perturbs neither the shared transient-fault stream nor any existing
        trajectory.  ``incarnation`` counts SUCCEEDED landings of this
        replica: a repaired (re-transferred) copy is a fresh draw, which is
        what lets a scrub/repair campaign converge to zero corrupt bytes.
        """
        rng = np.random.default_rng(
            [self.seed, stable_digest(dataset), stable_digest(destination),
             int(incarnation)])
        n = int(rng.poisson(rate_per_pb * nbytes / _PB))
        if n == 0:
            return np.empty(0, dtype=np.int64)
        offs = rng.uniform(0.0, float(nbytes), n).astype(np.int64)
        return np.unique(offs)

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        """JSON-serializable RNG stream position + memoized fragilities, so a
        resumed campaign draws exactly the fault sequence the killed run
        would have drawn."""
        return {"rng": self.rng.bit_generator.state,
                "fragility": dict(self._fragility)}

    def load_state_dict(self, d: dict) -> None:
        self.rng.bit_generator.state = d["rng"]
        self._fragility = {k: float(v) for k, v in d["fragility"].items()}


class Notifier:
    """Paper §5: persistent failures are resolved by notifying a person.
    The hook records notifications; ``fix`` simulates the human fixing it."""

    def __init__(self):
        self.notifications: List[str] = []
        self.fixed: Dict[str, bool] = {}

    def notify(self, msg: str, dataset: str = "") -> None:
        self.notifications.append(msg)
        if dataset:
            self.fixed.setdefault(dataset, False)

    def fix(self, dataset: str) -> None:
        self.fixed[dataset] = True

    def is_fixed(self, dataset: str) -> bool:
        return self.fixed.get(dataset, False)

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {"notifications": list(self.notifications),
                "fixed": dict(self.fixed)}

    def load_state_dict(self, d: dict) -> None:
        self.notifications = list(d["notifications"])
        self.fixed = {k: bool(v) for k, v in d["fixed"].items()}


class FederationNotifier:
    """Routes a shared transport's notifications to the campaign(s) that own
    the dataset, and treats human fixes as global.

    When N campaigns share one ``SimulatedTransport``, a permission failure
    or scan OOM raised by a mover must land in the owning campaign's
    ``Notifier`` (that is where its human-fix clock and report live).  A
    dataset replicated by several campaigns (the paper moved the same 29 M
    files twice) notifies each of them — and once any campaign's admin fixes
    the underlying problem at the source, ``is_fixed`` unblocks every
    campaign's transfers: permissions are repaired once, not per campaign.

    Stateless by design: each member ``Notifier`` checkpoints itself, so this
    router needs no snapshot entry.  With a single member it is a transparent
    pass-through (the bit-identity anchor for 1-element federations).
    """

    def __init__(self):
        self._members: List[tuple] = []      # (catalog dict, Notifier)

    def attach(self, catalog: Dict[str, object], notifier: "Notifier") -> None:
        self._members.append((catalog, notifier))

    def notify(self, msg: str, dataset: str = "") -> None:
        targets = [n for cat, n in self._members
                   if dataset and dataset in cat]
        if not targets:                      # unattributable: tell everyone
            targets = [n for _, n in self._members]
        for n in targets:
            n.notify(msg, dataset)

    def is_fixed(self, dataset: str) -> bool:
        return any(n.is_fixed(dataset) for _, n in self._members)
