"""Declarative transfer-tuning policies (paper §3: "Globus organized the
transfers to make efficient use of ESnet"; GridFTP 2001: bundle composition
and online concurrency control dominate achieved throughput for
many-small-file workloads).

A ``TransferPolicySpec`` declares, on a ``ScenarioSpec`` (or for every member
of a ``FederationSpec``), how the control plane should turn a catalog into
transfer tasks and how it should steer them while they run:

  * **bundling** — how files/datasets are bin-packed into transfer tasks
    (the paper's tool moved 29 M files by submitting *large bundles* as
    Globus tasks, never one task per file):

      - ``"dataset"``  — the pre-control-plane model: one task per catalog
        dataset (the bit-identity baseline);
      - ``"greedy"``   — first-fit in catalog order up to the size targets;
      - ``"balanced"`` — LPT batches: the next window of items is packed
        into size-balanced bundles (largest item to the lightest bundle).

  * **granularity** — what the packer's items are: whole ``"dataset"``
    trees, or individual ``"file"``s from per-dataset manifests
    (synthesized deterministically from the scenario seed).

  * **controller** — the online tuner observing per-route flow telemetry
    each control interval: ``"static"`` (no adjustment — the declared caps
    and targets hold for the whole campaign), ``"aimd"`` (additive-increase
    / multiplicative-decrease concurrency tuning), ``"gradient"``
    (hill-climbing bundle-size tuning), or a ``"+"``-joined combination
    such as ``"aimd+gradient"``.

The default spec — per-dataset tasks, static everything — compiles to **no
control plane at all**: a scenario that does not opt in runs exactly the
code path (and trajectory) it ran before this subsystem existed.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.routes import GB, TB

KNOWN_BUNDLING = ("dataset", "greedy", "balanced")
KNOWN_GRANULARITY = ("dataset", "file")
KNOWN_CONTROLLERS = ("static", "aimd", "gradient")


@dataclass(frozen=True)
class TransferPolicySpec:
    """How a campaign composes transfer tasks and tunes them online."""
    # ---- bundle composition
    bundling: str = "dataset"          # dataset | greedy | balanced
    granularity: str = "dataset"       # dataset | file (per-dataset manifests)
    max_files: int = 1_000_000         # hard cap per bundle (scan-memory safe)
    max_bytes: int = 100 * TB          # hard cap per bundle
    target_files: int = 50_000         # initial soft target per bundle
    target_bytes: int = 20 * TB        # initial soft target per bundle
    lookahead: int = 4                 # bundles kept composed ahead of the scheduler
    balance_batch: int = 4             # bundles per LPT batch ("balanced" only)
    # ---- online control
    controller: str = "static"         # static | aimd | gradient | a+b
    control_interval_s: float = 6 * 3600.0
    min_active_per_route: int = 1      # AIMD floor
    max_active_per_route: int = 8      # AIMD ceiling
    fault_budget: int = 8              # faults/route/interval before backoff
    drop_fraction: float = 0.15        # tput drop triggering AIMD decrease
    bundle_growth: float = 1.3         # gradient tuner step factor
    min_target_files: int = 1_000     # gradient tuner floor
    min_target_bytes: int = 64 * GB    # gradient tuner floor

    # ------------------------------------------------------------- helpers
    @property
    def enabled(self) -> bool:
        """True when this policy needs a live control plane (any deviation
        from the implicit one-dataset-one-task / fixed-caps model)."""
        return self.bundling != "dataset" or self.controller != "static"

    def controller_names(self):
        names = tuple(n for n in self.controller.split("+") if n != "static")
        return names

    def validate(self) -> None:
        if self.bundling not in KNOWN_BUNDLING:
            raise ValueError(f"unknown bundling {self.bundling!r}; "
                             f"expected one of {KNOWN_BUNDLING}")
        if self.granularity not in KNOWN_GRANULARITY:
            raise ValueError(f"unknown granularity {self.granularity!r}; "
                             f"expected one of {KNOWN_GRANULARITY}")
        for name in self.controller.split("+"):
            if name not in KNOWN_CONTROLLERS:
                raise ValueError(f"unknown controller {name!r}; expected "
                                 f"'+'-joined {KNOWN_CONTROLLERS}")
        if self.granularity == "file" and self.bundling == "dataset":
            raise ValueError("granularity='file' requires a bundling packer "
                             "(greedy or balanced)")
        if self.max_files < 1 or self.max_bytes < 1:
            raise ValueError("bundle hard caps must be positive")
        if self.min_active_per_route < 1 \
                or self.max_active_per_route < self.min_active_per_route:
            raise ValueError("need 1 <= min_active_per_route "
                             "<= max_active_per_route")


# the naive pre-control-plane baseline, usable anywhere a policy is expected
STATIC_POLICY = TransferPolicySpec()
