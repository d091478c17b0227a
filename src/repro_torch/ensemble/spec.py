"""Ensemble declarations: a base scenario plus perturbation axes.

An ``EnsembleSpec`` names a base ``ScenarioSpec`` and a tuple of
``AxisSpec`` perturbations; compiling it yields one ``(ScenarioSpec, seed,
label)`` triple per lane.  Axes perturb *numbers*, never topology — site
names, route pairs, source, and replica order are invariant across lanes,
which is what lets the lanes engine hold every world in one dense array.

Axis paths (the ``name`` of an ``AxisSpec``):

* ``seed`` — the world seed (catalog + fault + demand streams).
* ``faults.<field>`` — any ``FaultProfileSpec`` field
  (``transient_per_tb``, ``fragility_tail``, ``max_retries``,
  ``backoff_s``, ``fault_retry_cost_s``).
* ``catalog.<field>`` — any ``CatalogSpec`` field.
* ``route.<SRC>-><DST>.gbps`` — one route's bandwidth.
* ``site.<NAME>.<field>`` — one ``SiteSpec`` field (``read_gbps``,
  ``write_gbps``, ``scan_files_per_s``, ``scan_mem_limit_files``,
  ``concurrency_knee``).
* ``policy.<field>`` — any ``TransferPolicySpec`` field (AIMD constants,
  bundle caps).  Non-static policies compile to a control plane, so these
  ensembles run on the scalar fallback, not the array engine.
* top-level scalars: ``human_fix_days``, ``task_setup_s``, ``max_days``,
  ``max_active_per_route``.

Grid mode takes the full cross product of all axis values; random mode
draws ``n_lanes`` independent combinations (one value per axis, uniform)
from a dedicated sample stream — deterministic in ``sample_seed`` and
independent of every in-world RNG stream.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.scenarios.spec import ScenarioSpec


@dataclass(frozen=True)
class AxisSpec:
    """One perturbation axis: a dotted path and the values it sweeps."""
    name: str
    values: Tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")
        object.__setattr__(self, "values", tuple(self.values))


def apply_axis(spec: ScenarioSpec, name: str, value):
    """Return ``(spec, seed_override)`` with one axis applied.  ``seed``
    is special-cased: it does not change the spec, it changes which world
    the lane builds."""
    if name == "seed":
        return spec, int(value)
    if name in ("human_fix_days", "task_setup_s", "max_days",
                "max_active_per_route", "step_s"):
        return spec.vary(**{name: value}), None
    head, _, rest = name.partition(".")
    if head == "faults":
        return spec.with_faults(**{rest: value}), None
    if head == "catalog":
        return spec.with_catalog(**{rest: value}), None
    if head == "policy":
        return spec.vary(
            policy=dataclasses.replace(spec.policy, **{rest: value})), None
    if head == "route":
        pair, _, fld = rest.partition(".")
        src, _, dst = pair.partition("->")
        routes, hits = [], 0
        for r in spec.routes:
            if r.source == src and r.destination == dst:
                r = dataclasses.replace(r, **{fld or "gbps": value})
                hits += 1
            routes.append(r)
        if not hits:
            raise KeyError(f"axis {name!r}: no route {src}->{dst}")
        return spec.vary(routes=tuple(routes)), None
    if head == "site":
        sname, _, fld = rest.partition(".")
        sites, hits = [], 0
        for s in spec.sites:
            if s.name == sname:
                s = dataclasses.replace(s, **{fld: value})
                hits += 1
            sites.append(s)
        if not hits:
            raise KeyError(f"axis {name!r}: no site {sname}")
        return spec.vary(sites=tuple(sites)), None
    raise KeyError(f"unknown ensemble axis {name!r}")


@dataclass(frozen=True)
class EnsembleSpec:
    """A batch of perturbed worlds around ``base``.

    ``axes`` empty → a pure seed sweep: ``n_lanes`` lanes with seeds
    ``base_seed .. base_seed + n_lanes - 1``.  With axes, ``mode="grid"``
    enumerates the cross product (``n_lanes`` then only caps it) and
    ``mode="random"`` draws ``n_lanes`` combinations."""
    name: str
    base: ScenarioSpec
    axes: Tuple[AxisSpec, ...] = ()
    n_lanes: int = 16
    base_seed: int = 0
    mode: str = "grid"              # "grid" | "random"
    sample_seed: int = 0

    def __post_init__(self):
        if self.mode not in ("grid", "random"):
            raise ValueError(f"unknown ensemble mode {self.mode!r}")
        if self.n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        object.__setattr__(self, "axes", tuple(self.axes))

    # ------------------------------------------------------------ compilation
    def combos(self) -> List[Dict[str, object]]:
        """The per-lane axis assignments, lane order fixed by construction.
        Lane 0 of a seed sweep is always the unperturbed (base_seed) world —
        the lane the bit-identity gate replays against the scalar engine."""
        if not self.axes:
            return [{"seed": self.base_seed + i} for i in range(self.n_lanes)]
        if self.mode == "grid":
            prod = itertools.product(*(a.values for a in self.axes))
            out = [dict(zip((a.name for a in self.axes), vals))
                   for vals in itertools.islice(prod, self.n_lanes)]
            return out
        rng = np.random.default_rng([self.sample_seed, 0x454E53])  # "ENS"
        out = []
        for _ in range(self.n_lanes):
            out.append({a.name: a.values[int(rng.integers(len(a.values)))]
                        for a in self.axes})
        return out

    def lane_specs(self) -> List[Tuple[ScenarioSpec, int, Dict[str, object]]]:
        """One ``(spec, seed, label)`` per lane."""
        lanes = []
        for combo in self.combos():
            spec, seed = self.base, self.base_seed
            for axis, value in combo.items():
                spec, s = apply_axis(spec, axis, value)
                if s is not None:
                    seed = s
            lanes.append((spec, seed, combo))
        return lanes
