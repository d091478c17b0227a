"""Logical-axis sharding context.

A port of the JAX package's ``models/axes.py``.  Model code annotates
activations with *logical* axis names; the launcher installs a rules table
mapping logical names -> mesh axes over a ``DeviceMesh``.  Without an active
context (single-process runs), ``constrain`` is a no-op, and it passes a
plain tensor through unchanged as well: only a DTensor is redistributed,
to the placements the names resolve to (``jax.lax.with_sharding_constraint``
in the reference).

It also holds the mesh vocabulary that the model and the launcher share:
``Spec`` (a partition spec as the reference's data), ``mesh_sizes`` and
``placements``, the one bridge from a spec to DTensor placements.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_ACTIVE: Optional[Tuple[object, dict]] = None


class Spec:
    """A partition spec: one entry a tensor dim (``None``, an axis name or a
    tuple of names).  Iterates and compares as the tuple of its entries, so
    ``tuple(spec) == tuple(jax_spec)`` holds the port to the reference; a
    tree walk takes it as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __eq__(self, other):
        return isinstance(other, Spec) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"


def mesh_sizes(mesh) -> Dict[str, int]:
    """The ``{axis: size}`` of a ``DeviceMesh``, a mapping, or an object
    with such a ``shape`` (the reference's ``mesh.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    shape = mesh if isinstance(mesh, dict) else mesh.shape
    return {k: int(v) for k, v in shape.items()}


def axis_names(ax) -> Tuple[str, ...]:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def axis_size(ax, sizes: Dict[str, int]) -> int:
    return int(np.prod([sizes[a] for a in axis_names(ax)])) if ax else 1


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh``: one per
    mesh dim, ``Shard(d)`` where tensor dim d names that axis (a dim on
    ("pod", "data") is sharded on both, in the mesh's order, JAX's
    major-to-minor), ``Replicate()`` where no entry names it."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        axes = axis_names(ax)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: the axes of dim {d} are not in the "
                             f"mesh's order {names}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)




@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict):
    """rules: logical name -> mesh axis (str | tuple | None)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, dict(rules))
    try:
        yield
    finally:
        _ACTIVE = prev


def current_rules() -> Optional[Tuple[object, dict]]:
    return _ACTIVE


def resolve(names: Sequence[Optional[str]]) -> Optional[Spec]:
    if _ACTIVE is None:
        return None
    _, rules = _ACTIVE
    return Spec(*[rules.get(n) if n is not None else None for n in names])


def guarded(spec: Spec, shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """``spec`` with every axis dropped whose mesh size does not divide the
    tensor dim, or exceeds it (e.g. "heads"->model on a 9-head model with
    tp=16)."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec)):
        if ax is None:
            fixed.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= sizes[a]
        fixed.append(ax if (dim % size == 0 and dim >= size) else None)
    return Spec(*fixed)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Redistribute a DTensor to the placements of its logical axis names
    (a no-op without rules, and for a plain tensor), divisibility-guarded
    as ``guarded`` says.  Like the reference's ``with_sharding_constraint``
    it lays out the gradient too: ``redistribute`` sends the gradient back
    to the placements ``x`` had, also where the forward moves nothing."""
    from torch.distributed.tensor import DTensor
    if _ACTIVE is None or not isinstance(x, DTensor):
        return x
    mesh, _ = _ACTIVE
    spec = guarded(resolve(names), x.shape, mesh_sizes(mesh))
    return x.redistribute(mesh, placements(spec, mesh))
