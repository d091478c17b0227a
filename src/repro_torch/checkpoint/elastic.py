"""Elastic rescaling: restore a checkpoint onto a different mesh.

A port of the JAX package's ``checkpoint/elastic.py``.  Checkpoints store
canonical full arrays (chunked files), so resharding is a placement
decision, not a data transformation: ``load_for_mesh`` distributes every
leaf with the placements its spec gives on the *new* ``DeviceMesh``
(``distribute_tensor``, the counterpart of ``jax.device_put`` with a
``NamedSharding``).  Restore first with ``restore_checkpoint``, which
hashes every file it reads on the device (the integrity-hash kernel on
the card), then place.  Combined with the relay broadcast
(``core/relay_collectives.py``) a joining pod receives parameters from a
peer pod over fast links instead of re-reading the store — the paper's
relay insight applied to elastic scale-up.

``plan_reshard`` reports, per leaf, bytes moved per device for the new
layout (useful to size the rescale pause).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch import tree as T
from repro_torch.models.axes import placements

PyTree = Any


def load_for_mesh(tree: PyTree, mesh, spec_tree: PyTree) -> PyTree:
    """Every leaf of ``tree`` distributed on ``mesh`` with the placements of
    its spec in ``spec_tree`` (a tree of ``tree``'s structure)."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, spec):
        x = x if x.is_meta else x.to(mesh.device_type)   # meta: the dry run
        return distribute_tensor(x, mesh, placements(spec, mesh))
    return T.tree_map(put, tree, spec_tree)


def plan_reshard(tree: PyTree, old_mesh_shape: Dict[str, int],
                 new_mesh_shape: Dict[str, int], spec_tree: PyTree) -> Dict:
    """Analytic reshard plan: per-device bytes before/after and total moved."""
    def leaf_bytes(x):
        if not hasattr(x, "shape"):
            return 0
        item = (x.dtype.itemsize if hasattr(x.dtype, "itemsize")
                else x.element_size())
        return int(np.prod(tuple(x.shape))) * item

    def shards(spec, mesh_shape):
        n = 1
        for axis in spec:
            if axis is None:
                continue
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                n *= mesh_shape.get(a, 1)
        return max(1, n)

    total = moved = 0
    for x, spec in zip(T.leaves(tree), T.leaves(spec_tree)):
        b = leaf_bytes(x)
        total += b
        old_per = b // shards(spec, old_mesh_shape)
        new_per = b // shards(spec, new_mesh_shape)
        moved += abs(new_per - old_per)
    return {"total_bytes": total, "approx_bytes_moved_per_device": moved}
