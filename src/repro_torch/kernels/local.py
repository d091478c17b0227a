"""Run a kernel's wrapper on the local shards of DTensors.

The sharded forward hands the kernels' public ops (flash attention, the
selective scan) and the MoE expert block DTensors.  Each of them checks
that its inputs are laid out so that every rank's shard is a whole problem
of its own (batch rows, attention heads, scan channels, an expert block),
raises ``ValueError`` on any other placement (nothing is gathered
quietly), and runs its plain-tensor wrapper on the local shards through
``local_map``: the kernel on the card, the plain version on the CPU.  This
is the counterpart of the reference's ``shard_map`` body.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _spell(p) -> str:
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(p, Replicate):
        return "R"
    return f"S{p.dim}" if isinstance(p, Shard) else repr(p)


def check(name: str, tensors: Sequence, allowed: Sequence[Sequence[str]],
          what: str) -> None:
    """``ValueError`` unless every input is a DTensor on one mesh and, on
    each mesh dim, the inputs' placements are one of the ``allowed`` rows
    (one placement spelled per input: ``"R"`` or ``"S<dim>"``), each shard
    an even split.  A mesh dim of size 1 takes any placements."""
    if not all(is_dtensor(t) for t in tensors):
        raise ValueError(f"{name}: all inputs must be DTensors, or none")
    mesh = tensors[0].device_mesh
    if any(t.device_mesh != mesh for t in tensors):
        raise ValueError(f"{name}: inputs on different meshes")
    rows = {tuple(row) for row in allowed}
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:            # a dim of one rank splits nothing
            continue
        got = tuple(_spell(t.placements[i]) for t in tensors)
        if got not in rows:
            raise ValueError(
                f"{name}: placements {got} on mesh dim "
                f"{mesh.mesh_dim_names[i] if mesh.mesh_dim_names else i} "
                f"are not {what}; redistribute the inputs first")
        for t, p in zip(tensors, got):
            if p != "R" and t.shape[int(p[1:])] % mesh.size(i):
                raise ValueError(f"{name}: dim {p[1:]} of {tuple(t.shape)} "
                                 f"does not split evenly {mesh.size(i)} "
                                 "ways")


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a gradient leaving a
    ``local_map`` body (an einsum's backward gives transposed strides) is
    viewed by DTensor outside it, and a view of such strides cannot be
    taken."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def run_local(fn: Callable, args: Sequence, outs: Sequence,
              extra: Sequence = ()):
    """``fn(*local shards of args, *extra)`` through ``local_map``; the
    results are DTensors placed as ``outs`` says, one entry an output: an
    input DTensor (its placements) or a sequence of placements."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    in_pl = [list(a.placements) for a in args]
    out_pl = [list(o.placements if is_dtensor(o) else o) for o in outs]
    # an input replicated over a mesh dim on which another input or an
    # output is split feeds each rank's part of the work: its gradient
    # there is the sum of the ranks' (the local_map default would call
    # each rank's part the whole)
    split = [any(not isinstance(pl[i], Replicate) for pl in in_pl + out_pl)
             for i in range(mesh.ndim)]
    grad_pl = [[Partial() if split[i] and isinstance(p, Replicate) else p
                for i, p in enumerate(pl)] for pl in in_pl]
    n = len(args)

    def body(*xs):
        return fn(*(_ContiguousGrad.apply(x) if x.requires_grad else x
                    for x in xs[:n]), *xs[n:])
    mapped = local_map(body, out_placements=tuple(out_pl) if len(outs) > 1
                       else out_pl[0],
                       in_placements=tuple(in_pl) + (None,) * len(extra),
                       in_grad_placements=tuple(grad_pl)
                       + (None,) * len(extra),
                       device_mesh=mesh)
    return mapped(*args, *extra)
