"""Public ops: AdamW's two passes on the tensors' device.

``sum_squares`` and ``update`` dispatch on the device their leaves lie on:
CUDA tensors go to the kernels (``adamw.sum_squares_cuda``,
``adamw.update_cuda``) or raise, CPU and meta tensors to the plain versions
(``ref.sum_squares``, ``ref.update``: the eager update, op for op).
Nothing falls back from one to the other.  DTensors (the ZeRO-1 state of
the sharded path) run both on their local shards: every operation of the
update is elementwise, and the caller sums the local sums of squares over
the ranks (``optim/adamw.py global_norm``).  A gradient is taken as its
flat view (a copy where it is not contiguous, as the plain version's
``reshape`` makes one).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import local
from repro_torch.kernels.adamw import ref
from repro_torch.kernels.adamw.adamw import sum_squares_cuda, update_cuda


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if local.is_dtensor(x) else x


def sum_squares(xs: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(each leaf's f32 sum of squares, over its local shard for a DTensor;
    their sum in leaf order)."""
    xs = [_local(x) for x in xs]
    dev = xs[0].device
    if dev.type == "cuda":
        return sum_squares_cuda([x.reshape(-1) for x in xs])
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"no sum of squares for {dev}")
    return ref.sum_squares(xs)


def update(gs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
           ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
           scale: torch.Tensor, lr, b1c: torch.Tensor, b2c: torch.Tensor,
           b1: float, b2: float, eps: float, weight_decay: float
           ) -> List[torch.Tensor]:
    """AdamW's update of every leaf: the masters ps and the moments ms and
    vs written in place; returns each leaf's new params in bf16 (DTensors
    in the masters' placements for a DTensor state, whose gradients are
    laid out as the masters).  On the card scale, lr, b1c and b2c are 0-d
    f32 tensors there, as ``optim/adamw.py`` forms them."""
    if not ps:
        return []
    hyper = (b1, b2, eps, weight_decay)
    scalars = (scale, lr, b1c, b2c)
    gl, pl, ml, vl = ([_local(x) for x in t] for t in (gs, ps, ms, vs))
    dev = pl[0].device
    if dev.type == "cuda":
        new = update_cuda([g.reshape(-1) for g in gl], pl, ml, vl, *scalars,
                          *hyper)
    elif dev.type in ("cpu", "meta"):
        new = [ref.update(g, p, m, v, *scalars, *hyper)
               for g, p, m, v in zip(gl, pl, ml, vl)]
    else:
        raise ValueError(f"no AdamW update for {dev}")
    if not any(local.is_dtensor(p) for p in ps):
        return new
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(n, p.device_mesh, p.placements,
                               run_check=False)
            if local.is_dtensor(p) else n for n, p in zip(new, ps)]
