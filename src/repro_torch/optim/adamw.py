"""AdamW with mixed precision, as the JAX package's ``optim/adamw.py``.

Params are bf16; the optimizer keeps f32 master params and f32 (m, v)
moments.  The state's trees mirror the params tree (the port's per-layer
``blocks`` list included), and every update is elementwise, leaf by leaf:
gradients are clipped by their global norm, the bias corrections use the
incremented step, and the new params come back as bf16 whatever the
model's dtype, as the reference's do.

``update`` writes the new master params and moments into the state's own
tensors, one leaf at a time, and returns them in a new ``AdamWState``: the
reference's jitted step donates its optimizer state (``donate_argnums`` in
``train/loop.py``) for the same reason, so that the old and the new f32
state are never held at once.  A caller must not read the old state after
an update.  A leaf is updated in slices of at most ``CHUNK`` elements, so
that the update's f32 temporaries stay small beside a large leaf (a
262144 x 5376 embedding is 5.6 GB in f32); every operation of the update
is elementwise, so the slices give the whole leaf's numbers bit for bit.
The global norm sums a larger leaf's squares slice by slice too, which
only reorders that leaf's f32 sum.

On the sharded path the state's leaves are DTensors, laid out by ZeRO-1
(``launch/shardings.py``, ``opt_state_specs``).  Each gradient is
redistributed to its moment's placements and the same slice code updates
the local shards in place; nothing is summed across shards, so the update
is the single-process one bit for bit.  The new bf16 params come back in
the moments' placements, and the caller lays them out as the params.  The
global norm is the one exception: each leaf's squares are summed over its
local shard and then over the ranks that hold other shards of it (an
all-reduce over the mesh dims it is sharded on), which reorders the f32
sum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as T

PyTree = Any
CHUNK = 1 << 26            # elements of a leaf updated at once


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    master: PyTree             # f32 master params
    m: PyTree                  # f32 first moment
    v: PyTree                  # f32 second moment


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init(params: PyTree) -> AdamWState:
    """Step 0, f32 copies of ``params``, zero moments; on the params'
    device (DTensors in the params' placements for DTensor params)."""
    first = T.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=T.tree_map(lambda x: x.detach().float().clone(), params),
        m=T.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                     params),
        v=T.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                     params))


def _local_sum_sq(x: torch.Tensor) -> torch.Tensor:
    if x.numel() <= CHUNK:
        return torch.sum(torch.square(x.float()))
    x = x.reshape(-1)
    return sum(torch.sum(torch.square(x[i:i + CHUNK].float()))
               for i in range(0, x.numel(), CHUNK))


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``'s squares, a plain 0-d tensor; a DTensor's over
    its local shard, then summed over the mesh dims it is sharded on (a
    partial sum is reduced first)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return _local_sum_sq(x)
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    pl = [Partial() if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(_local_sum_sq(x.to_local()), x.device_mesh,
                              pl, run_check=False).full_tensor()


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(_sum_sq(x) for x in T.leaves(tree)))


@torch.no_grad()
def update(grads: PyTree, state: AdamWState, lr: torch.Tensor,
           cfg: AdamWConfig = AdamWConfig()
           ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new bf16 params, new state, metrics)."""
    from torch.distributed.tensor import DTensor
    # a DTensor gradient (a partial sum, or laid out as its param) is laid
    # out as its moment first: reduce-scattered over "data" by ZeRO-1
    grads = T.tree_map(
        lambda g, p: g.redistribute(p.device_mesh, p.placements)
        if isinstance(p, DTensor) else g, grads, state.master)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(g, p, m, v):
        if isinstance(p, DTensor):               # a ZeRO-1 shard
            new = upd(g.to_local(), p.to_local(), m.to_local(), v.to_local())
            return DTensor.from_local(new, p.device_mesh, p.placements,
                                      run_check=False)
        new = torch.empty(p.shape, dtype=torch.bfloat16, device=p.device)
        g = g.reshape(-1)
        flat = [x.view(-1) for x in (p, m, v, new)]
        for i in range(0, g.numel(), CHUNK):
            p_, m_, v_, new_ = (x[i:i + CHUNK] for x in flat)
            g_ = g[i:i + CHUNK].float() * scale
            m_.copy_(cfg.b1 * m_ + (1 - cfg.b1) * g_)
            v_.copy_(cfg.b2 * v_ + (1 - cfg.b2) * g_ * g_)
            mh = m_ / b1c
            vh = v_ / b2c
            p_.copy_(p_ - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                + cfg.weight_decay * p_))
            new_.copy_(p_.to(torch.bfloat16))
        return new

    bf16 = [upd(g, p, m, v) for g, p, m, v in zip(
        T.leaves(grads), T.leaves(state.master), T.leaves(state.m),
        T.leaves(state.v))]
    return T.unflatten(grads, bf16), AdamWState(
        step, state.master, state.m, state.v), {
        "grad_norm": gnorm, "clip_scale": scale}
