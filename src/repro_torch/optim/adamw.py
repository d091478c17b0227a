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
an update.

The elementwise work is ``kernels/adamw``'s two passes: on the card the
global norm's sums of squares (one read of each gradient, summed in a
fixed order, so the same gradients give the same norm from run to run) and
the update (one read of each gradient, master, m and v and one write of
master, m, v and the bf16 params, a launch a leaf), with the clip scale,
the step and the bias corrections kept as 0-d tensors on the card: no
update waits for the host.  Given the same clip scale the kernel's state
and params are the eager update's bit for bit; its norm sums in another
order than ``torch.sum``'s, within f32 rounding.  On the CPU and the meta
device the plain version runs: the eager update, op for op, which takes a
leaf in slices of ``kernels/adamw/ref.py``'s ``CHUNK`` elements to bound
its f32 temporaries (the kernels make none).

On the sharded path the state's leaves are DTensors, laid out by ZeRO-1
(``launch/shardings.py``, ``opt_state_specs``).  Each gradient is
redistributed to its moment's placements and the same passes update the
local shards in place; nothing is summed across shards, so the update is
the single-process one bit for bit.  The new bf16 params come back in the
moments' placements, and the caller lays them out as the params.  The
global norm is the one exception: each leaf's squares are summed over its
local shard and then over the ranks that hold other shards of it (an
all-reduce over the mesh dims it is sharded on), which reorders the f32
sum.

The whole update is one coarse span, ``adamw.update``
(``repro_torch.obs.spans``), whose attrs are the bytes an update must move,
summed over the leaves (their local shards): ``numel``, ``grad_bytes``,
``state_bytes`` (master, m and v as held) and ``out_bytes`` (the bf16
params written), and ``leaves``, the leaves whose local shard holds an
element (on the card, the update kernel's launches).  They are computed
once per state tree and cached.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import local
from repro_torch.kernels.adamw import ops
from repro_torch.obs import spans

PyTree = Any


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


def _whole(x: torch.Tensor) -> torch.Tensor:
    """``x``, a DTensor that is a partial sum reduced first."""
    if local.is_dtensor(x) and any(p.is_partial() for p in x.placements):
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def _over_ranks(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The local sum of squares ``s`` of ``x``; a DTensor's summed over the
    mesh dims it is sharded on, a plain 0-d tensor."""
    if not local.is_dtensor(x):
        return s
    from torch.distributed.tensor import DTensor, Partial, Shard
    pl = [Partial() if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(s, x.device_mesh, pl,
                              run_check=False).full_tensor()


def global_norm(tree: PyTree) -> torch.Tensor:
    xs = [_whole(x) for x in T.leaves(tree)]
    sums, total = ops.sum_squares(xs)
    if not any(local.is_dtensor(x) for x in xs):
        return torch.sqrt(total)
    return torch.sqrt(sum(_over_ranks(x, s) for x, s in zip(xs, sums)))


# the last state tree's byte counts: (a weak reference to its first master
# leaf, the first gradient's dtype, the counts)
_bytes_cache: Tuple[Any, Any, Dict[str, int]] = (None, None, {})


def _leaf_bytes(gl: List[torch.Tensor], pl: List[torch.Tensor],
                ml: List[torch.Tensor], vl: List[torch.Tensor]
                ) -> Dict[str, int]:
    """The bytes one update moves at least, summed over the leaves' local
    shards; recomputed only when the state tree or the gradients' dtype
    changes."""
    global _bytes_cache
    ref, dtype, out = _bytes_cache
    if ref is not None and ref() is pl[0] and dtype is gl[0].dtype:
        return out
    shards = [p.to_local() if local.is_dtensor(p) else p for p in pl]
    n = [p.numel() for p in shards]
    out = {"numel": sum(n),
           "grad_bytes": sum(k * g.element_size() for k, g in zip(n, gl)),
           "state_bytes": sum(k * (p.element_size() + m.element_size()
                                   + v.element_size())
                              for k, p, m, v in zip(n, pl, ml, vl)),
           "out_bytes": 2 * sum(n),
           "leaves": sum(1 for k in n if k)}
    _bytes_cache = (weakref.ref(pl[0]), gl[0].dtype, out)
    return out


@torch.no_grad()
def update(grads: PyTree, state: AdamWState, lr: torch.Tensor,
           cfg: AdamWConfig = AdamWConfig()
           ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new bf16 params, new state, metrics)."""
    with spans.span("adamw.update") as sp:
        return _update(grads, state, lr, cfg, sp)


def _update(grads: PyTree, state: AdamWState, lr: torch.Tensor,
            cfg: AdamWConfig, sp: spans.Span
            ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    from torch.distributed.tensor import DTensor
    # a DTensor gradient (a partial sum, or laid out as its param) is laid
    # out as its moment first: reduce-scattered over "data" by ZeRO-1
    grads = T.tree_map(
        lambda g, p: g.redistribute(p.device_mesh, p.placements)
        if isinstance(p, DTensor) else g, grads, state.master)
    gl, pl, ml, vl = (T.leaves(t) for t in (grads, state.master, state.m,
                                              state.v))
    sp.attrs = _leaf_bytes(gl, pl, ml, vl)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    bf16 = ops.update(gl, pl, ml, vl, scale, lr, b1c, b2c, cfg.b1, cfg.b2,
                      cfg.eps, cfg.weight_decay)
    return T.unflatten(grads, bf16), AdamWState(
        step, state.master, state.m, state.v), {
        "grad_norm": gnorm, "clip_scale": scale}
