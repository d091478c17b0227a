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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as T

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
    device."""
    first = T.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=T.tree_map(lambda x: x.detach().float().clone(), params),
        m=T.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), params),
        v=T.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


@torch.no_grad()
def update(grads: PyTree, state: AdamWState, lr: torch.Tensor,
           cfg: AdamWConfig = AdamWConfig()
           ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new bf16 params, new state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(g, p, m, v):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        p.copy_(p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p))
        return p.to(torch.bfloat16)

    bf16 = [upd(g, p, m, v) for g, p, m, v in zip(
        T.leaves(grads), T.leaves(state.master), T.leaves(state.m),
        T.leaves(state.v))]
    return T.unflatten(grads, bf16), AdamWState(
        step, state.master, state.m, state.v), {
        "grad_norm": gnorm, "clip_scale": scale}
