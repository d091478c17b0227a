"""Mixture-of-Experts layer with sort-based capacity dispatch.

A port of the dense path of the JAX package's ``models/moe.py``: the
router in f32, top-k, a Switch-style load-balancing auxiliary loss, and a
capacity-bounded dispatch by a stable sort on the expert id.  Each expert
takes at most ``C = moe_capacity(m, N)`` of the N tokens' K routings, in
the sort's order (token by token, top choice first); the rest are dropped.
The expert products are batched matmuls over the ``(E, C, d)`` buffer, as
the reference computes them outside any kernel.  The sharded path of the
reference (``_moe_forward_shardmap``, experts over a mesh axis) belongs to
the distribution slice (ROADMAP Queue A, steps 10-11).

The choices that keep the port on the reference's numbers:

* top-k is a stable descending sort of the router's probabilities, so a
  tie goes to the lower expert index first, as ``jax.lax.top_k`` gives it
  (``torch.topk`` promises no order);
* the drop order is ``argsort(stable=True)``, and the capacity is
  ``moe_capacity``'s integer arithmetic;
* the reference scatters dropped slots to the out-of-bounds row ``E * C``
  with ``mode="drop"``; here the buffer has one spare row there, which is
  discarded;
* the combine is the reference's f32 scatter-add over tokens, formed as a
  gather of each routing's output summed over K: ``index_add_`` on CUDA
  adds with atomics in a varying order, the sum over K is deterministic.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import _dense_init, init_mlp, mlp

Params = Mapping[str, torch.Tensor]


def moe_capacity(m: MoEConfig, n_tokens: int) -> int:
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_routed)
    return max(8, -(-cap // 8) * 8)  # round up to multiple of 8


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.n_routed
    p = {
        "router": _dense_init(gen, (d, E), torch.float32, scale=0.02),
        "w_gate": _dense_init(gen, (E, d, ff), dtype),
        "w_up": _dense_init(gen, (E, d, ff), dtype),
        "w_down": _dense_init(gen, (E, ff, d), dtype),
    }
    if m.n_shared > 0:
        p["shared"] = init_mlp(gen, d, m.n_shared * ff, dtype)
    return p


def _routing(p: Params, m: MoEConfig, xf: torch.Tensor):
    """Router softmax + top-k + Switch-style load-balancing aux loss:
    (top_w (N, K) f32, top_i (N, K) int64, aux f32 scalar)."""
    N = xf.shape[0]
    E, K = m.n_routed, m.top_k
    logits = xf.float() @ p["router"].float()                        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :K]                   # (N, K)
    top_w = torch.gather(probs, 1, top_i)
    if m.router_norm_topk:
        top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)
    me = torch.mean(probs, dim=0)                                    # (E,)
    ce = torch.bincount(top_i.reshape(-1), minlength=E).float() / (N * K)
    aux = E * torch.sum(me * ce)
    return top_w, top_i, aux


def _dispatch(top_i: torch.Tensor, C: int, E: int):
    """Each routing's slot in the (E * C) buffer, ``E * C`` where it is
    dropped, and the mask of kept routings; both (N * K,)."""
    flat_e = top_i.reshape(-1)
    n = flat_e.shape[0]
    ar = torch.arange(n, device=flat_e.device)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                        # (E,)
    pos = torch.empty_like(ar)
    pos[order] = ar - starts[flat_e[order]]                          # slot in expert
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    return slot, keep


def _dispatch_ffn_combine(xf, top_w, top_i, w_gate, w_up, w_down,
                          m: MoEConfig, C: int) -> torch.Tensor:
    """Dispatch, expert FFN and weighted combine for all E experts.
    xf: (N, d); top_w/top_i: (N, K); w_*: (E, d, f)/(E, f, d).  Returns
    (N, d) f32."""
    N, d = xf.shape
    K = top_w.shape[1]
    E = m.n_routed
    slot, keep = _dispatch(top_i, C, E)
    tok = torch.arange(N * K, device=xf.device) // K
    buf = xf.new_zeros((E * C + 1, d)).index_put((slot,), xf[tok])
    eb = buf[:E * C].reshape(E, C, d)               # the spare row dropped

    # ---- expert FFN (active FLOPs only) ------------------------------------
    g = torch.bmm(eb, w_gate)
    u = torch.bmm(eb, w_up)
    h = (F.silu(g.float()) * u.float()).to(xf.dtype)
    y = torch.bmm(h, w_down).reshape(E * C, d)

    # ---- combine: the reference's f32 scatter-add over tokens, as a
    # deterministic sum over each token's K routings ---------------------------
    safe = torch.where(keep, slot, 0)
    gathered = y[safe].float() * (top_w.reshape(-1) * keep)[:, None]
    return gathered.reshape(N, K, d).sum(dim=1)


def moe_forward(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux_loss f32 scalar): the
    reference's dense path on the full batch."""
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    xf = x.reshape(N, d)
    top_w, top_i, aux = _routing(p, m, xf)
    out = _dispatch_ffn_combine(xf, top_w, top_i, p["w_gate"], p["w_up"],
                                p["w_down"], m, moe_capacity(m, N))
    out = out.to(x.dtype).reshape(B, T, d)
    if m.n_shared > 0:
        out = out + mlp(p["shared"], x)
    return out, aux
