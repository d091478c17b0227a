"""Mixture-of-Experts layer with sort-based capacity dispatch.

A port of the dense path of the JAX package's ``models/moe.py``: the
router in f32, top-k, a Switch-style load-balancing auxiliary loss, and a
capacity-bounded dispatch by a stable sort on the expert id.  Each expert
takes at most ``C = moe_capacity(m, N)`` of the N tokens' K routings, in
the sort's order (token by token, top choice first); the rest are dropped.
The expert products are batched matmuls over the ``(E, C, d)`` buffer, as
the reference computes them outside any kernel.

The sharded path (``_moe_forward_sharded``, the reference's
``_moe_forward_shardmap``) runs where logical-axis rules are installed over
a mesh with a "model" axis and ``x`` is a DTensor: tokens stay split over
the data axes and experts over "model" (EP).  Each rank routes its own
tokens, fills the dispatch buffer of its own expert block only (the
capacity is ``moe_capacity(m, N // dp)``, per token shard), runs the
block's FFN, and returns its partial output; the partials are summed over
"model" and the aux loss averaged over the data axes, both as DTensor
reductions (``Partial`` placements), which autograd differentiates.  The
local body runs through ``local_map``, the counterpart of ``shard_map``.

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
from repro_torch.obs import spans

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


def _count(ids: torch.Tensor, E: int) -> torch.Tensor:
    """``bincount(ids, minlength=E)`` as an integer scatter-add, which the
    meta device (the dry run) has and ``bincount`` has not."""
    return torch.zeros(E, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


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
    ce = _count(top_i.reshape(-1), E).float() / (N * K)
    aux = E * torch.sum(me * ce)
    return top_w, top_i, aux


def _dispatch(top_i: torch.Tensor, C: int, E: int, e0: int = 0,
              Eb: int = 0):
    """Each routing's slot in the (Eb * C) buffer of the expert block
    [e0, e0 + Eb) (all E experts by default), ``Eb * C`` where it is
    dropped or routed outside the block, and the mask of kept routings;
    both (N * K,)."""
    Eb = Eb or E
    flat_e = top_i.reshape(-1)
    n = flat_e.shape[0]
    ar = torch.arange(n, device=flat_e.device)
    order = torch.argsort(flat_e, stable=True)
    counts = _count(flat_e, E)
    # the block's routings before capacity; with C and Eb they give the
    # expert rows that hold a kept routing (recorded while profiling)
    spans.count("moe.dispatch", counts[e0:e0 + Eb], C=C, Eb=Eb)
    starts = torch.cumsum(counts, 0) - counts                        # (E,)
    pos = torch.empty_like(ar)
    pos[order] = ar - starts[flat_e[order]]                          # slot in expert
    local_e = flat_e - e0
    keep = (pos < C) & (local_e >= 0) & (local_e < Eb)
    slot = torch.where(keep, local_e * C + pos, Eb * C)
    return slot, keep


def _dispatch_ffn_combine(xf, top_w, top_i, w_gate, w_up, w_down,
                          m: MoEConfig, C: int, e0: int = 0) -> torch.Tensor:
    """Dispatch, expert FFN and weighted combine for the expert block
    [e0, e0 + Eb) of the Eb experts in ``w_*`` (all E by default).
    xf: (N, d); top_w/top_i: (N, K); w_*: (Eb, d, f)/(Eb, f, d).  Returns
    the (N, d) f32 output, zero for the routings outside the block: the
    caller sums the blocks' partial outputs."""
    N, d = xf.shape
    K = top_w.shape[1]
    E, Eb = m.n_routed, w_gate.shape[0]
    slot, keep = _dispatch(top_i, C, E, e0, Eb)
    tok = torch.arange(N * K, device=xf.device) // K
    buf = xf.new_zeros((Eb * C + 1, d)).index_put((slot,), xf[tok])
    eb = buf[:Eb * C].reshape(Eb, C, d)             # the spare row dropped

    # ---- expert FFN (active FLOPs only) ------------------------------------
    g = torch.bmm(eb, w_gate)
    u = torch.bmm(eb, w_up)
    h = (F.silu(g.float()) * u.float()).to(xf.dtype)
    y = torch.bmm(h, w_down).reshape(Eb * C, d)

    # ---- combine: the reference's f32 scatter-add over tokens, as a
    # deterministic sum over each token's K routings ---------------------------
    safe = torch.where(keep, slot, 0)
    gathered = y[safe].float() * (top_w.reshape(-1) * keep)[:, None]
    return gathered.reshape(N, K, d).sum(dim=1)


def moe_forward(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux_loss f32 scalar): the sharded
    path under sharding rules with a DTensor ``x``, else the reference's
    dense path on the full batch."""
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    sharded = _sharded_moe_context(x, N)
    if sharded is not None:
        out, aux = _moe_forward_sharded(p, cfg, x, *sharded)
    else:
        xf = x.reshape(N, d)
        top_w, top_i, aux = _routing(p, m, xf)
        out = _dispatch_ffn_combine(xf, top_w, top_i, p["w_gate"],
                                    p["w_up"], p["w_down"], m,
                                    moe_capacity(m, N))
        out = out.to(x.dtype).reshape(B, T, d)
    if m.n_shared > 0:
        out = out + mlp(p["shared"], x)
    return out, aux


def _sharded_moe_context(x: torch.Tensor, n_tokens: int):
    """(mesh, the data axes) where the sharded path runs: logical rules
    are installed, the mesh has a 'model' axis, ``x`` is a DTensor, and the
    token count divides evenly over the data axes; else None."""
    from repro_torch.kernels import local
    from repro_torch.models import axes as AX
    active = AX.current_rules()
    if active is None or not local.is_dtensor(x):
        return None
    mesh, rules = active
    sizes = AX.mesh_sizes(mesh)
    if "model" not in sizes:
        return None
    dp_axes = AX.axis_names(rules.get("batch"))
    if n_tokens % AX.axis_size(dp_axes, sizes):
        return None
    return mesh, dp_axes


def _moe_forward_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor,
                         mesh, dp_axes) -> Tuple[torch.Tensor, torch.Tensor]:
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import local
    from repro_torch.models.axes import Spec, axis_size, mesh_sizes, placements
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    E = m.n_routed
    sizes = mesh_sizes(mesh)
    ep = sizes["model"]
    assert E % ep == 0, (E, ep)
    Eb = E // ep
    dp = axis_size(dp_axes, sizes)
    C_local = moe_capacity(m, N // dp)
    dp_spec = dp_axes if len(dp_axes) != 1 else dp_axes[0]

    def place(t, *spec):
        want = placements(Spec(*spec), mesh)
        return t if tuple(t.placements) == want else t.redistribute(mesh,
                                                                    want)
    xf = place(x.reshape(N, d), dp_spec or None, None)
    router = place(p["router"], None, None)
    ws = [place(p[k], "model", None, None)
          for k in ("w_gate", "w_up", "w_down")]
    e0 = mesh.get_local_rank("model") * Eb
    names = mesh.mesh_dim_names
    # the partial outputs are summed over 'model'.  aux is the same on
    # every 'model' rank (the same tokens) and averaged over the data
    # shards; it is returned as a sum over both of aux / (dp * ep): the
    # gradient of a sum reaches every shard whole, and the router's and
    # xf's gradients, summed over 'model' (they are replicated inputs of a
    # split body), then count each data shard's aux once, not ep times
    out_pl = [Shard(0) if a in dp_axes else Partial() if a == "model"
              else Replicate() for a in names]
    aux_pl = [Partial() if a in dp_axes or a == "model" else Replicate()
              for a in names]

    def inner(xf, router, w_gate, w_up, w_down, e0):
        top_w, top_i, aux = _routing({"router": router}, m, xf)
        return _dispatch_ffn_combine(xf, top_w, top_i, w_gate, w_up, w_down,
                                     m, C_local, e0), aux / (dp * ep)

    out, aux = local.run_local(inner, (xf, router, *ws), (out_pl, aux_pl),
                               (e0,))
    out = place(out, dp_spec or None, None)
    aux = aux.redistribute(mesh, [Replicate()] * len(names))
    return out.to(x.dtype).reshape(B, T, d), aux
