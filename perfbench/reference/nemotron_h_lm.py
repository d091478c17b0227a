"""Plain Nemotron-H language model with experts (the ``nemotron_h``
family): the forward of NVIDIA's Nemotron 3 Nano, float32, with a
sequential Mamba2 recurrence, full causal attention and a dropless mixture
of experts.

Every block is one sublayer, ``x = x + sub(rmsnorm(x))``, by the
configuration's pattern (``sizes``' ``plan``):

* Mamba2: ``z = h @ in_z``; ``xBC = h @ [in_x | in_B | in_C]``; a causal
  depthwise conv of width ``d_conv`` over ``xBC`` (zero history) plus its
  bias, then SiLU, split into x (heads of ``mamba_hd``), B and C
  (``groups`` groups of ``n``; head h reads group h // (heads / groups));
  ``dt = softplus(h @ in_dt + dt_bias)`` and ``A = -exp(A_log)``, a scalar
  a head; the recurrence ``S[t] = exp(dt[t] A) S[t-1] + dt[t] x[t] B[t]^T``,
  ``y[t] = S[t] C[t] + D x[t]`` walked one step at a time; then the gated
  norm, ``y * silu(z)`` RMS-normalised over each group of channels on its
  own and times ``norm``; ``y @ out_proj``.
* Attention: grouped-query (query head j reads key and value head
  j // (heads / kv_heads)), no positional encoding, causal softmax scaled
  by head_dim^-1/2 over all earlier positions, ``out @ wo``; one row of
  the batch at a time.
* Mixture of experts: ``s = sigmoid(h @ router)``; the top k experts of
  ``s + score_bias`` by a stable descending sort; their weights the
  unbiased ``s``, divided by their sum (+ 1e-20) where ``norm_topk`` holds,
  times ``scale``; every routing goes to its expert (none is dropped),
  ``relu(h @ w_up)^2 @ w_down``, weighted and summed; plus the shared
  expert, ``relu(h @ w_up)^2 @ w_down`` of its own width.

Then a final RMSNorm and ``lm_head``.

Departures from Nemotron 3 Nano as published, which the port shares: the
seeded weights (the file's ``assumed``).  This reference keeps every value
in float32, where the published model and the port round the residual
stream to bfloat16 between blocks.

The weights are the harness's tree (bfloat16 and float32 leaves), each
weight converted to float32 at its product, an expert's two at a time, so
the model never sits in float32 whole.  Only the logits of the positions
asked for are formed.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.mamba1_lm import causal_conv, rmsnorm
from perfbench.reference.precision import Precision, exact


def ssd_recurrence(x, dt, Bm, Cm, A) -> torch.Tensor:
    """y (B, T, H, P) of the Mamba2 recurrence from a zero state, one step
    at a time.  x (B, T, H, P); dt (B, T, H); Bm, Cm (B, T, G, N); A (H,);
    the H heads are G groups of R, each reading its group's B and C."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2:]
    R = H // G
    decay = torch.exp(dt * A).view(Bsz, T, G, R)
    dx = (dt[..., None] * x).view(Bsz, T, G, R, P)
    S = x.new_zeros((Bsz, G, R, P, N))
    ys = []
    for t in range(T):
        S = decay[:, t, :, :, None, None] * S \
            + dx[:, t, ..., None] * Bm[:, t, :, None, None, :]
        ys.append(torch.einsum("bgrpn,bgn->bgrp", S, Cm[:, t]))
    return torch.stack(ys, 1).reshape(Bsz, T, H, P)


def group_rmsnorm(y: torch.Tensor, scale: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    g = y.unflatten(-1, (groups, -1))
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    return g.flatten(-2) * scale.float()


def mamba2(q: dict, s, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    B, T, _ = h.shape
    GN = s.groups * s.n
    z = prec.mm(h, q["in_z"])
    xBC = torch.cat([prec.mm(h, q[k]) for k in ("in_x", "in_B", "in_C")], -1)
    xBC = F.silu(causal_conv(
        xBC, torch.cat([q[f"conv_{k}_w"] for k in "xBC"], 1),
        torch.cat([q[f"conv_{k}_b"] for k in "xBC"])))
    x, Bm, Cm = torch.split(xBC, [s.d_in, GN, GN], dim=-1)
    x = x.reshape(B, T, s.mamba_heads, s.mamba_hd)
    dt = F.softplus(prec.mm(h, q["in_dt"]) + q["dt_bias"].float())
    A = -torch.exp(q["A_log"].float())
    y = ssd_recurrence(x, dt, Bm.reshape(B, T, s.groups, s.n),
                       Cm.reshape(B, T, s.groups, s.n), A)
    y = y + q["D"].float()[:, None] * x
    y = group_rmsnorm(y.reshape(B, T, s.d_in) * F.silu(z),
                      q["norm"]["scale"], s.groups, s.eps)
    return prec.mm(y, q["out_proj"])


def attention(q: dict, s, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    B, T, _ = h.shape
    rep = s.heads // s.kv_heads
    qh = prec.mm(h, q["wq"]).view(B, T, s.heads, s.hd)
    k = prec.mm(h, q["wk"]).view(B, T, s.kv_heads, s.hd)
    v = prec.mm(h, q["wv"]).view(B, T, s.kv_heads, s.hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    rows = []
    for b in range(B):
        kb = k[b].repeat_interleave(rep, dim=1)
        vb = v[b].repeat_interleave(rep, dim=1)
        lg = prec.einsum("thd,shd->hts", qh[b], kb) * s.hd ** -0.5
        w = torch.softmax(lg.masked_fill(~causal, float("-inf")), dim=-1)
        rows.append(prec.einsum("hts,shd->thd", w, vb).reshape(T, -1))
    return prec.mm(torch.stack(rows), q["wo"])


def relu2_mlp(w_up, w_down, x: torch.Tensor, prec: Precision
              ) -> torch.Tensor:
    return prec.mm(torch.square(F.relu(prec.mm(x, w_up))), w_down)


def moe(p: dict, s, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    B, T, d = h.shape
    x = h.reshape(B * T, d)
    scores = torch.sigmoid(prec.mm(x, p["router"]))
    top_i = torch.sort(scores + p["score_bias"].float(), dim=-1,
                       descending=True, stable=True).indices[:, :s.top_k]
    top_w = torch.gather(scores, 1, top_i)
    if s.norm_topk:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    top_w = top_w * s.scale
    y = x.new_zeros((B * T, s.top_k, d))
    for e in range(s.experts):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = relu2_mlp(p["w_up"][e], p["w_down"][e], x[tok], prec)
            y[tok, slot] = out * top_w[tok, slot, None]
    shared = relu2_mlp(p["shared"]["w_up"], p["shared"]["w_down"], x, prec)
    return (y.sum(1) + shared).view(B, T, d)


SUBLAYERS = {"mamba2": ("ssm", mamba2), "attn": ("attn", attention),
             "moe": ("moe", moe)}


@torch.no_grad()
def logits_at(tree: dict, s, tokens: torch.Tensor,
              positions: Sequence[Sequence[int]],
              prec: Precision = Precision()) -> List[torch.Tensor]:
    """Float32 logits (len(positions[b]), V) of row ``b`` of ``tokens``
    (B, L) at each of ``positions[b]``, for every row."""
    with exact():
        x = tree["embed"][tokens].float()
        for kind, p in zip(s.plan, tree["blocks"]):
            key, sub = SUBLAYERS[kind]
            x = x + sub(p[key], s, rmsnorm(x, p["ln"]["scale"], s.eps), prec)
        x = rmsnorm(x, tree["final_norm"]["scale"], s.eps)
        return [prec.mm(x[b, list(pos)], tree["lm_head"])
                for b, pos in enumerate(positions)]
