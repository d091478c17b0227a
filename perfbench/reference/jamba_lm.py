"""Plain Jamba language model: the forward of AI21's Jamba, float32, with a
sequential scan, full causal attention and a dropless mixture of experts.

Every layer is ``x = x + mixer(rmsnorm(x)); x = x + ffn(rmsnorm(x))``, the
mixer and the FFN as the configuration's schedule gives them (``sizes``'
``plan``):

* Mamba1: ``u = h @ in_x``, ``z = h @ in_z``; a causal depthwise conv of
  width ``d_conv`` over ``u`` (zero history) plus ``conv_b``, then SiLU;
  ``(dt_r, B, C) = u @ x_proj``, each then RMS-normalised (eps
  ``rms_norm_eps``, scales ``dt_norm``, ``b_norm``, ``c_norm``); ``dt =
  softplus(dt_r @ dt_proj + dt_bias)``; ``A = -exp(A_log)``; the recurrence
  ``h[t] = exp(dt[t] A) h[t-1] + dt[t] u[t] B[t]``, ``y[t] = <h[t], C[t]>``
  walked one step at a time; ``y = (y + D u) * silu(z)``; ``y @ out_proj``.
* Attention: grouped-query (query head j reads key and value head
  j // (heads / kv_heads)), no positional encoding, causal softmax scaled
  by head_dim^-1/2 over all earlier positions, ``out @ wo``.
* MLP: ``(silu(h @ w_gate) * (h @ w_up)) @ w_down``.
* Mixture of experts: a softmax over ``h @ router``, the top k by a stable
  descending sort, their weights not renormalised; every routing goes to
  its expert (none is dropped), whose MLP output is weighted and summed.

Then a final RMSNorm and ``lm_head``.

Departures from Jamba as published, which the port shares: the dt
initialisation of the seeded weights is Mamba's (the file's ``assumed``);
the port rounds the residual stream to bfloat16 between layers where this
reference keeps every value in float32.

The weights are the harness's tree (bfloat16 and float32 leaves), each
weight converted to float32 at its product, an expert's three at a time,
so the model never sits in float32 whole.  Only the logits of the
positions asked for are formed.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.mamba1_lm import causal_conv, rmsnorm, \
    sequential_scan
from perfbench.reference.precision import Precision, exact


def mamba(q: dict, s, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    u = prec.mm(h, q["in_x"])
    z = prec.mm(h, q["in_z"])
    u = F.silu(causal_conv(u, q["conv_w"], q["conv_b"]))
    dt_r, Bm, Cm = torch.split(prec.mm(u, q["x_proj"]), [s.r, s.n, s.n],
                               dim=-1)
    dt_r = rmsnorm(dt_r, q["dt_norm"]["scale"], s.eps)
    Bm = rmsnorm(Bm, q["b_norm"]["scale"], s.eps)
    Cm = rmsnorm(Cm, q["c_norm"]["scale"], s.eps)
    dt = F.softplus(prec.mm(dt_r, q["dt_proj"]) + q["dt_bias"].float())
    A = -torch.exp(q["A_log"].float())
    y = sequential_scan(u, dt, Bm, Cm, A)
    y = (y + q["D"].float() * u) * F.silu(z)
    return prec.mm(y, q["out_proj"])


def attention(q: dict, s, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    B, T, _ = h.shape
    rep = s.heads // s.kv_heads
    qh = prec.mm(h, q["wq"]).view(B, T, s.heads, s.hd)
    k = prec.mm(h, q["wk"]).view(B, T, s.kv_heads, s.hd)
    v = prec.mm(h, q["wv"]).view(B, T, s.kv_heads, s.hd)
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    lg = prec.einsum("bthd,bshd->bhts", qh, k) * s.hd ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(lg.masked_fill(~causal, float("-inf")), dim=-1)
    out = prec.einsum("bhts,bshd->bthd", w, v).reshape(B, T, s.heads * s.hd)
    return prec.mm(out, q["wo"])


def mlp(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["w_gate"])) * prec.mm(x, p["w_up"]),
                   p["w_down"])


def moe(p: dict, s, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    B, T, d = h.shape
    x = h.reshape(B * T, d)
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :s.top_k]
    top_w = torch.gather(probs, 1, top_i)
    y = x.new_zeros((B * T, s.top_k, d))
    for e in range(s.experts):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            out = mlp({k: p[k][e] for k in ("w_gate", "w_up", "w_down")},
                      x[tok], prec)
            y[tok, slot] = out * top_w[tok, slot, None]
    return y.sum(1).view(B, T, d)


def layer(p: dict, s, mixer: str, ffn: str, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    h = rmsnorm(x, p["ln1"]["scale"], s.eps)
    x = x + (attention(p["attn"], s, h, prec) if mixer == "attn"
             else mamba(p["ssm"], s, h, prec))
    h = rmsnorm(x, p["ln2"]["scale"], s.eps)
    return x + (moe(p["moe"], s, h, prec) if ffn == "moe"
                else mlp(p["mlp"], h, prec))


@torch.no_grad()
def logits_at(tree: dict, s, tokens: torch.Tensor,
              positions: Sequence[Sequence[int]],
              prec: Precision = Precision()) -> List[torch.Tensor]:
    """Float32 logits (len(positions[b]), V) of row ``b`` of ``tokens``
    (B, L) at each of ``positions[b]``, for every row."""
    with exact():
        x = tree["embed"][tokens].float()
        for (mixer, ffn), p in zip(s.plan, tree["blocks"]):
            x = layer(p, s, mixer, ffn, x, prec)
        x = rmsnorm(x, tree["final_norm"]["scale"], s.eps)
        return [prec.mm(x[b, list(pos)], tree["lm_head"])
                for b, pos in enumerate(positions)]
