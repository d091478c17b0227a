"""Plain Mamba1 language model: the forward of the port's equations, float32,
with a sequential scan.

Per layer: ``h = rmsnorm(x)``; ``u = h @ in_x``, ``z = h @ in_z``; a causal
depthwise conv of width ``d_conv`` over ``u`` (zero history) plus
``conv_b``, then SiLU; ``(dt_r, B, C) = u @ x_proj``; ``dt =
softplus(dt_r @ dt_proj + dt_bias)``; ``A = -exp(A_log)``; the recurrence
``h[t] = exp(dt[t] A) h[t-1] + dt[t] u[t] B[t]``, ``y[t] = <h[t], C[t]>``
walked one step at a time; ``y = (y + D u) * silu(z)``; ``x = x +
y @ out_proj``.  Then a final RMSNorm and ``lm_head``.

Departures from FalconMamba as published (arXiv:2410.05355), which the port
shares: no RMSNorm on B, C and dt inside the mixer (``mixer_rms_eps``);
the port rounds the residual stream to bfloat16 between layers where the
published model keeps it in float32 (``residual_in_fp32``), and this
reference keeps every value in float32.

The weights are the harness's tree (bfloat16 and float32 leaves), each
layer's converted to float32 when it runs, so the model never sits in
float32 whole.  Only the logits of the positions asked for are formed.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision, exact

SCAN_CHUNK = 64


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """u: (B, T, C); w: (K, C): y[t] = sum_i w[i] u[t - K + 1 + i] + b."""
    K = w.shape[0]
    T = u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    y = b.float().expand_as(u).clone()
    for i in range(K):
        y = y + up[:, i:i + T] * w[i].float()
    return y


def sequential_scan(u, dt, Bm, Cm, A) -> torch.Tensor:
    """y (B, T, D) of the recurrence from a zero state, one step at a
    time; the decays and inputs of ``SCAN_CHUNK`` steps are formed at
    once."""
    Bsz, T, D = u.shape
    h = u.new_zeros((Bsz, D, A.shape[1]))
    ys = []
    for c0 in range(0, T, SCAN_CHUNK):
        c1 = min(T, c0 + SCAN_CHUNK)
        da = torch.exp(dt[:, c0:c1, :, None] * A)               # (B,c,D,N)
        bx = (dt[:, c0:c1] * u[:, c0:c1])[..., None] * Bm[:, c0:c1, None, :]
        hs = []
        for t in range(c1 - c0):
            h = da[:, t] * h + bx[:, t]
            hs.append(h)
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, 1),
                               Cm[:, c0:c1]))
    return torch.cat(ys, dim=1)


def layer(p: dict, s, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    q = p["ssm"]
    h = rmsnorm(x, p["ln"]["scale"], s.eps)
    u = prec.mm(h, q["in_x"])
    z = prec.mm(h, q["in_z"])
    u = F.silu(causal_conv(u, q["conv_w"], q["conv_b"]))
    proj = prec.mm(u, q["x_proj"])
    dt_r, Bm, Cm = torch.split(proj, [s.r, s.n, s.n], dim=-1)
    dt = F.softplus(prec.mm(dt_r, q["dt_proj"]) + q["dt_bias"].float())
    A = -torch.exp(q["A_log"].float())
    y = sequential_scan(u, dt, Bm, Cm, A)
    y = (y + q["D"].float() * u) * F.silu(z)
    return x + prec.mm(y, q["out_proj"])


@torch.no_grad()
def logits_at(tree: dict, s, tokens: torch.Tensor,
              positions: Sequence[Sequence[int]],
              prec: Precision = Precision()) -> List[torch.Tensor]:
    """Float32 logits (len(positions[b]), V) of row ``b`` of ``tokens``
    (B, L) at each of ``positions[b]``, for every row."""
    with exact():
        x = tree["embed"][tokens].float()
        for p in tree["blocks"]:
            x = layer(p, s, x, prec)
        x = rmsnorm(x, tree["final_norm"]["scale"], s.eps)
        return [prec.mm(x[b, list(pos)], tree["lm_head"])
                for b, pos in enumerate(positions)]
