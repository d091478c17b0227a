"""Plain PyTorch version of the selective scan (Mamba1 S6 recurrence).

    h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * u[t]) * B[t]
    y[t] = <h[t], C[t]>            (the caller adds D * u)

Shapes: u, dt (B, T, D); Bm, Cm (B, T, N); A (D, N); h0 (B, D, N), all f32.
``selective_scan_torch`` walks T in order, as the JAX package's
``selective_scan_ref`` does; it is what the CUDA kernel
(``csrc/mamba_scan.cu``) is held to, and what the op runs for tensors on the
CPU.

Decode's single step (T == 1, a state given) is not a scan of one step:
``conv_step_torch`` and ``state_step_torch`` are the model's eager step, op
for op, which the two kernels of ``csrc/mamba_step.cu`` are held to.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def selective_scan_torch(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, D), hT (B, D, N))."""
    h = h0
    ys = []
    for t in range(u.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)               # (B, D, N)
        h = a * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    if not ys:
        return u.new_zeros(u.shape), h
    return torch.stack(ys, dim=1), h


# ------------------------------------------------- Mamba1's single decode step
def conv_step_torch(xz: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the depthwise causal conv and its SiLU, as the model's
    eager T == 1 step computes them: xz (B, 1, C), the state (B, K-1, C)
    (the last K-1 inputs), conv_w (K, C), conv_b (C,).  The taps are summed
    in f32 from zero, in order, then the bias; the sum is rounded to xz's
    dtype before the SiLU.  Returns (xc (B, 1, C) f32, xc in xz's dtype,
    the new state: the last K-1 inputs, in the dtype the concatenation of
    the state and xz promotes to)."""
    xp = torch.cat([state, xz], dim=1)                     # (B, K, C)
    y = torch.zeros(xz.shape, dtype=torch.float32, device=xz.device)
    for i in range(w.shape[0]):
        y = y + xp[:, i:i + 1, :].float() * w[i].float()
    y = y + b.float()
    xc = F.silu(y.to(xz.dtype).float())
    return xc, xc.to(xz.dtype), xp[:, 1:, :]


def state_step_torch(dt_low: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, dt_proj: torch.Tensor,
                     dt_bias: torch.Tensor, A_log: torch.Tensor,
                     D: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
                     h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One selective-state step, as the model's eager T == 1 step computes
    it: dt_low (B, 1, R), Bm, Cm (B, 1, N) (x_proj's output, or after its
    RMSNorms), dt_proj (R, C), dt_bias (C,), A_log (C, N), D (C,), xc
    (B, 1, C) f32 (the conv's SiLU), z (B, 1, C) and h (B, C, N) f32.

        dt = softplus(dt_low @ dt_proj + dt_bias)          (f32)
        h  = exp(dt * -exp(A_log)) * h + (dt * xc) * Bm
        y  = (<h, Cm> + D * xc) * silu(z)

    Returns (y (B, 1, C) in z's dtype, the new h (B, C, N) f32)."""
    dt = F.softplus(dt_low.float() @ dt_proj.float() + dt_bias)
    A = -torch.exp(A_log)                                  # (C, N)
    a = torch.exp(dt[:, 0, :, None] * A)                   # (B, C, N)
    h = a * h + (dt[:, 0] * xc[:, 0])[..., None] * Bm.float()[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm.float()[:, 0])[:, None]
    y = y + D * xc
    y = y * F.silu(z.float())
    return y.to(z.dtype), h
