"""Plain PyTorch version of the selective scan (Mamba1 S6 recurrence).

    h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * u[t]) * B[t]
    y[t] = <h[t], C[t]>            (the caller adds D * u)

Shapes: u, dt (B, T, D); Bm, Cm (B, T, N); A (D, N); h0 (B, D, N), all f32.
``selective_scan_torch`` walks T in order, as the JAX package's
``selective_scan_ref`` does; it is what the CUDA kernel
(``csrc/mamba_scan.cu``) is held to, and what the op runs for tensors on the
CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
