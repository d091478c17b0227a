"""Public op: the selective scan on the tensors' device.

``selective_scan`` dispatches on the device its tensors lie on: CUDA tensors
go to the kernel (``mamba_scan.selective_scan_cuda``) or raise, CPU tensors
to the plain PyTorch version (``ref.selective_scan_torch``).  Nothing falls
back from one to the other.  The kernel masks the ragged T and D itself, so
the JAX wrapper's padding to (128, 256) blocks has no counterpart here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.mamba_scan.mamba_scan import selective_scan_cuda
from repro_torch.kernels.mamba_scan.ref import selective_scan_torch


def selective_scan(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, T, D); Bm, Cm: (B, T, N); A: (D, N); h0: (B, D, N); all
    f32.  Returns (y (B, T, D), hT (B, D, N))."""
    if u.device.type == "cuda":
        return selective_scan_cuda(u, dt, Bm, Cm, A, h0)
    if u.device.type != "cpu":
        raise ValueError(f"no selective scan for {u.device}")
    return selective_scan_torch(u, dt, Bm, Cm, A, h0)
