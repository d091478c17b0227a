"""Public op: causal GQA flash attention on the tensors' device.

``flash_attention`` takes q (B, T, H, hd) and k, v (B, T, Hkv, hd), the
layout the model produces, and dispatches on the device the tensors lie on:
CUDA tensors go to the kernel (``flash_attention.flash_attention_cuda``) or
raise, CPU tensors to the plain PyTorch version (``ref.attention_torch``).
Nothing falls back from one to the other.  Unlike the JAX wrapper, nothing
is transposed and no KV head is repeated: the kernel reads query head h's
KV head h // (H / Hkv) through its strides.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_torch


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal softmax(q k^T hd^-1/2) v over (B, T, H, hd) queries and
    (B, T, Hkv, hd) keys and values; output in q's dtype."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, window)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for {q.device}")
    return attention_torch(q, k, v, window)
