"""Plain PyTorch version of causal (optionally sliding-window) attention.

``attention_torch`` is what the CUDA kernel (``csrc/flash_attention.cu``) is
held to, and what the op runs for tensors on the CPU.  It takes the GQA
layout the model produces, q (B, T, H, hd) and k, v (B, T, Hkv, hd) with
H % Hkv == 0, and computes the JAX package's ``attention_ref`` (its
``ops.flash_attention(..., use_pallas=False)``): logits in f32 scaled by
hd^-1/2, the causal mask ``kpos <= qpos`` (and ``qpos - kpos < window``),
masked logits set to -1e30, a softmax over the keys and the output cast to
q's dtype.  Query head h reads KV head h // (H / Hkv), as the JAX wrapper's
``jnp.repeat`` of the KV heads gives; here the heads are grouped instead of
repeated.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, T, Hkv, hd) -> (B, T, H, hd) in q's
    dtype."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.float().reshape(B, T, Hkv, g, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * (hd ** -0.5)
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= (i - j) < window
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)
