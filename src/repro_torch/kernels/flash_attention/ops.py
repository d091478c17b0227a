"""Public op: causal GQA flash attention on the tensors' device.

``flash_attention`` takes q (B, T, H, hd) and k, v (B, T, Hkv, hd), the
layout the model produces, and dispatches on the device the tensors lie on:
CUDA tensors go to the kernel (``flash_attention.flash_attention_cuda``) or
raise, CPU tensors to the plain PyTorch version (``ref.attention_torch``),
which autograd differentiates natively.  Nothing falls back from one to the
other; meta tensors (the dry run's shapes) take the plain version's shapes.
DTensors run this op on their local shards (``_sharded``, through
``kernels/local.py``), or raise where their placements do not split the
problem into whole ones.  Unlike the JAX wrapper, nothing is transposed
and no KV head is repeated: the kernel reads query head h's KV head
h // (H / Hkv) through its strides.

The kernel is forward-only and its launch is invisible to autograd, so on
the card an input that requires grad (training) goes through
``FlashAttention``, an ``autograd.Function``: its forward launches the
kernel on detached inputs; its backward recomputes the attention eagerly in
f32 (the masked softmax attention of ``ref.attention_torch``, which is
``layers.sdpa``'s non-prefix branch at positions arange(T)) and returns
``torch.autograd.grad`` of that.  The JAX package has no backward kernel
either: its gradient is ``jax.grad`` of its jnp attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import local
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_torch


class FlashAttention(torch.autograd.Function):
    """The kernel's forward, the eager attention's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return flash_attention_cuda(q.detach(), k.detach(), v.detach(),
                                    window)

    @staticmethod
    def backward(ctx, grad):
        needed = ctx.needs_input_grad[:3]
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_attention_eager_backward"):
            ins = [x.detach().requires_grad_(need)
                   for x, need in zip(ctx.saved_tensors, needed)]
            out = attention_torch(*ins, ctx.window)
            got = iter(torch.autograd.grad(
                out, [x for x in ins if x.requires_grad], grad))
        return (*(next(got) if need else None for need in needed), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal softmax(q k^T hd^-1/2) v over (B, T, H, hd) queries and
    (B, T, Hkv, hd) keys and values; output in q's dtype."""
    if local.is_dtensor(q):
        return _sharded(q, k, v, window)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, window)
        return flash_attention_cuda(q, k, v, window)
    if q.device.type not in ("cpu", "meta"):
        raise ValueError(f"no flash attention for {q.device}")
    return attention_torch(q, k, v, window)


def _sharded(q, k, v, window):
    """DTensor q, k, v: this op on every rank's shard.  On each mesh dim the
    three are split alike on the batch (dim 0) or the heads (dim 2, query
    and KV heads both evenly, so each shard keeps whole GQA groups), or
    replicated; any other placement raises."""
    local.check("flash_attention", (q, k, v),
                (("R",) * 3, ("S0",) * 3, ("S2",) * 3),
                "batch- or head-sharded alike")
    return local.run_local(flash_attention, (q, k, v), (q,), (window,))
