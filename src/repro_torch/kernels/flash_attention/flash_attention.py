"""CUDA kernel for causal GQA flash attention: build, load and launch.

``csrc/flash_attention.cu`` is built by ``kernels.nvcc.CudaLibrary``
(``nvcc`` for ``sm_90a``, a plain C interface, at first use, into ``build/``
beside this file) and loaded with ``ctypes``.

``flash_attention_cuda`` is the wrapper: it checks its tensors, allocates
the output, launches the kernel on PyTorch's current stream and counts the
launch in ``launches``.  It never falls back to another implementation: a
tensor the kernel does not take raises.  The plain version it is held to is
``ref.attention_torch``.  The kernel is forward-only, as the Pallas kernel
is, so an input that requires grad raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# kernel launches since import (or since a caller last reset it); a launch
# is counted only where the kernel was actually launched
launches = 0

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.repro_flash_attention_fwd.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    "flash_attention", _bind)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad; the kernel is "
                             "forward-only")
    B, T, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, T) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if B > 65535 or H > 65535 or T >= 2 ** 31:     # the grid's limits
        raise ValueError(f"q {tuple(q.shape)} is too large for the kernel")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention_cuda needs CUDA tensors on one "
                             f"device, got {name} on {x.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q (B, T, H, hd) over k, v (B, T, Hkv, hd) on the
    current stream, without synchronising; a new contiguous (B, T, H, hd)
    output in q's dtype.  The inputs may be strided views whose head dim is
    contiguous.  An empty input launches nothing."""
    global launches
    _check(q, k, v, window)
    B, T, H, hd = q.shape
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, T, H, k.shape[2], hd, *strides,
            window or 0, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return out
