"""CUDA kernel for causal GQA flash attention: build, load and launch.

``csrc/flash_attention.cu`` is built by ``kernels.nvcc.CudaLibrary``
(``nvcc`` for ``sm_90a``, a plain C interface, at first use, into ``build/``
beside this file) and loaded with ``ctypes``.

``flash_attention_cuda`` is the wrapper: it checks its tensors, allocates
the output, launches the kernel on PyTorch's current stream and counts the
launch in ``launches`` and in ``launches_by_path``: bf16 goes to the
tensor-core kernel (``flash_fwd_wgmma_kernel``), f32 to the CUDA-core one
(``flash_fwd_kernel``).  It never falls back to another implementation: a
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

# kernel launches since import (or since a caller last reset them), in all
# and by kernel; a launch is counted only where the kernel was launched
launches = 0
launches_by_path = {"tensor_core": 0, "cuda_core": 0}

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's block shapes, (warpgroups, keys a tile) -> the C
# interface's shape index; 128-key tiles take one warpgroup at hd 32 and 64
# and two at hd 128
BLOCKS = {(1, 64): 0, (1, 128): 1, (2, 128): 2}


def blocks_for(hd: int) -> tuple:
    """The block shapes the library has for head dim ``hd``."""
    return ((1, 64), (2, 128)) if hd == 128 else ((1, 64), (1, 128))


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.repro_flash_attention_fwd.restype = ctypes.c_int
    lib.repro_flash_attention_fwd_block.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.repro_flash_attention_fwd_block.restype = ctypes.c_int
    lib.repro_flash_attention_block.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.repro_flash_attention_block.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    "flash_attention", _bind)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], block: Optional[tuple]) -> None:
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
        # the tensor-core kernel copies 16-byte chunks of a row
        if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or any(
                st % 8 for st, n in zip(x.stride()[:3], x.shape[:3])
                if n > 1)):
            raise ValueError(f"bf16 {name} needs a 16-byte aligned start and "
                             f"strides that are multiples of 8, got "
                             f"{x.stride()}")
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
    if block is not None and (q.dtype != torch.bfloat16
                              or tuple(block) not in blocks_for(hd)):
        raise ValueError(f"block {block} is not one of the bf16 kernel's "
                         f"{blocks_for(hd)} at head dim {hd}")
    if B > 65535 or H > 65535 or T >= 2 ** 31:     # the grid's limits
        raise ValueError(f"q {tuple(q.shape)} is too large for the kernel")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention_cuda needs CUDA tensors on one "
                             f"device, got {name} on {x.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None,
                         block: Optional[tuple] = None) -> torch.Tensor:
    """Causal attention of q (B, T, H, hd) over k, v (B, T, Hkv, hd) on the
    current stream, without synchronising; a new contiguous (B, T, H, hd)
    output in q's dtype.  The inputs may be strided views whose head dim is
    contiguous.  An empty input launches nothing.  ``block`` (warpgroups,
    keys a tile), one of ``blocks_for(hd)``, forces the bf16 kernel's block
    shape, to time the shapes against each other; by default the launch
    picks it."""
    global launches
    _check(q, k, v, window, block)
    B, T, H, hd = q.shape
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    shape = -1 if block is None else BLOCKS[tuple(block)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd_block(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, T, H, k.shape[2], hd, *strides,
            window or 0, hd ** -0.5, shape, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    launches_by_path["tensor_core" if q.dtype == torch.bfloat16
                     else "cuda_core"] += 1
    return out


def block_shape(hd: int, seq: int, window: Optional[int] = None,
                block: Optional[tuple] = None) -> dict:
    """The bf16 kernel's block of shape ``block`` (by default the one it
    launches for a call of head dim ``hd`` over ``seq`` tokens): warpgroups
    (64 query rows each), keys a tile, stages of the K/V ring and dynamic
    shared memory in bytes."""
    out = (ctypes.c_int * 4)()
    err = LIBRARY.load().repro_flash_attention_block(
        hd, seq, window or 0, -1 if block is None else BLOCKS[tuple(block)],
        out)
    if err != 0:
        raise ValueError(f"no block {block} at head dim {hd}")
    return dict(zip(("warpgroups", "keys_per_tile", "stages", "smem_bytes"),
                    out))
