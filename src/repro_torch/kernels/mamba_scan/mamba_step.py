"""CUDA kernels for Mamba1's single decode step: build, load and launch.

``csrc/mamba_step.cu`` is built by ``kernels.nvcc.CudaLibrary`` (``nvcc``
for ``sm_90a``, a plain C interface, at first use, into ``build/`` beside
``csrc/``) and loaded with ``ctypes``.  Its two kernels take the step's
pointwise work around the GEMVs: ``conv_step_cuda`` (the causal conv's
step and SiLU) and ``state_step_cuda`` (dt, the recurrence, the C
contraction, the D skip and the SiLU gate).  Each wrapper checks its
tensors, allocates its outputs, launches on PyTorch's current stream
without synchronising (so a CUDA graph captures it) and counts the launch:
``conv_launches`` and ``launches`` (the selective-state kernel's).  They
never fall back to another implementation: a tensor the kernels do not
take raises.  The plain versions they are held to are
``ref.conv_step_torch`` and ``ref.state_step_torch``.  Both are
forward-only: the step is decode's, under ``torch.no_grad``.

The activations' dtype T (bf16 or f32) is a template of the kernels; the
small inputs whose dtype varies at run time (dt_low, Bm and Cm: x_proj's
output or the f32 RMSNorms'; dt_bias, A_log and D: f32, or bf16 after an
optimizer step) are read by either.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# launches since import (or since a caller last reset them), each counted
# only where its kernel was actually launched: the selective-state kernel's
# and the conv step's
launches = 0
conv_launches = 0

STATE_SIZES = (4, 8, 16, 32)
MAX_TAPS = 8
# the dt ranks whose dt_proj tile and dt_low rows a block stages in 227 KB
# of shared memory (about 1,090 in f32), rounded down
MAX_RANK = 1024
ACTIVATIONS = (torch.bfloat16, torch.float32)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.repro_mamba_conv_step.argtypes = [p] * 7 + [i] * 4 + [i64] * 3 + [p]
    lib.repro_mamba_conv_step.restype = i
    lib.repro_mamba_state_step.argtypes = (
        [p] * 3 + [i] + [i64] * 3 + [p] * 4 + [i] + [p] * 5 + [i] * 5 + [p])
    lib.repro_mamba_state_step.restype = i


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "mamba_step.cu", "mamba_step",
    _bind)


def _on_one_card(name: str, tensors) -> None:
    dev = tensors[0][1].device
    for what, x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} needs CUDA tensors on one device, got "
                             f"{what} on {x.device}")


def _shape(what: str, x: torch.Tensor, want) -> None:
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{what} is {tuple(x.shape)}, want {tuple(want)}")


def _layout(named, rows: int) -> None:
    """The first ``rows`` tensors need a contiguous last dim, the rest to be
    contiguous; none may require grad."""
    for k, (what, x) in enumerate(named):
        if k < rows and x.stride(-1) != 1:
            raise ValueError(f"{what}'s last dim must be contiguous")
        if k >= rows and not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{what} requires grad; the kernel is "
                             "forward-only")


def check_conv(xz, state, w, b) -> None:
    """``TypeError`` or ``ValueError`` unless ``conv_step_cuda`` takes these
    tensors."""
    named = (("xz", xz), ("state", state), ("conv_w", w), ("conv_b", b))
    if xz.dtype not in ACTIVATIONS:
        raise TypeError(f"xz must be one of {ACTIVATIONS}, got {xz.dtype}")
    for what, x in named[1:]:
        if x.dtype != xz.dtype:
            raise TypeError(f"{what} is {x.dtype}, xz {xz.dtype}")
    if xz.dim() != 3 or xz.shape[1] != 1:
        raise ValueError(f"xz must be (B, 1, C), got {tuple(xz.shape)}")
    B, _, C = xz.shape
    K = w.shape[0]
    if not 2 <= K <= MAX_TAPS:
        raise ValueError(f"a conv of {K} taps; the kernel takes 2 to "
                         f"{MAX_TAPS}")
    _shape("state", state, (B, K - 1, C))
    _shape("conv_w", w, (K, C))
    _shape("conv_b", b, (C,))
    _layout(named, 2)
    _on_one_card("conv_step_cuda", named)


def check_state(dt_low, Bm, Cm, dt_proj, dt_bias, A_log, D, xc, z,
                h) -> None:
    """``TypeError`` or ``ValueError`` unless ``state_step_cuda`` takes
    these tensors."""
    named = (("dt_low", dt_low), ("Bm", Bm), ("Cm", Cm),
             ("dt_proj", dt_proj), ("dt_bias", dt_bias), ("A_log", A_log),
             ("D", D), ("xc", xc), ("z", z), ("h", h))
    act = z.dtype
    if act not in ACTIVATIONS:
        raise TypeError(f"z must be one of {ACTIVATIONS}, got {act}")
    if dt_proj.dtype != act:
        raise TypeError(f"dt_proj is {dt_proj.dtype}, z {act}")
    io = dt_low.dtype
    if io not in (act, torch.float32) or Bm.dtype != io or Cm.dtype != io:
        raise TypeError(f"dt_low, Bm and Cm are {io}, {Bm.dtype}, "
                        f"{Cm.dtype}: all {act} or all float32")
    par = A_log.dtype
    if par not in (torch.float32, torch.bfloat16) \
            or dt_bias.dtype != par or D.dtype != par:
        raise TypeError(f"dt_bias, A_log and D are {dt_bias.dtype}, {par}, "
                        f"{D.dtype}: all float32 or all bfloat16")
    for what, x in (("xc", xc), ("h", h)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {x.dtype}")
    if z.dim() != 3 or z.shape[1] != 1 or dt_proj.dim() != 2 \
            or A_log.dim() != 2:
        raise ValueError(f"z must be (B, 1, C), dt_proj (R, C) and A_log "
                         f"(C, N), got {tuple(z.shape)}, "
                         f"{tuple(dt_proj.shape)}, {tuple(A_log.shape)}")
    B, _, C = z.shape
    R, N = dt_proj.shape[0], A_log.shape[1]
    want = {"dt_low": (B, 1, R), "Bm": (B, 1, N), "Cm": (B, 1, N),
            "dt_proj": (R, C), "dt_bias": (C,), "A_log": (C, N), "D": (C,),
            "xc": (B, 1, C), "z": (B, 1, C), "h": (B, C, N)}
    for what, x in named:
        _shape(what, x, want[what])
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} is not one of {STATE_SIZES}")
    if not 0 < R <= MAX_RANK:
        raise ValueError(f"dt rank {R}; the kernel takes 1 to {MAX_RANK}")
    _layout(named, 3)
    _on_one_card("state_step_cuda", named)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err}")


def conv_step_cuda(xz: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xc (B, 1, C) f32, xc in T, the new state (B, K-1, C) in T) of one
    conv step: xz (B, 1, C) and the state (B, K-1, C) in T, bf16 or f32
    (their channels contiguous, any batch and row strides), conv_w (K, C)
    and conv_b (C,) in T, contiguous.  For f32, the second output is the
    first."""
    global conv_launches
    check_conv(xz, state, w, b)
    B, _, C = xz.shape
    K = w.shape[0]
    xc = torch.empty((B, 1, C), dtype=torch.float32, device=xz.device)
    bf16 = xz.dtype == torch.bfloat16
    xc_act = torch.empty_like(xz, memory_format=torch.contiguous_format) \
        if bf16 else xc
    new = torch.empty((B, K - 1, C), dtype=xz.dtype, device=xz.device)
    if xc.numel() == 0:
        return xc, xc_act, new
    lib = LIBRARY.load()
    with torch.cuda.device(xz.device):
        err = lib.repro_mamba_conv_step(
            *(x.data_ptr() for x in (xz, state, w, b, xc, xc_act, new)),
            int(bf16), B, C, K, xz.stride(0), state.stride(0),
            state.stride(1), _stream(xz))
    _launched(err, "conv step")
    conv_launches += 1
    return xc, xc_act, new


def state_step_cuda(dt_low: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, dt_proj: torch.Tensor,
                    dt_bias: torch.Tensor, A_log: torch.Tensor,
                    D: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
                    h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, 1, C) in T, the new h (B, C, N) f32) of one selective-state
    step.  T, bf16 or f32, is z's dtype and dt_proj's; dt_low (B, 1, R),
    Bm and Cm (B, 1, N) are all T or all f32, their last dim contiguous
    (views of x_proj's output are taken as they lie); dt_bias (C,), A_log
    (C, N) and D (C,) are all f32 or all bf16; xc (B, 1, C) and h are f32.
    All but dt_low, Bm and Cm are contiguous."""
    global launches
    check_state(dt_low, Bm, Cm, dt_proj, dt_bias, A_log, D, xc, z, h)
    act, io, par = z.dtype, dt_low.dtype, A_log.dtype
    B, _, C = z.shape
    R, N = dt_proj.shape[0], A_log.shape[1]
    y = torch.empty((B, 1, C), dtype=act, device=z.device)
    h_new = torch.empty((B, C, N), dtype=torch.float32, device=z.device)
    if y.numel() == 0:
        return y, h_new
    lib = LIBRARY.load()
    with torch.cuda.device(z.device):
        err = lib.repro_mamba_state_step(
            dt_low.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            int(io == torch.bfloat16), dt_low.stride(0), Bm.stride(0),
            Cm.stride(0),
            *(x.data_ptr() for x in (dt_proj, dt_bias, A_log, D)),
            int(par == torch.bfloat16),
            *(x.data_ptr() for x in (xc, z, h, y, h_new)),
            int(act == torch.bfloat16), B, C, N, R, _stream(z))
    _launched(err, "selective-state step")
    launches += 1
    return y, h_new
