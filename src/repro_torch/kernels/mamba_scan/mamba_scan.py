"""CUDA kernel for the Mamba1 selective scan: build, load and launch.

``csrc/mamba_scan.cu`` is built by ``kernels.nvcc.CudaLibrary`` (``nvcc``
for ``sm_90a``, a plain C interface, at first use, into ``build/`` beside
this file) and loaded with ``ctypes``.

``selective_scan_cuda`` is the wrapper: it checks its tensors, allocates the
two outputs, launches the kernel on PyTorch's current stream and counts the
launch in ``launches``.  It never falls back to another implementation: a
tensor the kernel does not take raises.  The plain version it is held to is
``ref.selective_scan_torch``.  The kernel is forward-only, as the Pallas
kernel is, so an input that requires grad raises.

The kernel gives each channel ``(b, d)`` 1, 2 or 4 threads (its layout),
each of which keeps ``N / layout`` of the channel's states in registers.
``layout_for`` picks the layout from the shape; ``layout=`` forces one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# kernel launches since import (or since a caller last reset it); a launch
# is counted only where the kernel was actually launched
launches = 0

STATE_SIZES = (4, 8, 16, 32)
# threads a channel; a layout of L gives each thread N / L states
LAYOUTS = (1, 2, 4)
# one warp on each of an H100's 132 x 4 schedulers, rounded down to a power
# of two: the threads a launch needs before a layout of more threads a
# channel would only add per-step work
WAVE_THREADS = 16384


def layout_for(B: int, D: int, N: int) -> int:
    """Threads a channel for a scan over ``B * D`` channels of ``N`` states:
    the fewest of ``LAYOUTS`` that make ``WAVE_THREADS`` threads, else the
    most (every N of ``STATE_SIZES`` splits 4 ways).  The library's
    ``repro_selective_scan_layout_for`` is the same rule."""
    for layout in LAYOUTS[:-1]:
        if B * D * layout >= WAVE_THREADS:
            return layout
    return LAYOUTS[-1]


_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 8)


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_selective_scan.argtypes = _ARGS + [ctypes.c_void_p]
    lib.repro_selective_scan.restype = ctypes.c_int
    lib.repro_selective_scan_layout.argtypes = _ARGS + [ctypes.c_int,
                                                        ctypes.c_void_p]
    lib.repro_selective_scan_layout.restype = ctypes.c_int
    lib.repro_selective_scan_layout_for.argtypes = [ctypes.c_int] * 3
    lib.repro_selective_scan_layout_for.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu", "mamba_scan",
    _bind)


def _check(u, dt, Bm, Cm, A, h0) -> None:
    named = (("u", u), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A),
             ("h0", h0))
    for name, x in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad; the kernel is "
                             "forward-only")
    if u.dim() != 3:
        raise ValueError(f"u must be (B, T, D), got {tuple(u.shape)}")
    B, T, D = u.shape
    N = A.shape[-1]
    want = {"dt": (B, T, D), "Bm": (B, T, N), "Cm": (B, T, N), "A": (D, N),
            "h0": (B, D, N)}
    for name, x in named[1:]:
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(x.shape)}, want "
                             f"{want[name]}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} is not one of {STATE_SIZES}")
    for name, x in named[:4]:
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    for name, x in named[4:]:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B > 65535 or T >= 2 ** 31 or D * N >= 2 ** 31:   # the grid's limits
        raise ValueError(f"u {tuple(u.shape)} is too large for the kernel")
    for name, x in named:
        if x.device.type != "cuda" or x.device != u.device:
            raise ValueError(f"selective_scan_cuda needs CUDA tensors on one "
                             f"device, got {name} on {x.device}")


def selective_scan_cuda(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                        layout: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, D), hT (B, D, N)) of f32 CUDA tensors u, dt (B, T, D), Bm,
    Cm (B, T, N), A (D, N) and h0 (B, D, N), on the current stream, without
    synchronising.  u, dt, Bm and Cm may be strided views whose last dim is
    contiguous.  An empty input launches nothing; with T == 0, hT is a copy
    of h0.  ``layout``, one of ``LAYOUTS``, forces the threads a channel, to
    time the layouts against each other; by default ``layout_for`` picks
    it."""
    global launches
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout {layout} is not one of {LAYOUTS}")
    _check(u, dt, Bm, Cm, A, h0)
    B, T, D = u.shape
    N = A.shape[1]
    y = torch.empty((B, T, D), dtype=torch.float32, device=u.device)
    if T == 0:
        return y, h0.clone()
    hT = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    if hT.numel() == 0:
        return y, hT
    lib = LIBRARY.load()
    strides = [s for x in (u, dt, Bm, Cm) for s in x.stride()[:2]]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.repro_selective_scan_layout(
            *(x.data_ptr() for x in (u, dt, Bm, Cm, A, h0, y, hT)),
            B, T, D, N, *strides,
            layout_for(B, D, N) if layout is None else layout, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return y, hT
