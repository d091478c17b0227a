"""CUDA kernel for the batched lane segment step: build, load and launch.

``csrc/lane_step.cu`` is built by ``kernels.nvcc.CudaLibrary`` (``nvcc`` for
``sm_90a``, a plain C interface, at first use, into ``build/`` beside this
file) and loaded with ``ctypes``.

``lane_step_cuda`` is the wrapper: it checks its tensors, allocates the five
outputs, launches the kernel on PyTorch's current stream and counts the
launch in ``launches``.  It never falls back to another implementation: a
tensor the kernel does not take raises.  The plain version it is held to is
``ref.lane_segment_step_torch``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# kernel launches since import (or since a caller last reset it); a launch
# is counted only where the kernel was actually launched
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_lane_step.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_void_p] * 6)
    lib.repro_lane_step.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "lane_step.cu", "lane_step",
    _bind)


def _check(inputs) -> None:
    bd = inputs[1]
    for name, x in zip(("t", "bytes_done", "rate", "bound"), inputs):
        if x.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if x.device.type != "cuda":
            raise ValueError(f"lane_step_cuda needs CUDA tensors, got {name} "
                             f"on {x.device}")
        if x.device != bd.device or x.shape != bd.shape:
            raise ValueError(f"{name} is {tuple(x.shape)} on {x.device}; "
                             f"bytes_done is {tuple(bd.shape)} on "
                             f"{bd.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lane_step_cuda(t: torch.Tensor, bytes_done: torch.Tensor,
                   rate: torch.Tensor, bound: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """(t_left, new_bytes, adv, moved, hit) of four contiguous float64 CUDA
    tensors of one shape, on the current stream, without synchronising.
    The four float outputs are views of one ``[4, *shape]`` buffer; ``hit``
    is ``torch.bool``.  An empty input launches nothing."""
    global launches
    inputs = (t, bytes_done, rate, bound)
    _check(inputs)
    floats = torch.empty((4,) + tuple(bytes_done.shape), dtype=torch.float64,
                         device=bytes_done.device)
    hit = torch.empty(bytes_done.shape, dtype=torch.bool,
                      device=bytes_done.device)
    n = bytes_done.numel()
    if n:
        lib = LIBRARY.load()
        with torch.cuda.device(bytes_done.device):
            stream = torch.cuda.current_stream(bytes_done.device).cuda_stream
            err = lib.repro_lane_step(*(x.data_ptr() for x in inputs), n,
                                      *(floats[k].data_ptr()
                                        for k in range(4)),
                                      hit.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"lane_step kernel launch failed with CUDA "
                               f"error {err}")
        launches += 1
    return floats[0], floats[1], floats[2], floats[3], hit
