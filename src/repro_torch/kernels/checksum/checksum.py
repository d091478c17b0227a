"""CUDA kernel for the streaming integrity hash: build, load and launch.

``csrc/checksum.cu`` is built by ``kernels.nvcc.CudaLibrary`` (``nvcc`` for
``sm_90a``, a plain C interface, at first use, into ``build/`` beside this
file) and loaded with ``ctypes``.

``fold_words_cuda`` is the wrapper: it checks its tensors, launches the
kernel on PyTorch's current stream and counts the launch in ``launches``.
It never falls back to another implementation: a tensor the kernel does not
take raises.  The plain version it is held to is ``ref.fold_words_torch``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# kernel launches since import (or since a caller last reset it); a launch
# is counted only where the kernel was actually launched
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_fold_words.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_fold_words.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "checksum.cu", "checksum",
    _bind)


def _check(words: torch.Tensor, acc: torch.Tensor) -> None:
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32 (the bit pattern of uint32 "
                        f"words), got {words.dtype}")
    if words.device.type != "cuda":
        raise ValueError(f"fold_words_cuda needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D tensor")
    if (acc.device != words.device or acc.dtype != torch.int32
            or acc.shape != (1,)):
        raise ValueError("acc must be a one-element int32 tensor on the "
                         "words' device")


def fold_words_cuda(words: torch.Tensor, start_word: int,
                    acc: torch.Tensor) -> torch.Tensor:
    """XOR the fold of ``words`` (global word offset ``start_word``) into
    ``acc`` on the current stream, without synchronising.  ``words`` is a
    contiguous 1-D int32 CUDA tensor; ``acc`` a one-element int32 tensor on
    the same device.  An empty ``words`` launches nothing (a grid of no
    blocks is an invalid launch; the fold of no words is 0)."""
    global launches
    _check(words, acc)
    n = words.numel()
    if n == 0:
        return acc
    lib = LIBRARY.load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.repro_fold_words(words.data_ptr(), n,
                                   start_word & 0xFFFFFFFF, acc.data_ptr(),
                                   stream)
    if err != 0:
        raise RuntimeError(f"fold_words kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return acc
