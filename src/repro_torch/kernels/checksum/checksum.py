"""CUDA kernel for the streaming integrity hash: build, load and launch.

``csrc/checksum.cu`` is built by ``kernels.nvcc.CudaLibrary`` (``nvcc`` for
``sm_90a``, a plain C interface, at first use, into ``build/`` beside this
file) and loaded with ``ctypes``.

``fold_words_cuda`` is the wrapper: it checks its tensors, launches the
kernel on PyTorch's current stream and counts the launch in ``launches``.
It never falls back to another implementation: a tensor the kernel does not
take raises.  The plain version it is held to is ``ref.fold_words_torch``.

How a call is cut up (head, quads, tail and grid) is one rule, ``plan_for``
in the source; ``plan`` here mirrors it, and ``library_plan`` asks the
library for its own.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# kernel launches since import (or since a caller last reset it); a launch
# is counted only where the kernel was actually launched
launches = 0

# the constants of plan_for in csrc/checksum.cu
THREADS = 512
LOADS_BIG = 4
THREADS_PER_SM = 2048
PLAN_FIELDS = ("head", "n_quads", "tail", "threads", "blocks", "loads")


@dataclass(frozen=True)
class Plan:
    """One call's plan, the fields of ``Plan`` in csrc/checksum.cu."""
    head: int       # words before the first 16-byte boundary
    n_quads: int    # 16-byte quads after the head
    tail: int       # words after the quads
    threads: int    # a block
    blocks: int
    loads: int      # quads a thread a tile

    def block_quads(self, block: int) -> List[Tuple[int, int]]:
        """The ranges of quads ``[lo, hi)`` that ``block`` folds."""
        tile = self.threads * self.loads
        return [(base, min(base + tile, self.n_quads))
                for base in range(block * tile, self.n_quads,
                                  self.blocks * tile)]

    def pieces(self) -> List[Tuple[int, int]]:
        """Every range of words ``[lo, hi)`` the launch folds: the head and
        tail words (block 0's first threads) and each block's quads."""
        out = [(j, j + 1) for j in range(self.head)]
        body = self.head + 4 * self.n_quads
        out += [(body + j, body + j + 1) for j in range(self.tail)]
        for b in range(self.blocks):
            out += [(self.head + 4 * lo, self.head + 4 * hi)
                    for lo, hi in self.block_quads(b)]
        return out


def plan(n_words: int, ptr_mod_16: int, sms: int) -> Plan:
    """The plan ``plan_for`` in csrc/checksum.cu makes for ``n_words`` > 0
    words at an address of ``ptr_mod_16`` mod 16 on a card of ``sms``
    SMs."""
    if n_words <= 0:
        raise ValueError(f"a plan needs words, got n_words={n_words}")
    if ptr_mod_16 not in (0, 4, 8, 12):
        raise ValueError(f"words lie on 4-byte boundaries, got an address "
                         f"of {ptr_mod_16} mod 16")
    if sms < 1:
        raise ValueError(f"sms must be positive, got {sms}")
    head = min(n_words, ((16 - ptr_mod_16) & 15) >> 2)
    n_quads = (n_words - head) >> 2
    tail = n_words - head - 4 * n_quads
    wave = sms * (THREADS_PER_SM // THREADS)
    loads = 1 if n_quads <= wave * THREADS else LOADS_BIG
    blocks = max(1, min(-(-n_quads // (THREADS * loads)), wave))
    return Plan(head, n_quads, tail, THREADS, blocks, loads)


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_fold_words.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_fold_words.restype = ctypes.c_int
    lib.repro_fold_words_plan.argtypes = [ctypes.c_int64] * 3 + [
        ctypes.POINTER(ctypes.c_int64)]
    lib.repro_fold_words_plan.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "checksum.cu", "checksum",
    _bind)


def library_plan(n_words: int, ptr_mod_16: int, sms: int) -> Plan:
    """The library's own plan (``repro_fold_words_plan``), to hold against
    ``plan``."""
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    n = LIBRARY.load().repro_fold_words_plan(n_words, ptr_mod_16, sms, out)
    if n != len(PLAN_FIELDS):
        raise RuntimeError(f"the library's plan has {n} fields, expected "
                           f"{len(PLAN_FIELDS)}")
    return Plan(*out)


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
