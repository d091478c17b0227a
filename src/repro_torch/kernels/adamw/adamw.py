"""CUDA kernels for AdamW's elementwise work: build, load and launch.

``csrc/adamw.cu`` is built by ``kernels.nvcc.CudaLibrary`` (``nvcc`` for
``sm_90a``, a plain C interface, at first use, into ``build/`` beside
``csrc/``) and loaded with ``ctypes``.  Its kernels are the two passes of
an update: ``sum_squares_cuda`` (every leaf's sum of squares in f32, one
launch a leaf, then one launch that sums each leaf's partials and the
leaves in a fixed order) and ``update_cuda`` (each leaf's new master, m
and v written in place and its bf16 params, one launch a leaf).  Each
wrapper checks its tensors, allocates its outputs and scratch, launches on
PyTorch's current stream without synchronising and counts the launches:
``norm_launches``, ``finish_launches`` and ``launches`` (the update's).
They never fall back to another implementation: a tensor the kernels do
not take raises.  The plain versions they are held to are
``ref.sum_squares`` and ``ref.update``.

A gradient is bf16 (a step's own) or f32 (accumulated over microbatches),
a template of the kernels; the master, m and v are f32.  The update reads
its four scalars (the clip scale, lr and the two bias corrections) from 0-d
f32 tensors on the card, so no step waits for the host; they are checked
once an update, the leaves each.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary

# launches since import (or since a caller last reset them), each counted
# only where its kernel was actually launched: the update's, the norm's
# partial sums (one a leaf) and its finishing sum (one a norm)
launches = 0
norm_launches = 0
finish_launches = 0

GRADIENTS = (torch.bfloat16, torch.float32)
F32 = (torch.float32,)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_float
    lib.repro_adamw_norm_slots.argtypes = []
    lib.repro_adamw_norm_slots.restype = i
    lib.repro_adamw_sum_squares.argtypes = [p, i, i64, p, p]
    lib.repro_adamw_sum_squares.restype = i
    lib.repro_adamw_sum_finish.argtypes = [p, i, p, p]
    lib.repro_adamw_sum_finish.restype = i
    lib.repro_adamw_update.argtypes = [p, i] + [p] * 4 + [i64] + [p] * 4 \
        + [f] * 6 + [p]
    lib.repro_adamw_update.restype = i


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "adamw.cu", "adamw", _bind)


def _check_dtype(what: str, x: torch.Tensor, dtypes) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{what} must be one of {dtypes}, got {x.dtype}")


def _check_place(what: str, x: torch.Tensor, dev: torch.device) -> None:
    if x.device.type != "cuda" or x.device != dev:
        raise ValueError(f"{what} must lie on the card with the others, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_scalars(scalars, dev: torch.device) -> None:
    """``ValueError`` unless each of ``scalars`` (name, tensor) is a 0-d
    f32 tensor on ``dev``."""
    for what, x in scalars:
        if x.dim() != 0 or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{what} must be a 0-d float32 tensor on "
                             f"{dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")


def check_update(g, p, m, v, dev: torch.device) -> None:
    """``TypeError`` or ``ValueError`` unless ``update_cuda`` takes this
    leaf's tensors on ``dev``."""
    leaves = (("the gradient", g, GRADIENTS), ("the master", p, F32),
              ("m", m, F32), ("v", v, F32))
    for what, x, dtypes in leaves:
        _check_dtype(what, x, dtypes)
    for what, x, _ in leaves:
        _check_place(what, x, dev)
        if x.numel() != p.numel():
            raise ValueError(f"{what} has {x.numel()} elements, the master "
                             f"{p.numel()}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err}")


def sum_squares_cuda(xs: Sequence[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(each leaf's sum of squares, a 0-d f32 tensor each; their sum in leaf
    order) of contiguous bf16 or f32 leaves on one card.  The same leaves
    give the same sums from run to run."""
    global norm_launches, finish_launches
    if not xs:
        raise ValueError("sum_squares_cuda needs at least one leaf")
    for k, x in enumerate(xs):
        _check_dtype(f"leaf {k}", x, GRADIENTS)
    dev = xs[0].device
    for k, x in enumerate(xs):
        _check_place(f"leaf {k}", x, dev)
    lib = LIBRARY.load()
    slots = lib.repro_adamw_norm_slots()
    partials = torch.zeros(len(xs) * slots, dtype=torch.float32, device=dev)
    out = torch.empty(len(xs) + 1, dtype=torch.float32, device=dev)
    stream = _stream(xs[0])
    with torch.cuda.device(dev):
        for k, x in enumerate(xs):
            if x.numel() == 0:
                continue                 # its slots stay zero
            err = lib.repro_adamw_sum_squares(
                x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
                partials.data_ptr() + 4 * k * slots, stream)
            _launched(err, "sum of squares")
            norm_launches += 1
        _launched(lib.repro_adamw_sum_finish(
            partials.data_ptr(), len(xs), out.data_ptr(), stream),
            "sum of squares' finishing")
        finish_launches += 1
    return list(out[:-1].unbind()), out[-1]


def update_cuda(gs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
                ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
                b2c: torch.Tensor, b1: float, b2: float, eps: float,
                weight_decay: float) -> List[torch.Tensor]:
    """AdamW's update of each leaf, one launch a leaf that holds an
    element: the f32 masters ps and moments ms and vs are written in
    place; returns each leaf's new params, bf16 in its master's shape.  A
    gradient is bf16 or f32 with its master's number of elements; all
    contiguous on one card.  scale, lr, b1c and b2c are 0-d f32 tensors
    there, checked once for all the leaves; b1, b2, eps and weight_decay
    are rounded to f32 as PyTorch rounds a Python scalar, and 1 - b1 and
    1 - b2 are taken in double first, as Python takes them."""
    global launches
    if not ps:
        return []
    dev = ps[0].device
    scalars = (("scale", scale), ("lr", lr), ("b1c", b1c), ("b2c", b2c))
    check_scalars(scalars, dev)
    for g, p, m, v in zip(gs, ps, ms, vs, strict=True):
        check_update(g, p, m, v, dev)
    lib = LIBRARY.load()
    hyper = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    ptrs = [x.data_ptr() for _, x in scalars]
    stream = _stream(ps[0])
    outs = []
    with torch.cuda.device(dev):
        for g, p, m, v in zip(gs, ps, ms, vs):
            out = torch.empty(p.shape, dtype=torch.bfloat16, device=dev)
            outs.append(out)
            if p.numel() == 0:
                continue
            _launched(lib.repro_adamw_update(
                g.data_ptr(), int(g.dtype == torch.bfloat16),
                *(x.data_ptr() for x in (p, m, v, out)), p.numel(), *ptrs,
                *hyper, stream), "AdamW update")
            launches += 1
    return outs
