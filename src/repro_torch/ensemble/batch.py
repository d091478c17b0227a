"""Segment-step backends for the lanes engine, plus batched fault draws.

The lanes engine's hot inner operation is ``advance_segment`` over
``[lane, row]`` float64 arrays.  Two interchangeable implementations:

* ``numpy`` — the bit-exact reference (``repro_torch.core.transport``'s own
  module function; the scalar engine runs the same expressions).
* ``torch`` — ``repro_torch.kernels.lane_step``: the host arrays are copied
  to ``device`` each tick, stepped there (the CUDA kernel on a card, the
  plain PyTorch version on the CPU) and copied back as numpy arrays.

Both are bit-identical: the kernel and the plain version make every product
and sum its own rounding, as numpy does, so the lane-0 gate holds on either.

``BatchedFaultInjector`` wraps N independent per-lane ``FaultInjector``
streams behind one dense-array call.  This is deliberately NOT a batched
RNG: the scalar engine's stream is a stateful ``numpy.random.Generator``
whose consumption order is part of the trajectory, so the batch must be N
real streams — the property test asserts draw-for-draw equality with N
solo injectors."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultInjector
from repro_torch.ensemble.lanes import SegmentFn, numpy_segment
from repro_torch.kernels.device import Device, require_device
from repro_torch.kernels.lane_step.ops import lane_segment_step

BACKENDS = ("numpy", "torch")


def torch_segment_fn(device: Device = "cuda") -> SegmentFn:
    """The lane-step op on ``device`` as a host-array segment function:
    float64 arrays for the four float outputs, ``bool`` for ``hit``."""
    dev = require_device(device)

    def segment(t, bytes_done, rate, bound):
        out = lane_segment_step(t, bytes_done, rate, bound, dev)
        return tuple(o.cpu().numpy() for o in out)
    return segment


def make_segment_fn(backend: str, device: Device = "cuda") -> SegmentFn:
    if backend == "numpy":
        return numpy_segment
    if backend == "torch":
        return torch_segment_fn(device)
    raise ValueError(f"unknown segment backend {backend!r}")


def backend_label(backend: str, device: Device) -> str:
    """``EnsembleResult.backend``: ``"numpy"`` or ``"torch:<device type>"``."""
    if backend == "torch":
        return f"torch:{require_device(device).type}"
    return backend


class BatchedFaultInjector:
    """N per-lane fault streams behind one dense-array draw.

    ``transient_marks(paths, nbytes)`` performs exactly one scalar
    ``FaultInjector.transient_marks`` call per lane — same draw order, same
    stream — and packs the jagged results into ``(marks[L, M], len[L])``
    with ``inf`` padding (``inf`` never matches a byte boundary)."""

    def __init__(self, seeds: Sequence[int], transient_per_tb: float = 0.15,
                 fragility_tail: float = 2.5):
        self.injectors = [FaultInjector(int(s),
                                        transient_per_tb=transient_per_tb,
                                        fragility_tail=fragility_tail)
                          for s in seeds]

    def __len__(self) -> int:
        return len(self.injectors)

    def transient_marks(self, paths: Sequence[str], nbytes: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        draws: List[List[float]] = [
            inj.transient_marks(p, int(b))
            for inj, p, b in zip(self.injectors, paths, nbytes)]
        lens = np.array([len(d) for d in draws], dtype=np.int64)
        m = int(lens.max()) if len(lens) else 0
        out = np.full((len(draws), max(1, m)), np.inf)
        for i, d in enumerate(draws):
            out[i, :len(d)] = d
        return out, lens
