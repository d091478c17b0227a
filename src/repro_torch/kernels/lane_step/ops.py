"""Public op: the batched lane segment step on a device.

``lane_segment_step`` takes the ensemble engine's host arrays, broadcasts
``t`` to the rows' shape, copies each input as a contiguous float64 tensor
to ``device`` and dispatches on it: a CUDA device goes to the kernel
(``lane_step.lane_step_cuda``) or raises, the CPU to the plain PyTorch
version (``ref.lane_segment_step_torch``).  Nothing falls back from one to
the other.  The kernel masks its tail by the element count, so unlike the
TPU path no padding to (8, 128) tiles is made.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.device import Device, require_device
from repro_torch.kernels.lane_step.lane_step import lane_step_cuda
from repro_torch.kernels.lane_step.ref import lane_segment_step_torch


def lane_segment_step(t, bytes_done, rate, bound, device: Device = "cuda"
                      ) -> Tuple[torch.Tensor, ...]:
    """(t_left, new_bytes, adv, moved, hit) on ``device`` for [lane, row]
    float64 host arrays (``t`` may be any shape that broadcasts to
    ``bytes_done``'s)."""
    dev = require_device(device)
    shape = np.shape(bytes_done)
    with warnings.catch_warnings():
        # a broadcast view is read-only; its tensor is only ever read
        warnings.filterwarnings("ignore", message="The given NumPy array is "
                                "not writable")
        inputs = tuple(torch.from_numpy(np.asarray(a, np.float64)).to(dev)
                       .expand(shape).contiguous()
                       for a in (t, bytes_done, rate, bound))
    if dev.type == "cuda":
        return lane_step_cuda(*inputs)
    if dev.type != "cpu":
        raise ValueError(f"no lane segment step for {dev}")
    return lane_segment_step_torch(*inputs)
