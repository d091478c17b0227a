"""References for the batched lane segment step.

The function is ``advance_segment`` (``repro_torch.core.transport``): over
``[lane, row]`` float64, seconds to the next byte boundary at each row's
fair-share rate, whether the boundary lands inside the tick (``hit``), and
the resulting byte / active-time / flow updates.

Two implementations beside the CUDA kernel, all three bit-identical:
  * ``lane_segment_step_np``    — numpy, the trajectory contract's reference
    (the numpy lanes backend and the scalar engine run these expressions);
  * ``lane_segment_step_torch`` — plain PyTorch, any device; the CPU path of
    ``ops.lane_segment_step`` and the yardstick the kernel is held to on the
    card.

Each product and sum is its own rounded operation (no fused multiply-add),
``max(0, x)`` keeps a NaN ``x`` as numpy's ``np.maximum(0.0, x)`` does, and a
non-positive or NaN ``rate`` gives ``need = inf``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transport import advance_segment


def lane_segment_step_np(t, bytes_done, rate, bound):
    """(t_left, new_bytes, adv, moved, hit) over [lane, row] float64."""
    t = np.broadcast_to(np.asarray(t, np.float64), np.shape(bytes_done))
    return advance_segment(t, np.asarray(bytes_done, np.float64),
                           np.asarray(rate, np.float64),
                           np.asarray(bound, np.float64))


def lane_segment_step_torch(t: torch.Tensor, bytes_done: torch.Tensor,
                            rate: torch.Tensor, bound: torch.Tensor):
    """The same six expressions on float64 tensors of one shape and device.
    ``np.maximum(0.0, x)`` is ``x`` unless ``0.0 > x`` (so NaN and -0.0 pass
    through), which ``torch.where`` states exactly."""
    gap = bound - bytes_done
    ahead = torch.where(gap < 0, 0.0, gap)
    need = torch.where(rate > 0, ahead / rate, float("inf"))
    hit = need <= t
    adv = torch.where(hit, need, t)
    new_bytes = torch.where(hit, bound, bytes_done + rate * t)
    moved = rate * adv
    t_left = torch.where(hit, t - need, 0.0)
    return t_left, new_bytes, adv, moved, hit
