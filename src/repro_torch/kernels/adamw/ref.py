"""Plain PyTorch versions of AdamW's two passes, the eager update op for op.

``sum_squares`` gives each leaf's sum of squares and their sum in leaf
order; ``update`` writes one leaf's new master, m and v in place and
returns its new bf16 params.  They are what the kernels of
``csrc/adamw.cu`` are held to, and what the op runs for tensors on the CPU
or the meta device.

A leaf is taken in slices of at most ``CHUNK`` elements, so that the f32
temporaries of eager PyTorch stay small beside a large leaf (a 262144 x
5376 embedding is 5.6 GB in f32).  Every operation of the update is
elementwise, so the slices give the whole leaf's numbers bit for bit; the
sum of squares of a larger leaf is summed slice by slice, which only
reorders that leaf's f32 sum.  The kernels make no temporaries and take no
slices.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

CHUNK = 1 << 26            # elements of a leaf taken at once


def _leaf_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of ``x``'s squares, a 0-d tensor."""
    if x.numel() <= CHUNK:
        return torch.sum(torch.square(x.float()))
    x = x.reshape(-1)
    return sum(torch.sum(torch.square(x[i:i + CHUNK].float()))
               for i in range(0, x.numel(), CHUNK))


def sum_squares(xs: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(each leaf's sum of squares; their sum, added in leaf order)."""
    sums = [_leaf_sum(x) for x in xs]
    return sums, sum(sums)


def update(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor, scale, lr, b1c, b2c, b1: float, b2: float,
           eps: float, weight_decay: float) -> torch.Tensor:
    """One leaf's update: the master p, m and v (f32) written in place;
    returns the new params in bf16."""
    new = torch.empty(p.shape, dtype=torch.bfloat16, device=p.device)
    g = g.reshape(-1)
    flat = [x.view(-1) for x in (p, m, v, new)]
    for i in range(0, g.numel(), CHUNK):
        p_, m_, v_, new_ = (x[i:i + CHUNK] for x in flat)
        g_ = g[i:i + CHUNK].float() * scale
        m_.copy_(b1 * m_ + (1 - b1) * g_)
        v_.copy_(b2 * v_ + (1 - b2) * g_ * g_)
        mh = m_ / b1c
        vh = v_ / b2c
        p_.copy_(p_ - lr * (mh / (torch.sqrt(vh) + eps)
                            + weight_decay * p_))
        new_.copy_(p_.to(torch.bfloat16))
    return new
