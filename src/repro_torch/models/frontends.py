"""Modality frontends: the M-RoPE position ids.

The JAX package's ``models/frontends.py`` stubs the qwen2-vl vision tower
and the musicgen codec.  The port keeps only the numpy ``mrope_position_ids``
that ``data/synthetic.py`` draws for M-RoPE configs, copied operation for
operation; the frontends themselves wait for the M-RoPE port (ROADMAP
Queue A, step 7).
"""
from __future__ import annotations

import numpy as np


def mrope_position_ids(batch: int, seq: int) -> np.ndarray:
    """Deterministic stand-in M-RoPE ids: a leading image patch grid followed
    by text (t = h = w advancing together), shape (3, B, T)."""
    grid = min(seq // 4, 256)
    side = max(1, int(np.sqrt(grid)))
    t = np.zeros((seq,), np.int32)
    h = np.zeros((seq,), np.int32)
    w = np.zeros((seq,), np.int32)
    n_img = side * side
    idx = np.arange(n_img)
    t[:n_img] = 0
    h[:n_img] = idx // side
    w[:n_img] = idx % side
    text = np.arange(seq - n_img, dtype=np.int32) + side
    t[n_img:] = text
    h[n_img:] = text
    w[n_img:] = text
    out = np.stack([t, h, w])[:, None, :]
    return np.broadcast_to(out, (3, batch, seq)).copy()
