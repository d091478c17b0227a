"""Stub modality frontends.

A port of the JAX package's ``models/frontends.py``.  The ``[audio]`` and
``[vlm]`` configs are transformer backbones; their frontends are stubs that
only provide shape-correct inputs:

* qwen2-vl: the vision tower and merger are stubbed; a batch carries
  already-merged patch and text embeddings (B, T, d) and the 3-stream
  M-RoPE position ids (temporal, height, width);
* musicgen: EnCodec is stubbed; the LM consumes its 4 discrete codebook
  token streams directly (B, T, 4), the real MusicGen interface.

``mrope_position_ids`` is the reference's numpy, operation for operation.
The embeddings are drawn from a ``torch.Generator``, so they are not the
reference's ``jax.random`` draws; the token streams are numpy's, the
reference's own.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.device import Device, require_device
from repro_torch.models.config import ModelConfig


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


def synth_embeddings(gen: torch.Generator, batch: int, seq: int,
                     d: int) -> torch.Tensor:
    """(batch, seq, d) bf16 embeddings, N(0, 0.02^2), on the generator's
    device."""
    x = torch.randn((batch, seq, d), generator=gen, device=gen.device)
    return x.to(torch.bfloat16) * 0.02


def train_batch_stub(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """A concrete batch for smoke runs, on ``device``: K codebook token
    streams and labels, or frontend embeddings (``embed_inputs=False``) and
    labels, or tokens and labels; ``positions3`` for M-RoPE."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32)).to(dev)

    out: Dict[str, torch.Tensor] = {}
    if cfg.n_codebooks > 1:
        out["tokens"] = ints(batch, seq, cfg.n_codebooks)
        out["labels"] = ints(batch, seq, cfg.n_codebooks)
    elif not cfg.embed_inputs:
        gen = torch.Generator(device=dev).manual_seed(seed)
        out["embeds"] = synth_embeddings(gen, batch, seq, cfg.d_model)
        out["labels"] = ints(batch, seq)
    else:
        out["tokens"] = ints(batch, seq)
        out["labels"] = ints(batch, seq)
    if cfg.mrope:
        out["positions3"] = torch.from_numpy(
            mrope_position_ids(batch, seq)).to(dev)
    return out
