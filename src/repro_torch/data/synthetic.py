"""Deterministic synthetic token stream.

Stateless: batch ``i`` is a pure function of (seed, i), so resuming after a
failure needs only the step counter — the data-pipeline half of
checkpoint/restart is exact by construction.  Tokens follow a Zipf-ish
distribution with a next-token structure (affine hash chain) so small models
actually learn and loss decreases.

A copy of the JAX package's ``data/synthetic.py``, numpy operation for
operation, so both packages draw the same batches from the same seed.  The
embedding table of ``embeds_dim`` (a pure function of the seed, vocab x d:
545 M draws for qwen2-vl-7b) is drawn once a stream, where the reference
draws it again for every batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import mrope_position_ids


@dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_codebooks: int = 1
    embeds_dim: int = 0            # >0 -> emit embeddings instead of tokens
    mrope: bool = False


class SyntheticTokens:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        self._table = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed << 20) ^ step)
        shape = (c.batch_size, c.seq_len + 1)
        if c.n_codebooks > 1:
            shape = shape + (c.n_codebooks,)
        # structured stream: x_{t+1} = (a * x_t + b) % V with noise
        a = 31337 % c.vocab_size or 7
        x0 = rng.integers(0, c.vocab_size, (c.batch_size,) + shape[2:])
        toks = np.empty(shape, np.int64)
        toks[:, 0] = x0
        for t in range(1, shape[1]):
            nxt = (toks[:, t - 1] * a + 13) % c.vocab_size
            noise = rng.random(nxt.shape) < 0.1
            rand = rng.integers(0, c.vocab_size, nxt.shape)
            toks[:, t] = np.where(noise, rand, nxt)
        out: Dict[str, np.ndarray] = {}
        if c.embeds_dim:
            if self._table is None:
                emb_rng = np.random.default_rng(c.seed ^ 0xE)
                self._table = emb_rng.normal(
                    0, 0.02, (c.vocab_size, c.embeds_dim)).astype(np.float32)
            out["embeds"] = self._table[toks[:, :-1]]
            out["labels"] = toks[:, 1:].astype(np.int32)
        else:
            out["tokens"] = toks[:, :-1].astype(np.int32)
            out["labels"] = toks[:, 1:].astype(np.int32)
        if c.mrope:
            out["positions3"] = mrope_position_ids(c.batch_size, c.seq_len)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def for_model(cfg: ModelConfig, batch_size: int, seq_len: int,
              seed: int = 0) -> SyntheticTokens:
    return SyntheticTokens(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size,
        seed=seed, n_codebooks=cfg.n_codebooks,
        embeds_dim=0 if cfg.embed_inputs else cfg.d_model,
        mrope=cfg.mrope))
