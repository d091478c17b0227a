"""Model FLOPs from shapes: the matrix products of a model's equations,
2 m n k each; elementwise work (norms, activations, the scan's decays)
is not counted.

* Mamba1, a token in a layer: ``in_x`` and ``in_z`` (2 x 2 d d_in),
  ``x_proj`` (2 d_in (r + 2n)), ``dt_proj`` (2 r d_in), ``out_proj``
  (2 d_in d) and the scan's output contraction ``<h, C>`` (2 d_in n).
* MLA, a token: the projections ``wq``, ``w_dkv``, ``w_krope``, ``w_uk``,
  ``w_uv``, ``wo``; a sequence: the scores and the weighted values of the
  T (T + 1) / 2 query-key pairs the causal mask keeps
  (2 B H pairs (nope + rope + v)), as the kernel bounds count them.
* MoE, a token: the router (2 d E); every routing's expert (6 d ff); the
  shared experts (6 d ff x n_shared).  A dense layer's MLP: 6 d ff.
* The output head: 2 d V a position whose logits are formed.

A training step is three forwards (the backward's two products for every
forward one); activation recomputation is not model work.
"""
from __future__ import annotations

from typing import Optional


def mamba1_layer_token(s) -> int:
    return (4 * s.d * s.d_in + 2 * s.d_in * (s.r + 2 * s.n)
            + 2 * s.r * s.d_in + 2 * s.d_in * s.d + 2 * s.d_in * s.n)


def mamba1_forward(s, tokens: int, head_rows: int) -> int:
    """``tokens`` through every layer, logits at ``head_rows``
    positions."""
    return s.n_layers * tokens * mamba1_layer_token(s) \
        + 2 * s.d * s.vocab * head_rows


def mla_token(s) -> int:
    H = s.heads
    return 2 * (s.d * H * (s.nope + s.rope) + s.d * s.r + s.d * s.rope
                + s.r * H * s.nope + s.r * H * s.vd + H * s.vd * s.d)


def mla_moe_forward(s, batch: int, seq: int,
                    expert_rows: Optional[int] = None,
                    pairs: Optional[int] = None) -> int:
    """A forward of ``batch`` sequences of ``seq`` tokens with logits at
    every position.  ``expert_rows``: the rows the routed experts compute
    in each MoE layer, every routing (N K) by default; ``pairs``: the
    query-key pairs of a sequence, the causal ones by default."""
    N = batch * seq
    rows = N * s.top_k if expert_rows is None else expert_rows
    pairs = seq * (seq + 1) // 2 if pairs is None else pairs
    attn = N * mla_token(s) + 2 * batch * s.heads * pairs * (
        s.nope + s.rope + s.vd)
    dense = 6 * N * s.d * s.ff_dense
    moe = (2 * N * s.d * s.experts + 6 * rows * s.d * s.ff
           + 6 * N * s.d * s.ff * s.shared)
    n_moe = s.n_layers - s.n_lead
    return (s.n_layers * attn + s.n_lead * dense + n_moe * moe
            + 2 * N * s.d * s.vocab)


def mla_moe_train_step(s, batch: int, seq: int) -> int:
    return 3 * mla_moe_forward(s, batch, seq)
