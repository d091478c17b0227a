"""Jamba's model FLOPs a decoded token, from shapes (``families/jamba.py``'s
sizes).

FLOPs count the matrix products of the model's equations, 2 m n k each,
as ``flops.py`` does; elementwise work (norms, the conv, the recurrence's
decays, the combine) is not counted.  A token, by layer:

* Mamba1: ``in_x`` and ``in_z`` (2 x 2 d d_in), ``x_proj``
  (2 d_in (r + 2n)), ``dt_proj`` (2 r d_in), ``out_proj`` (2 d_in d) and
  the output contraction ``<h, C>`` (2 d_in n);
* attention: the projections (2 d hd (2 heads + 2 kv_heads)), and the
  scores and weighted values over ``keys`` positions (2 x 2 heads hd keys);
* a dense MLP: 6 d ff; a MoE: the router (2 d E) and the top-k experts
  (6 d ff each);

and the output head, 2 d V.  That is twice the token's active matrix
parameters, plus the attention over its keys.
"""
from __future__ import annotations

from perfbench.work.flops import mamba1_layer_token


def attn_token(s, keys: int) -> int:
    return 2 * s.d * s.hd * (2 * s.heads + 2 * s.kv_heads) \
        + 4 * s.heads * s.hd * keys


def ffn_token(s, ffn: str) -> int:
    if ffn == "moe":
        return 2 * s.d * s.experts + 6 * s.top_k * s.d * s.ff
    return 6 * s.d * s.ff


def token_flops(s, keys: int) -> int:
    """Model FLOPs of one token whose attention reads ``keys`` positions,
    with its logits formed."""
    return sum((attn_token(s, keys) if mixer == "attn"
                else mamba1_layer_token(s)) + ffn_token(s, ffn)
               for mixer, ffn in s.plan) \
        + 2 * s.d * s.vocab

