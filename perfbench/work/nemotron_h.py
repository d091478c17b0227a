"""Nemotron-H's model FLOPs from shapes (``families/nemotron_h.py``'s
sizes): a decoded token's, and a prefill's of whole prompts.

FLOPs count the matrix products of the model's equations, 2 m n k each,
as ``flops.py`` does; elementwise work (norms, the conv, the recurrence's
decays and its input outer product, the router's sigmoid, the combine) is
not counted.  A token, by block:

* Mamba2: the input projection of z, x, B, C and dt
  (2 d (2 d_in + 2 groups n + heads)), ``out_proj`` (2 d_in d) and the
  output contraction ``S C`` (2 d_in n);
* attention: the projections (2 d hd (2 heads + 2 kv_heads)), and the
  scores and weighted values over ``keys`` positions (2 x 2 heads hd keys);
* experts: the router (2 d E), the top-k experts (4 d ff each: two
  products, relu² has no gate) and the shared one (4 d ff_shared);

and the output head, 2 d V, where the token's logits are formed.  A
prompt of n tokens attends over its T (T + 1) / 2 causal pairs.
"""
from __future__ import annotations

from typing import Iterable


def mamba2_token(s) -> int:
    return (2 * s.d * (2 * s.d_in + 2 * s.groups * s.n + s.mamba_heads)
            + 2 * s.d_in * s.d + 2 * s.d_in * s.n)


def attn_token(s, keys: int) -> int:
    return 2 * s.d * s.hd * (2 * s.heads + 2 * s.kv_heads) \
        + 4 * s.heads * s.hd * keys


def moe_token(s) -> int:
    return 2 * s.d * s.experts + 4 * s.d * (s.top_k * s.ff
                                             + s.shared * s.ff_shared)


def _body(s, keys: int) -> int:
    per = {"mamba2": mamba2_token(s), "moe": moe_token(s)}
    return sum(attn_token(s, keys) if k == "attn" else per[k]
               for k in s.plan)


def token_flops(s, keys: int) -> int:
    """Model FLOPs of one token whose attention reads ``keys`` positions,
    with its logits formed."""
    return _body(s, keys) + 2 * s.d * s.vocab


def prompt_flops(s, prompt_lens: Iterable[int]) -> int:
    """Model FLOPs of a prefill of prompts of these lengths (no pads), the
    logits formed at each one's last position."""
    attn = sum(k == "attn" for k in s.plan)
    total = 0
    for n in prompt_lens:
        total += n * _body(s, 0) + attn * 4 * s.heads * s.hd \
            * n * (n + 1) // 2 + 2 * s.d * s.vocab
    return total
