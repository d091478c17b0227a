"""The least bytes of one call of dropless experts, from shapes: the
sizes of any family with ``d``, ``ff`` (an expert's width) and ``top_k``.

Each expert the call's routings touch has its three bf16 matrices
(3 d ff x 2 B) read once; the call's tokens have their bf16 inputs read
once and their outputs written once (2 x 2 d B a token).
"""
from __future__ import annotations

from typing import Iterable

NEEDS = ("d", "ff", "top_k")


def expert_bytes(s, load: Iterable[int]) -> int:
    """Least bytes of one dropless expert call whose routings per expert
    are ``load``: the touched experts' weights and the tokens' rows."""
    load = [int(n) for n in load]
    touched = sum(1 for n in load if n > 0)
    tokens = sum(load) // s.top_k
    return touched * 3 * s.d * s.ff * 2 + tokens * 4 * s.d
