"""Faults planted underneath the timed path, for the checks that a broken
run comes out not correct: on the CPU in the tests
(``tests/test_perfbench_faults.py``) and at a cell's own size on the card
(``calibrate.py --fault``), where their readings set upper limits.

Each planter takes ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patches.setattr``) and breaks one thing:
a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced.
"""
from __future__ import annotations

import torch


def fold_nothing(patch):
    from repro_torch.core import integrity

    def fold(words, start_word=0, acc=None):
        return acc if acc is not None else torch.zeros(1, dtype=torch.int32)
    patch(integrity, "fold_words", fold)


def verify_half(patch):
    from repro_torch.core.integrity import Manifest
    verify = Manifest.verify_many

    def half(self, root, rels=None, device="cuda"):
        return verify(self, root, sorted(self.entries)[::2], device)
    patch(Manifest, "verify_many", half)


def verdict_flipped(patch):
    from repro_torch.core.integrity import Manifest
    verify = Manifest.verify_many

    def flipped(self, root, rels=None, device="cuda"):
        rep = verify(self, root, rels, device)
        first = sorted(rep)[0]
        rep[first] = dict(rep[first], ok=not rep[first]["ok"])
        return rep
    patch(Manifest, "verify_many", flipped)


def decode_keeps_state(patch):
    from repro_torch.models.model import LM
    decode = LM.decode_step

    def stale(self, cache, token, t):
        logits, _ = decode(self, cache, token, t)
        return logits, cache
    patch(LM, "decode_step", stale)


def token_altered(patch):
    from repro_torch.serve.engine import Engine

    def altered(self, logits):
        return torch.argmin(logits, dim=-1).reshape(self.B, -1).cpu().numpy()
    patch(Engine, "_greedy", altered)


def state_unchanged(patch):
    from repro_torch import tree as T
    from repro_torch.optim import adamw

    def unchanged(grads, state, lr, cfg=adamw.AdamWConfig()):
        params = T.tree_map(lambda p: p.to(torch.bfloat16), state.master)
        return params, state, {}
    patch(adamw, "update", unchanged)


def half_batch(patch):
    from repro_torch.models.model import LM
    loss_fn = LM.loss_fn

    def half(self, batch, aux_weight=0.01):
        return loss_fn(self, {k: v[:v.shape[0] // 2]
                              for k, v in batch.items()}, aux_weight)
    patch(LM, "loss_fn", half)


def loss_altered(patch):
    from repro_torch.models.model import LM
    loss_fn = LM.loss_fn

    def altered(self, batch, aux_weight=0.01):
        loss, parts = loss_fn(self, batch, aux_weight)
        return loss + 0.1, parts
    patch(LM, "loss_fn", altered)


FAULTS = {
    "audit-esgf-cmip6": (fold_nothing, verify_half, verdict_flipped),
    "serve-falcon-mamba-7b-prompts": (decode_keeps_state, token_altered),
    "serve-falcon-mamba-7b-chat": (decode_keeps_state, token_altered),
    "train-deepseek-v2-lite-16b": (state_unchanged, half_batch,
                                   loss_altered),
}


class Patches:
    """``setattr`` that remembers, and ``undo`` that restores."""

    def __init__(self):
        self._old = []

    def setattr(self, owner, name, value) -> None:
        self._old.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self._old:
            owner, name, value = self._old.pop()
            setattr(owner, name, value)
