"""The plain references held to the port on the CPU at a tiny size: the B1
hash bit for bit, the Mamba1 forward's logits, and the MLA + MoE loss, its
gradients and an AdamW step, all in float32 (the references import
nothing of the port; these tests do)."""
from __future__ import annotations

import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import weights  # noqa: E402
from perfbench.reference import b1_hash, mamba1_lm, mla_moe_lm  # noqa: E402


def _f32(tree):
    return {k: _f32(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else [_f32(v) for v in tree] if isinstance(tree, list) \
        else tree.float()


@pytest.mark.parametrize("n", [0, 1, 3, 4, 4097, 65539])
def test_b1_hash_equals_the_port(n):
    from repro_torch.kernels.checksum.ops import checksum_bytes
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert b1_hash.digest(data) == checksum_bytes(data, "cpu")


@pytest.mark.parametrize("family", ["mamba1", "mla_moe"])
def test_weight_tree_is_the_ports_layout(family):
    from repro_torch.models.model import LM
    name = {"mamba1": "serve-falcon-mamba-7b-prompts",
            "mla_moe": "train-deepseek-v2-lite-16b"}[family]
    cfg = tiny.cell(name).config
    mine = weights.tree(cfg, 3, "cpu")
    theirs = LM(weights.family(cfg).model_config(cfg),
                device="meta").params()
    got = {p: (tuple(x.shape), x.dtype) for p, x in weights.walk(mine)}
    want = {p: (tuple(x.shape), x.dtype) for p, x in weights.walk(theirs)}
    assert got == want
    again = weights.tree(cfg, 3, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(weights.walk(mine), weights.walk(again)))


def test_mamba1_reference_matches_the_port():
    from repro_torch.models.model import LM
    cfg = tiny.cell("serve-falcon-mamba-7b-prompts").config
    s = weights.sizes(cfg)
    tree = _f32(weights.tree(cfg, 5, "cpu"))
    tokens = torch.randint(0, s.vocab, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    model = LM(weights.family(cfg).model_config(cfg), dtype=torch.float32,
               device="cpu", params=copy.deepcopy(tree))
    want = model(tokens)
    got = mamba1_lm.logits_at(tree, s, tokens, [range(37), [0, 36]])
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], want[1, [0, 36]], rtol=1e-4,
                               atol=1e-4)


def test_mla_moe_reference_loss_grads_and_adamw_match_the_port():
    from repro_torch import tree as T
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    cfg = copy.deepcopy(tiny.cell("train-deepseek-v2-lite-16b").config)
    cfg["assumed"]["capacity_factor"] = 0.5          # routings are dropped
    s = weights.sizes(cfg)
    tree = _f32(weights.tree(cfg, 9, "cpu"))
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, s.vocab, (2, 17), generator=g)
    tokens, labels = ids[:, :-1], ids[:, 1:]
    model = LM(weights.family(cfg).model_config(cfg), dtype=torch.float32,
               device="cpu", params=copy.deepcopy(tree), remat=False)
    model.requires_grad_(True)
    loss, _ = model.loss_fn({"tokens": tokens, "labels": labels})
    leaves = T.leaves(model.parameter_tree())
    grads = torch.autograd.grad(loss, leaves)
    ref = mla_moe_lm.train(tree, s, [(tokens, labels)], dict(
        b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0),
        lambda step: 3e-4)
    loss = float(loss.detach())
    assert abs(ref["loss"][0] - loss) < 1e-5 * abs(loss)
    gtree = T.unflatten(model.parameter_tree(), list(grads))
    raw = {p: float(torch.linalg.vector_norm(x))
           for p, x in weights.walk(gtree)}
    assert raw.keys() == ref["raw_grad"].keys()
    for p, n in raw.items():
        assert abs(n - ref["raw_grad"][p]) <= 1e-4 * max(n, 1e-6), p
    state = adamw.init(model.params())
    _, state, _ = adamw.update(gtree, state, torch.tensor(3e-4),
                               adamw.AdamWConfig())
    start = dict(weights.walk(tree))
    change = {p: float(torch.linalg.vector_norm(x - start[p]))
              for p, x in weights.walk(state.master)}
    for p, n in change.items():
        assert abs(n - ref["change"][p]) <= 1e-3 * max(ref["change"][p],
                                                       1e-9), p


def test_capacity_drops_in_the_stable_order():
    s = weights.sizes(tiny.cell("train-deepseek-v2-lite-16b").config)
    assert mla_moe_lm.capacity(s, 10) == 8
    assert mla_moe_lm.capacity(s, 1000) == 312
