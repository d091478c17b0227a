"""The layer plan (``models/model.py plan_stack``) of each of the six
layer patterns, and the trees the model builds by walking it.

The plans are written out as literals.  The digests pin, for a seed-0 f32
model on the CPU, every parameter leaf's path, shape, dtype and bytes (the
order of the draws and the parameter tree, ``None`` parts included) and
every cache leaf's path, shape and dtype.  They were computed from code
that spelled each layout out by hand, not from the plan, so they hold the
plan to the trees that checkpoints, sharding rules and the reference's
loaders already rely on.
"""
import hashlib
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.families import jamba  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import LM, Layer, plan_stack  # noqa: E402
from test_torch_jamba import SMALL  # noqa: E402


def jamba_config(**over):
    """Jamba2-Mini's configuration file read into the port's config, with
    ``over`` in place of its keys."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "jamba2-mini.json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return jamba.model_config(cfg)


def config(name):
    """The smoke config of a registry arch, Jamba cut to ``SMALL`` (its
    published widths draw 52 GB), or an arch cut to ``@n`` layers."""
    if name == "jamba2-mini":
        return jamba_config(**SMALL)
    arch, _, n = name.partition("@")
    cfg = get_config(arch).smoke()
    return cfg.with_(n_layers=int(n)) if n else cfg


def _blocks(n, mixer, ffn, **kw):
    """n layers under ``blocks``, each caching at its own place."""
    out = []
    for i in range(n):
        f = ffn(i) if callable(ffn) else ffn
        m = mixer(i) if callable(mixer) else mixer
        out.append(Layer(("blocks", i), m, f, None, ("blocks", i), None,
                         **kw))
    return out


LOCAL = [Layer(("groups", 0, "local", j), "attn", "mlp", 16,
               ("groups", 0, "local", j), 16, False) for j in range(5)]

PLANS = {
    "smollm-135m": _blocks(4, "attn", "mlp", positions3=True),
    "deepseek-v2-lite-16b": [
        Layer(("lead", 0), "mla", "dense", None, ("lead", 0), None, True),
        Layer(("blocks", 0), "mla", "moe", None, ("blocks", 0), None, True),
        Layer(("blocks", 1), "mla", "moe", None, ("blocks", 1), None, True),
        Layer(("blocks", 2), "mla", "moe", None, ("blocks", 2), None, True)],
    "falcon-mamba-7b": _blocks(4, "mamba1", None, positions3=False),
    "gemma3-27b": LOCAL + [
        Layer(("groups", 0, "global"), "attn", "mlp", None,
              ("groups", 0, "global"), None, False)],
    "zamba2-1.2b": [
        Layer(("groups", 0, 0), "mamba2", None, None, ("groups", 0, 0),
              None, False),
        Layer(("groups", 0, 1), "mamba2", None, None, ("groups", 0, 1),
              None, False),
        Layer(("shared",), "attn", "mlp", None, ("shared", 0), None, False),
        Layer(("groups", 1, 0), "mamba2", None, None, ("groups", 1, 0),
              None, False),
        Layer(("groups", 1, 1), "mamba2", None, None, ("groups", 1, 1),
              None, False),
        Layer(("shared",), "attn", "mlp", None, ("shared", 1), None, False)],
    # the published 16-layer cut: attention at 4 and 12, experts at odd i
    "jamba2-mini": _blocks(
        16, lambda i: "attn" if i % 8 == 4 else "mamba1",
        lambda i: "moe" if i % 2 else "mlp", positions3=False),
}
RECURRENT = {"falcon-mamba-7b"}
MAMBA1 = {"falcon-mamba-7b": 4, "jamba2-mini": 14}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_plan_of_each_pattern(name):
    cfg = (jamba_config() if name == "jamba2-mini"
           else get_config(name).smoke())
    plan = plan_stack(cfg)
    assert [tuple(layer) for layer in plan.layers] == \
        [tuple(layer) for layer in PLANS[name]]
    assert plan.recurrent == (name in RECURRENT)
    assert plan.mamba1 == MAMBA1.get(name, 0)


# (parameters with their bytes, cache without), digests of ``_digest``
DIGESTS = {
    "smollm-135m": ("62d075a719e2a490", "be9e42e2cf7ec8c6"),
    "deepseek-v2-lite-16b": ("a7869ab5e595acad", "5bf76711f6bc2700"),
    "falcon-mamba-7b": ("3a736d9c7d6440bc", "c1477687ba83e1be"),
    "gemma3-27b": ("cba1d90e96621519", "705a1e8b090f8677"),
    "zamba2-1.2b": ("b01fd60239ccb827", "97e1b0fd55cc4868"),
    "jamba2-mini": ("54b35023e8da559e", "9d61429e8c250b20"),
    # a tail; a tail behind two groups; no group, the shared block drawn
    "gemma3-27b@8": ("32d54a8b4041cdf1", "9c12ef38f7f3ea04"),
    "zamba2-1.2b@5": ("f1629872252fe443", "98564b83e34fe9e5"),
    "zamba2-1.2b@1": ("b3cd3805f3b9ae76", "7562aca7be15d249"),
}


def _walk(node, path=""):
    """(path, leaf) of a tree in sorted key order, a NamedTuple's fields
    under its type's name, and (path, None) for a None part."""
    if node is None:
        yield path, None
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], f"{path}/{k}")
    elif isinstance(node, list):
        for i, x in enumerate(node):
            yield from _walk(x, f"{path}/{i}")
    elif isinstance(node, tuple):
        for f, x in zip(node._fields, node):
            yield from _walk(x, f"{path}/{type(node).__name__}.{f}")
    else:
        yield path, node


def _digest(tree, values: bool) -> str:
    h = hashlib.sha256()
    for path, leaf in _walk(tree):
        if leaf is None:
            h.update(f"{path} None;".encode())
            continue
        h.update(f"{path} {tuple(leaf.shape)} {leaf.dtype};".encode())
        if values:
            h.update(leaf.detach().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def models():
    made = {}

    def get(name):
        if name not in made:
            made[name] = LM(config(name), dtype=torch.float32, device="cpu",
                            seed=0)
        return made[name]
    return get


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_seeded_parameters_and_cache_are_as_before_the_plan(name, models):
    lm = models(name)
    assert (_digest(lm.params(), True),
            _digest(lm.init_cache(2, 8), False)) == DIGESTS[name]
    assert _digest(lm.parameter_tree(), True) == DIGESTS[name][0]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_a_prefill_returns_the_cache_tree_it_was_given(name, models):
    """The cache ``backbone`` builds has ``init_cache``'s paths and shapes
    (a conv state's dtype follows the model's, as a step gives it)."""
    lm = models(name)
    cfg = lm.cfg
    toks = torch.zeros((2, 5), dtype=torch.long)
    cache = lm.init_cache(2, 8)
    _, new = lm.prefill(toks, cache)
    shapes = [(p, None if x is None else tuple(x.shape))
              for p, x in _walk(cache)]
    assert [(p, None if x is None else tuple(x.shape))
            for p, x in _walk(new)] == shapes, cfg.name
    _, step = lm.decode_step(new, toks[:, :1], 5)
    assert [(p, None if x is None else tuple(x.shape))
            for p, x in _walk(step)] == shapes, cfg.name


@pytest.mark.parametrize("name,cut", [
    ("falcon-mamba-7b", lambda p: p["blocks"].pop()),
    ("zamba2-1.2b@5", lambda p: p.update(tail=None)),
    ("gemma3-27b", lambda p: p["groups"][0]["local"].pop()),
    ("deepseek-v2-lite-16b", lambda p: p.update(lead=None)),
    ("jamba2-mini", lambda p: p["blocks"].reverse()),
])
def test_a_tree_without_the_plans_layers_is_refused(name, cut, models):
    params = models(name).params()
    cut(params)
    with pytest.raises(ValueError, match="layers"):
        LM(config(name), dtype=torch.float32, device="cpu", params=params)
