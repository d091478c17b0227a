"""The port's mixed pattern (Jamba: Mamba1 and GQA mixers, dense and MoE
FFNs by a periodic schedule), its dropless experts, the Mamba1 dt/B/C norm
and attention without rotary embedding, held to the benchmark's plain
reference (``perfbench/reference/jamba_lm.py``) on the CPU, on seeded
random weights at a small Jamba: 8 layers (one period: 7 Mamba1 mixers, 1
attention mixer, 4 MoE and 4 dense FFNs), 4 experts top 2, d 128.

Tolerances, each with its reason:

* f32 parameters against the f32 reference: 1e-4, the same equations in
  float32, summed in other orders (the reference walks the scan one step at
  a time, the port's plain B3 and B4 in their own orders).
* bf16 parameters against the f32 reference: the logits' mean absolute
  error under 0.03 and their largest under 0.6.  The port rounds every
  product and the residual stream to bfloat16 (8 bits of mantissa, a step
  of 2^-8 relative) at each of ~6 products a layer over 8 layers: seen
  mean 0.013 and largest 0.37 on logits of magnitude up to ~4.  The same
  model with every product in float8 (the benchmark's control) reads a
  mean of 0.13, over four times the bound.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import weights  # noqa: E402
from perfbench.reference import jamba_lm  # noqa: E402
from perfbench.reference.precision import Precision  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import selective_scan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.config import ModelConfig, SSMConfig, option, \
    param_count  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

SMALL = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=8, mamba_d_state=8, mamba_dt_rank=8,
             num_experts=4, intermediate_size=64, vocab_size=256)
B, T = 2, 37


def _config(**over):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "jamba2-mini.json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def _f32(tree):
    return {k: _f32(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else [_f32(v) for v in tree] if isinstance(tree, list) \
        else tree.float()


@pytest.fixture(scope="module")
def small():
    """(the config file cut small, its sizes, the port's config, the bf16
    tree, its f32 copy, tokens, the reference's f32 logits)."""
    cfg = _config(**SMALL)
    s = weights.sizes(cfg)
    tree = weights.tree(cfg, 5, "cpu")
    t32 = _f32(tree)
    toks = torch.randint(0, s.vocab, (B, T),
                         generator=torch.Generator().manual_seed(1))
    want = torch.stack(jamba_lm.logits_at(t32, s, toks, [range(T)] * B))
    return cfg, s, weights.family(cfg).model_config(cfg), tree, t32, toks, \
        want


def test_the_schedule_is_one_period(small):
    _, s, mcfg, *_ = small
    assert mcfg.layer_plan() == tuple(s.plan)
    assert [m for m, _ in s.plan] == ["mamba1"] * 4 + ["attn"] + \
        ["mamba1"] * 3
    assert [f for _, f in s.plan] == ["mlp", "moe"] * 4
    assert LM(mcfg, device="meta").pattern.kind == "mixed"


def test_forward_f32_matches_the_reference(small):
    _, _, mcfg, _, t32, toks, want = small
    model = LM(mcfg, dtype=torch.float32, device="cpu",
               params=copy.deepcopy(t32))
    torch.testing.assert_close(model(toks), want, rtol=1e-4, atol=1e-4)


def test_forward_bf16_matches_the_reference(small):
    _, s, mcfg, tree, t32, toks, want = small
    got = LM(mcfg, dtype=torch.bfloat16, device="cpu",
             params=tree)(toks).float()
    err = (got - want).abs()
    assert err.mean() < 0.03 and err.max() < 0.6
    low = torch.stack(jamba_lm.logits_at(t32, s, toks, [range(T)] * B,
                                         Precision("fp8")))
    assert (low - want).abs().mean() > 4 * 0.03


def _f32_cache(cache):
    """The cache with its bf16 KV and conv leaves in float32, so that an f32
    model's keys are not rounded to bf16 on their way into it."""
    return {"blocks": [type(c)(*(x.float() for x in c))
                       for c in cache["blocks"]]}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_then_decode_through_the_mixed_cache(small, dtype):
    _, _, mcfg, tree, t32, toks, want = small
    if dtype == "f32":
        model = LM(mcfg, dtype=torch.float32, device="cpu",
                   params=copy.deepcopy(t32))
        cache = _f32_cache(model.init_cache(B, T + 3))
    else:
        model = LM(mcfg, dtype=torch.bfloat16, device="cpu", params=tree)
        cache = model.init_cache(B, T + 3)
    kinds = [type(c).__name__ for c in cache["blocks"]]
    assert kinds == ["Mamba1State"] * 4 + ["KVCache"] + ["Mamba1State"] * 3
    P = 20
    lg, cache = model.prefill(toks[:, :P], cache)
    got = [lg[:, 0]]
    for t in range(P, T):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        assert model.decode_path == "eager"
        got.append(lg[:, 0])
    got = torch.stack(got, 1).float()
    ref = want[:, P - 1:]
    if dtype == "f32":
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        err = (got - ref).abs()
        assert err.mean() < 0.03 and err.max() < 0.6


def test_identical_routings_are_all_served(small, log, profiling):
    """With the routers zeroed every token's softmax is flat and the stable
    top 2 is experts 0 and 1 for all of them: 2 x 37 tokens put 74
    routings on each, which the capacity dispatch (C = 48) would cut."""
    _, s, mcfg, _, t32, toks, _ = small
    zero = copy.deepcopy(t32)
    for b in zero["blocks"]:
        if "moe" in b:
            b["moe"]["router"].zero_()
    same = torch.full((B, T), 7)
    want = torch.stack(jamba_lm.logits_at(zero, s, same, [range(T)] * B))
    model = LM(mcfg, dtype=torch.float32, device="cpu",
               params=copy.deepcopy(zero))
    torch.testing.assert_close(model(same), want, rtol=1e-4, atol=1e-4)
    loads = [r.value for r in log if r.name == "moe.load"]
    assert loads == [[B * T, B * T, 0, 0]] * 4
    experts = [r for r in log if r.name == "moe.experts"]
    assert len(experts) == 4
    assert all(e.index == r.parent for e, r in zip(
        experts, [r for r in log if r.name == "moe.load"]))
    capped = mcfg.with_(moe=dataclasses.replace(mcfg.moe,
                                                capacity_factor=1.25))
    cut = LM(capped, dtype=torch.float32, device="cpu",
             params=copy.deepcopy(zero))(same)
    assert (cut - want).abs().max() > 1e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_grouped_experts_equal_the_loop(dtype, tol):
    """The card's path, three grouped products over the runs' ends (run
    here through the CPU's ``torch._grouped_mm``), gives the loop's
    outputs, an expert with no routing included.  bf16: each path rounds
    every product to bf16 (a step of 2^-8 relative), so the two may differ
    by a step on outputs of magnitude ~1."""
    g = torch.Generator().manual_seed(7)
    E, d, f = 4, 32, 48
    w = [(torch.randn(E, *shape, generator=g) * shape[0] ** -0.5).to(dtype)
         for shape in ((d, f), (d, f), (f, d))]
    load = [3, 0, 5, 2]
    rows = torch.randn(sum(load), d, generator=g).to(dtype)
    got = moe._grouped_mlp(rows, torch.tensor(load), *w)
    want = moe._looped_mlp(rows, load, *w)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert moe._grouped(SimpleNamespace(is_cuda=True, dtype=torch.bfloat16))
    assert not moe._grouped(rows)


def test_the_grouped_path_serves_the_model(small, log, profiling,
                                           monkeypatch):
    """The whole bf16 model through the grouped path equals the loop's
    within one bf16 step a product, and records each layer's load as a
    tensor on the device, read by no one during the step."""
    _, _, mcfg, tree, _, toks, _ = small
    model = LM(mcfg, dtype=torch.bfloat16, device="cpu", params=tree)
    want = model(toks).float()
    loop = [r.value for r in log if r.name == "moe.load"]
    monkeypatch.setattr(moe, "_grouped", lambda x: True)
    got = model(toks).float()
    loads = [r.value for r in log if r.name == "moe.load"][len(loop):]
    assert [x.tolist() for x in loads] == loop
    assert all(isinstance(x, torch.Tensor) for x in loads)
    assert (got - want).abs().mean() < 0.01


def _mamba1_before_the_norm(p, cfg, x, state=None):
    """``mamba1_block`` as it stood before the dt/B/C norm option, op for
    op (no sharding rules installed, so ``constrain`` is the identity)."""
    s = cfg.ssm
    Bsz, T_, d = x.shape
    dt_rank = max(1, d // 16)
    xz = x @ p["in_x"]
    z = x @ p["in_z"]
    xc, new_conv = SSM.causal_conv1d(xz, p["conv_w"], p["conv_b"],
                                     state.conv if state else None)
    xc = F.silu(xc.float())
    proj = (xc.to(x.dtype) @ p["x_proj"]).float()
    dt, B_, C_ = torch.split(proj, [dt_rank, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = state.h if state else xc.new_zeros((Bsz, s.expand * d, s.d_state),
                                            dtype=torch.float32)
    if T_ == 1 and state is not None:
        a = torch.exp(dt[:, 0, :, None] * A)
        h = a * h0 + (dt[:, 0] * xc[:, 0])[..., None] * B_[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, C_[:, 0])[:, None]
        hT = h
    else:
        y, hT = selective_scan(xc, dt, B_, C_, A.float(), h0)
    y = y + p["D"] * xc
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"], (new_conv, hT)


def test_mamba1_without_the_norm_is_unchanged():
    cfg = get_config("falcon-mamba-7b").smoke()
    assert not option(cfg.ssm, "dt_bc_norm")
    gen = torch.Generator().manual_seed(0)
    p = SSM.init_mamba1(gen, cfg, torch.bfloat16)
    assert not {"dt_norm", "b_norm", "c_norm"} & set(p)
    x = torch.randn((2, 12, cfg.d_model), generator=gen).bfloat16()
    y, st = SSM.mamba1_block(p, cfg, x, return_state=True)
    want, (conv, h) = _mamba1_before_the_norm(p, cfg, x)
    assert torch.equal(y, want) and torch.equal(st.conv, conv) \
        and torch.equal(st.h, h)
    x1 = torch.randn((2, 1, cfg.d_model), generator=gen).bfloat16()
    y1, st1 = SSM.mamba1_block(p, cfg, x1, st)
    want1, (conv1, h1) = _mamba1_before_the_norm(p, cfg, x1, st)
    assert torch.equal(y1, want1) and torch.equal(st1.conv, conv1) \
        and torch.equal(st1.h, h1)


def test_mamba1_with_the_norm_matches_the_reference(small):
    _, s, mcfg, _, t32, _, _ = small
    p = copy.deepcopy(t32["blocks"][0]["ssm"])
    gen = torch.Generator().manual_seed(2)
    for k in ("dt_norm", "b_norm", "c_norm"):    # scales other than 1
        p[k]["scale"] = 0.5 + torch.rand(p[k]["scale"].shape, generator=gen)
    h = torch.randn((2, 23, s.d), generator=gen)
    got, _ = SSM.mamba1_block(p, mcfg, h)
    want = jamba_lm.mamba(p, s, h, Precision())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    off = mcfg.with_(ssm=SSMConfig(version=1, d_state=s.n, d_conv=s.d_conv,
                                   expand=2))
    plain, _ = SSM.mamba1_block(p, off, h)
    assert (plain - want).abs().max() > 1e-2


def test_attention_without_rope_matches_the_reference(small):
    _, s, mcfg, _, t32, _, _ = small
    p = t32["blocks"][4]["attn"]
    h = torch.randn((2, 19, s.d), generator=torch.Generator().manual_seed(4))
    pos = torch.arange(19)[None].expand(2, 19)
    got, _ = L.attention(p, mcfg, h, pos)
    want = jamba_lm.attention(p, s, h, Precision())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the same fields in the base class, which rotates q and k
    roped = ModelConfig(**{f.name: getattr(mcfg, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    rope, _ = L.attention(p, roped, h, pos)
    assert (rope - want).abs().max() > 1e-2
    # decode over the KV cache, from the position the prefill reached
    cache = L.KVCache(torch.zeros(2, 24, s.kv_heads, s.hd),
                      torch.zeros(2, 24, s.kv_heads, s.hd))
    L.attention(p, mcfg, h[:, :18], pos[:, :18], cache, 0)
    last, _ = L.attention(p, mcfg, h[:, 18:], pos[:, 18:], cache, 18)
    torch.testing.assert_close(last, want[:, 18:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layers,billions", [(32, 51.57), (16, 26.05)])
def test_param_count_is_the_trees_numel(layers, billions):
    cfg = _config(num_hidden_layers=layers)
    mcfg = weights.family(cfg).model_config(cfg)
    total, active = param_count(mcfg)
    numel = sum(p.numel() for p in LM(mcfg, device="meta").parameters())
    assert total == numel
    assert round(total / 1e9, 2) == billions
    spec = sum(int(np.prod(shape)) for _, (shape, _, _) in
               weights.walk(weights.specs(cfg)))
    assert spec == numel
    # one of each MoE's 16 experts is 176.2 M parameters; 14 are idle
    assert total - active == layers // 2 * 14 * 3 * 4096 * 14336


def test_engine_serves_the_mixed_pattern_and_marks_its_steps(small, log):
    _, _, mcfg, tree, _, _, _ = small
    model = LM(mcfg, dtype=torch.bfloat16, device="cpu", params=tree)
    eng = Engine(mcfg, model=model, max_batch=2, max_seq=40, device="cpu")
    rng = np.random.default_rng(0)
    for n, new in ((5, 4), (9, 6)):
        eng.submit(rng.integers(0, mcfg.vocab_size, n), new)
    done = eng.run_to_completion()
    assert sorted(len(r.out_tokens) for r in done) == [4, 6]
    dec = [r for r in log if r.name == "engine.decode"]
    assert [(d.attrs["live"], d.attrs["t"]) for d in dec] == \
        [(2, 16), (2, 17), (2, 18), (1, 19), (1, 20)]
    assert all(r.attrs["graph"] == "eager" for r in log
               if r.name == "lm.decode_step")
    # no profiler: the dropless path recorded nothing
    assert not [r for r in log if r.name.startswith("moe.")]


@pytest.fixture
def log(monkeypatch):
    fresh = spans.LOG.__class__(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


@pytest.fixture
def profiling():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof
