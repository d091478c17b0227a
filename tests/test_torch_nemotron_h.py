"""The mixed pattern's blocks by a pattern string (Nemotron-H: Mamba2,
attention and MoE blocks of one sublayer each), Mamba2 with its inner
width from a head count and its gated norm a group, and the sigmoid router
with a selection bias over non-gated relu² experts, held to the
benchmark's plain reference (``perfbench/reference/nemotron_h_lm.py``) on
the CPU, on seeded random weights at a small Nemotron-H: the pattern
``MEM*EMEM*E`` (4 Mamba2, 4 MoE and 2 attention blocks), d 128, 8 experts
top 2 and a shared expert, Mamba2 of 4 heads of 16 in 2 groups, state 16,
chunk 8.

Tolerances, each with its reason:

* f32 parameters against the f32 reference: 1e-4, the same equations in
  float32, summed in other orders (the reference walks the recurrence one
  step at a time, the port runs the chunked SSD).
* bf16 parameters against the f32 reference: over the positions, the
  median of each position's largest logit error under 0.1 and the mean
  error under 0.04.  The port rounds every product and the residual
  stream to bfloat16 (a step of 2^-8 relative); that alone gives errors
  of ~0.03-0.04 on logits of magnitude up to ~4.  A near-tie in a top-2
  choice may also flip under that rounding; the configuration's routed
  experts (``assumed.routed_down_scale``, their ``w_down`` at 1/8 of
  1/sqrt(fan_in)) keep a flip's difference small as it runs on through
  the Mamba2 states and the attention of the row's later positions.  Seen
  over six seeds: medians 0.036-0.041, means 0.010-0.016, forward and
  decode alike.  The same model with every product in float8 (the
  benchmark's control) reads a median of 0.45-0.47, over four times the
  bound.
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
from perfbench.reference import nemotron_h_lm as ref  # noqa: E402
from perfbench.reference.precision import Precision  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.config import MoEConfig, option, \
    param_count  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

SMALL = dict(hidden_size=128, hybrid_override_pattern="MEM*EMEM*E",
             num_hidden_layers=10, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, mamba_num_heads=4,
             mamba_head_dim=16, n_groups=2, ssm_state_size=16, chunk_size=8,
             n_routed_experts=8, num_experts_per_tok=2,
             moe_intermediate_size=48, moe_shared_expert_intermediate_size=64,
             vocab_size=256)
B, T = 2, 40


def _config(**over):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "nemotron-3-nano-30b-a3b.json")) as f:
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
                         generator=torch.Generator().manual_seed(5))
    want = torch.stack(ref.logits_at(t32, s, toks, [range(T)] * B))
    return cfg, s, weights.family(cfg).model_config(cfg), tree, t32, toks, \
        want


def _bf16_errors(got, want):
    """(median over positions of the largest error, mean error)."""
    err = (got - want).abs()
    return float(err.amax(-1).median()), float(err.mean())


def test_the_blocks_follow_the_pattern(small):
    _, s, mcfg, *_ = small
    assert s.plan == ["mamba2", "moe", "mamba2", "attn", "moe"] * 2
    assert mcfg.layer_plan() == tuple(
        (None, k) if k == "moe" else (k, None) for k in s.plan)
    lm = LM(mcfg, device="meta")
    assert lm.plan.pattern.kind == "mixed" and not lm.plan.recurrent
    assert [type(m).__name__ for m in lm.blocks] == ["Sublayer"] * 10
    assert [sorted(b) for b in lm.params()["blocks"][:4]] == [
        ["ln", "ssm"], ["ln", "moe"], ["ln", "ssm"], ["attn", "ln"]]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_the_reference(small, dtype):
    _, s, mcfg, tree, t32, toks, want = small
    if dtype == "f32":
        model = LM(mcfg, dtype=torch.float32, device="cpu",
                   params=copy.deepcopy(t32))
        torch.testing.assert_close(model(toks), want, rtol=1e-4, atol=1e-4)
        return
    got = LM(mcfg, dtype=torch.bfloat16, device="cpu",
             params=tree)(toks).float()
    median, mean = _bf16_errors(got, want)
    assert median < 0.1 and mean < 0.04
    low = torch.stack(ref.logits_at(t32, s, toks, [range(T)] * B,
                                    Precision("fp8")))
    assert _bf16_errors(low, want)[0] > 4 * 0.1


def _f32_cache(cache):
    """The cache with its bf16 KV and conv leaves in float32, so that an f32
    model's keys are not rounded to bf16 on their way into it."""
    return {"blocks": [None if c is None else type(c)(*(x.float() for x in c))
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
    assert kinds == ["Mamba2State", "NoneType", "Mamba2State", "KVCache",
                     "NoneType"] * 2
    P = 21                    # 2 chunks and a ragged one of 5
    lg, cache = model.prefill(toks[:, :P], cache)
    got = [lg[:, 0]]
    for t in range(P, T):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        assert model.decode_path == "eager"
        got.append(lg[:, 0])
    got = torch.stack(got, 1).float()
    ref_ = want[:, P - 1:]
    if dtype == "f32":
        torch.testing.assert_close(got, ref_, rtol=1e-4, atol=1e-4)
    else:
        median, mean = _bf16_errors(got, ref_)
        assert median < 0.1 and mean < 0.04


def _moe_inputs(s, seed):
    g = torch.Generator().manual_seed(seed)
    E = s.experts
    p = {"router": torch.randn(s.d, E, generator=g) * s.d ** -0.5,
         "score_bias": torch.zeros(E),
         "w_up": torch.randn(E, s.d, s.ff, generator=g) * s.d ** -0.5,
         "w_down": torch.randn(E, s.ff, s.d, generator=g) * s.ff ** -0.5,
         "shared": {
             "w_up": torch.randn(s.d, s.ff_shared, generator=g) * s.d ** -0.5,
             "w_down": torch.randn(s.ff_shared, s.d, generator=g)
             * s.ff_shared ** -0.5}}
    return p, torch.randn(2, 13, s.d, generator=g)


def test_the_selection_bias_picks_and_the_scores_weigh(small):
    """A bias on two experts moves them into many tokens' top 2, while each
    chosen expert's weight is still its unbiased sigmoid score,
    renormalised over the two and times the scaling."""
    _, s, mcfg, *_ = small
    m = mcfg.moe
    p, h = _moe_inputs(s, 3)
    xf = h.reshape(-1, s.d)
    _, plain, aux = moe._routing(p, m, xf)
    p["score_bias"][[2, 5]] = 0.3
    top_w, top_i, _ = moe._routing(p, m, xf)
    assert float(aux) == 0.0
    moved = (top_i != plain).any(1).float().mean()
    assert 0.2 < moved < 1
    scores = torch.sigmoid(xf @ p["router"])
    chosen = torch.gather(scores, 1, top_i)
    torch.testing.assert_close(
        top_w, chosen / chosen.sum(-1, keepdim=True) * m.routed_scaling)
    assert m.routed_scaling == 2.5 and m.router_norm_topk
    # the whole layer, the loop's path, against the reference's experts
    got, _ = moe.moe_forward(p, mcfg, h)
    torch.testing.assert_close(got, ref.moe(p, s, h, Precision()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["loop", "grouped"])
def test_relu2_experts_match_the_reference(small, path, monkeypatch):
    """Non-gated experts, ``relu(h w_up)^2 w_down``, and the shared expert
    of its own width: the CPU's loop against the f32 reference (1e-5: the
    same products, summed in another order); the card's two grouped
    products (run here on the CPU's ``torch._grouped_mm``) against the
    loop, both in bf16 on the same inputs, so that both route alike: each
    rounds every product to bf16, a step of 2^-8 relative on outputs of
    magnitude up to ~5."""
    _, s, mcfg, *_ = small
    p, h = _moe_inputs(s, 4)
    if path == "loop":
        got, _ = moe.moe_forward(p, mcfg, h)
        torch.testing.assert_close(got, ref.moe(p, s, h, Precision()),
                                   rtol=1e-5, atol=1e-5)
        return
    pb = {k: v if k in ("router", "score_bias") else
          {kk: vv.bfloat16() for kk, vv in v.items()}
          if isinstance(v, dict) else v.bfloat16() for k, v in p.items()}
    want, _ = moe.moe_forward(pb, mcfg, h.bfloat16())
    monkeypatch.setattr(moe, "_grouped", lambda x: True)
    got, _ = moe.moe_forward(pb, mcfg, h.bfloat16())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=4e-2)


def test_grouped_relu2_products_equal_the_loop():
    g = torch.Generator().manual_seed(7)
    E, d, f = 4, 32, 48
    w_up = torch.randn(E, d, f, generator=g) * d ** -0.5
    w_down = torch.randn(E, f, d, generator=g) * f ** -0.5
    load = [3, 0, 5, 2]
    rows = torch.randn(sum(load), d, generator=g)
    got = moe._grouped_mlp(rows, torch.tensor(load), None, w_up, w_down)
    want = moe._looped_mlp(rows, load, None, w_up, w_down)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        want[:3], torch.square(F.relu(rows[:3] @ w_up[0])) @ w_down[0])


@pytest.mark.parametrize("norm", ["per group", "whole width"])
def test_mamba2_and_its_gated_group_norm_match_the_reference(small, norm):
    _, s, mcfg, _, t32, _, _ = small
    p = copy.deepcopy(t32["blocks"][0]["ssm"])
    gen = torch.Generator().manual_seed(2)
    p["norm"]["scale"] = 0.5 + torch.rand(s.d_in, generator=gen)
    for k in "xBC":                          # conv biases other than 0
        p[f"conv_{k}_b"] = 0.1 * torch.randn(p[f"conv_{k}_b"].shape,
                                             generator=gen)
    h = torch.randn((2, 19, s.d), generator=gen)
    want = ref.mamba2(p, s, h, Precision())
    if norm == "per group":
        got, _ = SSM.mamba2_block(p, mcfg, h)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert option(mcfg.ssm, "group_norm")
        return
    # the same widths with zamba2's norm over the whole width
    whole = mcfg.with_(ssm=SimpleNamespace(**{
        f.name: getattr(mcfg.ssm, f.name)
        for f in dataclasses.fields(mcfg.ssm)}))
    assert not option(whole.ssm, "group_norm")
    got, _ = SSM.mamba2_block(p, whole, h)
    assert (got - want).abs().max() > 1e-2


def _mamba2_three_convs(p, cfg, x, state=None):
    """``mamba2_block`` as it stood before the one conv over x|B|C, op for
    op: three convs, their states concatenated."""
    s = cfg.ssm
    Bsz, T_, d = x.shape
    d_in = s.expand * d
    H = d_in // s.headdim
    P, G, N = s.headdim, s.n_groups, s.d_state
    z = x @ p["in_z"]
    xx, xB, xC = x @ p["in_x"], x @ p["in_B"], x @ p["in_C"]
    dt_raw = (x @ p["in_dt"]).float()
    cs = state.conv if state is not None else None
    parts = (cs[..., :d_in], cs[..., d_in:d_in + G * N],
             cs[..., d_in + G * N:]) if cs is not None else (None,) * 3
    x_c, n_x = SSM.causal_conv1d(xx, p["conv_x_w"], p["conv_x_b"], parts[0])
    B_c, n_B = SSM.causal_conv1d(xB, p["conv_B_w"], p["conv_B_b"], parts[1])
    C_c, n_C = SSM.causal_conv1d(xC, p["conv_C_w"], p["conv_C_b"], parts[2])
    new_conv = torch.cat([n_x, n_B, n_C], dim=-1)
    xh = F.silu(x_c.float()).reshape(Bsz, T_, H, P)
    B_ = F.silu(B_c.float()).reshape(Bsz, T_, G, N)
    C_ = F.silu(C_c.float()).reshape(Bsz, T_, G, N)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = state.h if state is not None else torch.zeros(
        (Bsz, H, P, N), dtype=torch.float32)
    if T_ == 1 and state is not None:
        a = torch.exp(dt[:, 0] * A)
        rep = H // G
        bg = torch.repeat_interleave(B_[:, 0], rep, dim=1)
        cg = torch.repeat_interleave(C_[:, 0], rep, dim=1)
        h = a[..., None, None] * h0 + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, 0], xh[:, 0], bg)
        y = torch.einsum("bhpn,bhn->bhp", h, cg)[:, None]
        hT = h
    else:
        y, hT = SSM._ssd_chunked(xh, dt, B_, C_, A, h0, s.chunk)
    y = (y + p["D"][:, None] * xh).reshape(Bsz, T_, d_in)
    y = y * F.silu(z.float())
    y = SSM.rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    return y @ p["out_proj"], (new_conv, hT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zamba2_mamba2_is_the_three_convs(dtype):
    """One conv over x|B|C gives the three convs' numbers: bit for bit in
    bf16, the served dtype (the SiLU then reads each part as a contiguous
    f32 copy, as it did); in f32 the SiLU reads the parts as strided views
    of the one conv's output, where the CPU's vector and scalar loops may
    round the last bit apart (1e-6 on outputs of magnitude ~1)."""
    cfg = get_config("zamba2-1.2b").smoke()
    assert not option(cfg.ssm, "group_norm") \
        and not option(cfg.ssm, "mamba_heads")
    gen = torch.Generator().manual_seed(0)
    p = SSM.init_mamba2(gen, cfg, dtype)
    for k in "xBC":
        p[f"conv_{k}_b"] = (0.1 * torch.randn(p[f"conv_{k}_b"].shape,
                                              generator=gen)).to(dtype)
    x = torch.randn((2, 64, cfg.d_model), generator=gen).to(dtype)
    x1 = torch.randn((2, 1, cfg.d_model), generator=gen).to(dtype)
    y, st = SSM.mamba2_block(p, cfg, x, return_state=True)
    y1, st1 = SSM.mamba2_block(p, cfg, x1, st)
    want, (conv, h) = _mamba2_three_convs(p, cfg, x)
    want1, (conv1, h1) = _mamba2_three_convs(p, cfg, x1, st)
    tol = dict(rtol=0, atol=0) if dtype == torch.bfloat16 else \
        dict(rtol=1e-6, atol=1e-6)
    for a, b in ((y, want), (st.conv, conv), (st.h, h), (y1, want1),
                 (st1.conv, conv1), (st1.h, h1)):
        torch.testing.assert_close(a, b, **tol)


def test_a_ragged_last_chunk_is_the_same_recurrence():
    g = torch.Generator().manual_seed(1)
    Bz, T_, H, P, G, N = 2, 21, 4, 8, 2, 8
    xh = torch.randn(Bz, T_, H, P, generator=g)
    dt = F.softplus(torch.randn(Bz, T_, H, generator=g))
    B_, C_ = (torch.randn(Bz, T_, G, N, generator=g) for _ in range(2))
    A = -torch.rand(H, generator=g) - 0.5
    h0 = torch.randn(Bz, H, P, N, generator=g)
    y, h = SSM._ssd_chunked(xh, dt, B_, C_, A, h0, 8)
    y1, h1 = SSM._ssd_chunked(xh, dt, B_, C_, A, h0, 32)
    torch.testing.assert_close(y, y1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h1, rtol=1e-5, atol=1e-5)


def _softmax_moe_before(p, m, x):
    """The dropless softmax path as it stood before the sigmoid router and
    the relu² experts, op for op: softmax, stable top k, each expert's gated
    MLP on its run of the sorted routings, the f32 combine."""
    N, d = x.shape[0] * x.shape[1], x.shape[2]
    xf = x.reshape(N, d)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    top_i = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :m.top_k]
    top_w = torch.gather(probs, 1, top_i)
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rows = xf[order // m.top_k]
    outs, start = [], 0
    for e, n in enumerate(moe._count(flat, m.n_routed).tolist()):
        if n:
            r = rows[start:start + n]
            g = r @ p["w_gate"][e]
            u = r @ p["w_up"][e]
            outs.append((F.silu(g.float()) * u.float()).to(r.dtype)
                        @ p["w_down"][e])
            start += n
    y = torch.empty_like(rows)
    y[order] = torch.cat(outs)
    out = (y.float() * top_w.reshape(-1, 1)).reshape(N, m.top_k, d).sum(1)
    return out.to(x.dtype).reshape(x.shape)


def test_softmax_gated_experts_are_unchanged_with_the_options_off():
    m = MoEConfig(n_routed=4, top_k=2, n_shared=0, d_ff_expert=24,
                  capacity_factor=None, router_norm_topk=False)
    assert not option(m, "sigmoid_router") and not option(m, "relu2")
    assert option(m, "routed_scaling") == 1.0
    cfg = get_config("qwen3-moe-30b-a3b").smoke().with_(moe=m)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sorted(p) == ["router", "w_down", "w_gate", "w_up"]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    got, aux = moe.moe_forward(p, cfg, x)
    assert torch.equal(got, _softmax_moe_before(p, m, x))
    assert float(aux) > 0


def test_the_ssd_span_is_fine_and_carries_its_shapes(small, log):
    _, s, mcfg, _, t32, _, _ = small
    p = t32["blocks"][0]["ssm"]
    h = torch.randn(2, 16, s.d)
    SSM.mamba2_block(p, mcfg, h)
    assert not [r for r in log if r.name == "mamba2.ssd"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, st = SSM.mamba2_block(p, mcfg, h, return_state=True)
        SSM.mamba2_block(p, mcfg, h[:, :1], st)     # the step takes none
    (sp,) = [r for r in log if r.name == "mamba2.ssd"]
    assert sp.attrs == dict(B=2, T=16, H=4, P=16, N=16, G=2)


@pytest.mark.parametrize("layers,billions", [(52, 31.58), (26, 15.51)])
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
    # 122 of each MoE block's 128 experts are idle: two matrices each
    n_moe = sum(k == "moe" for k in weights.sizes(cfg).plan)
    assert total - active == n_moe * 122 * 2 * 2688 * 1856


def test_engine_serves_the_pattern_eagerly(small, log):
    _, _, mcfg, tree, _, _, _ = small
    model = LM(mcfg, dtype=torch.bfloat16, device="cpu", params=tree)
    eng = Engine(mcfg, model=model, max_batch=2, max_seq=40, device="cpu")
    rng = np.random.default_rng(0)
    for n, new in ((5, 4), (9, 6)):
        eng.submit(rng.integers(0, mcfg.vocab_size, n), new)
    done = eng.run_to_completion()
    assert sorted(len(r.out_tokens) for r in done) == [4, 6]
    steps = [r for r in log if r.name == "lm.decode_step"]
    assert len(steps) == 5 and all(
        r.attrs == {"graph": "eager", "mamba1_layers": 0} for r in steps)
    # no profiler: neither the SSD nor the experts recorded anything
    assert not [r for r in log if r.name.startswith(("moe.", "mamba2."))]


@pytest.fixture
def log(monkeypatch):
    fresh = spans.LOG.__class__(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh
