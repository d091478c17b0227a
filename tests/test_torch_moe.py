"""The port's MLA and MoE against the JAX package's, on the CPU
(training: ``test_torch_moe_train.py``).

Smoke configs of deepseek-v2-lite-16b (MLA attention, one dense lead block,
MoE with shared experts) and qwen3-moe-30b-a3b (GQA with qk-norm, MoE),
with the JAX package's own parameters (``params_from_jax``) and inputs
seeded with numpy:

* ``mla_attention`` without a cache, and a prefill then decode steps
  through an f32 cache, within 1e-5 (f32), the cache's latent and rope key
  too;
* ``moe_forward`` at ``capacity_factor`` 1.25, where half the tokens are
  alike (as left-padding is in serving) and overflow their experts, and at
  8.0, where nothing is dropped: ``top_i`` equal, the kept routings equal to
  a plain per-expert count in token order, output and aux within 1e-5
  (f32); a tie takes the lower expert index first, as ``jax.lax.top_k``
  gives it;
* the LM in f32: logits, prefill, the caches and decode steps within 1e-4,
  and the serving engine's tokens equal;
* the LM in bf16, block by block on the reference's input to each block:
  its MoE routing equal, its aux loss within 1e-3, and its output within
  ``tests/test_models.py``'s rtol (0.05) and an atol of two bf16 steps at
  the output's largest magnitude (the residual sum ``x + attn`` rounds at
  that scale: an attention value one step apart, where ``x`` nearly
  cancels it, leaves a small sum 0.25 off at magnitude 50);
* the whole LM in bf16: every ``top_i`` that either package routes in the
  forward, the prefill and each decode step equal first (on tokens whose
  routing does not flip: the frameworks round a few bf16 attention outputs
  one step apart, and a near-tied router then picks another expert for
  that token), then the logits, prefill and decode within
  ``tests/test_models.py``'s bf16 tolerances;
* prefill and decode consistent with the port's own forward in f32 with
  drop-free capacity, as ``tests/test_models.py`` checks the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.model import LM
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import Engine

ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"]
B, T_, K = 2, 32, 4            # batch, sequence, decode steps
S = T_ + 8                     # cache length
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_RTOL = 0.05                           # tests/test_models.py, prefill
BF16_STEPS = 2 * 2.0 ** -8                 # two bf16 steps, relative
# tests/test_models.py's bf16 tolerances, prefill and decode
BF16_TOL = {"forward": dict(atol=0.12, rtol=0.05),
            "prefill": dict(atol=0.12, rtol=0.05),
            "decode": dict(atol=0.5, rtol=0.03)}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _port_tree(tree, dtype=torch.float32):
    """A JAX parameter mapping as the port's (the f32 router kept f32)."""
    return {k: _port_tree(v, dtype) if isinstance(v, dict)
            else _t(v, torch.float32 if k == "router" else dtype)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """(cfg, JAX LM, its params, port LM) per (arch, dtype name).  The
    reference draws every leaf in f32 and casts it to the model's dtype
    (the router stays f32), so its bf16 init is its f32 init cast."""
    out = {}
    for arch in ARCHS:
        cfg = jget_config(arch).smoke()
        f32 = jax.jit(JM.LM(cfg, dtype=jnp.float32, remat=False).init)(
            jax.random.PRNGKey(0))
        bf16 = jax.jit(lambda t: jax.tree_util.tree_map_with_path(
            lambda path, a: a if path[-1].key == "router"
            else a.astype(jnp.bfloat16), t))(f32)
        for name, jdt, tdt, params in (
                ("f32", jnp.float32, torch.float32, f32),
                ("bf16", jnp.bfloat16, torch.bfloat16, bf16)):
            jlm = JM.LM(cfg, dtype=jdt, remat=False)
            tlm = params_from_jax(_np(params), get_config(arch).smoke(),
                                  device="cpu", dtype=tdt)
            out[arch, name] = (cfg, jlm, params, tlm)
    return out


def _tokens(cfg, seed=0, shape=(B, T_)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------------- MLA
@pytest.mark.parametrize("mode", ["forward", "cache"])
def test_mla_attention_matches_reference(mode, models):
    cfg, _, params, _ = models["deepseek-v2-lite-16b", "f32"]
    tcfg = get_config("deepseek-v2-lite-16b").smoke()
    jp = _layer(params["blocks"]["attn"], 1)
    tp = _port_tree(_np(jp))
    x = np.random.default_rng(1).standard_normal(
        (B, T_, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T_, dtype=np.int32), (B, 1))
    tol = dict(atol=1e-5, rtol=1e-5)
    mla = jax.jit(JL.mla_attention, static_argnums=1)
    if mode == "forward":
        want, _ = mla(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
        got, cache = L.mla_attention(tp, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(pos).long())
        assert cache is None
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
        return
    m = cfg.mla
    jc = JL.MLACache(jnp.zeros((B, S, m.kv_lora_rank), jnp.float32),
                     jnp.zeros((B, S, m.qk_rope_head_dim), jnp.float32))
    tc = L.MLACache(torch.zeros(B, S, m.kv_lora_rank),
                    torch.zeros(B, S, m.qk_rope_head_dim))
    Tp = T_ - K
    spans = [(0, Tp)] + [(t, t + 1) for t in range(Tp, T_)]
    for a, b in spans:
        want, jc = mla(jp, cfg, jnp.asarray(x[:, a:b]),
                       jnp.asarray(pos[:, a:b]), jc, a)
        got, tc = L.mla_attention(tp, tcfg, torch.from_numpy(x[:, a:b]),
                                  torch.from_numpy(pos[:, a:b]).long(), tc,
                                  a)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=f"positions {a}..{b - 1}")
        for g, w in zip(tc, jc):
            np.testing.assert_allclose(_f32(g), _f32(w), **tol)


# ------------------------------------------------------------------- MoE
def _kept(top_i, C, E):
    """Each routing kept or dropped, by a plain count: routings in token
    order (top choice first) take their expert's slots until C are
    taken."""
    taken = np.zeros(E, np.int64)
    keep = []
    for e in top_i.reshape(-1):
        keep.append(taken[e] < C)
        taken[e] += 1
    return np.array(keep)


@pytest.mark.parametrize("capacity", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, capacity, models):
    cfg, _, params, _ = models[arch, "f32"]
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                            capacity_factor=capacity))
    tcfg = get_config(arch).smoke()
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                              capacity_factor=capacity))
    jp = _layer(params["blocks"]["moe"], 0)
    tp = _port_tree(_np(jp))
    x = np.random.default_rng(2).standard_normal(
        (B, T_, cfg.d_model)).astype(np.float32)
    x[:, :T_ // 2] = x[0, 0]        # alike tokens, as left-padding is
    N, E = B * T_, cfg.moe.n_routed
    xf = x.reshape(N, -1)

    jw, ji, jaux = JMOE._routing(jp, cfg.moe, jnp.asarray(xf))
    tw, ti, taux = MOE._routing(tp, tcfg.moe, torch.from_numpy(xf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_f32(tw), _f32(jw), atol=1e-5, rtol=1e-5)

    C = MOE.moe_capacity(tcfg.moe, N)
    assert C == JMOE.moe_capacity(cfg.moe, N)
    slot, keep = MOE._dispatch(ti, C, E)
    want_keep = _kept(np.asarray(ji), C, E)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert want_keep.all() == (capacity == 8.0)   # 1.25 drops, 8.0 does not
    assert (slot.numpy() == E * C).sum() == (~want_keep).sum()

    want, wa = JMOE.moe_forward(jp, cfg, jnp.asarray(x))
    got, ga = MOE.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)
    assert float(ga) == pytest.approx(float(wa), rel=1e-5, abs=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-5)


def test_topk_ties_take_the_lower_index_first(models):
    cfg, _, params, _ = models["qwen3-moe-30b-a3b", "f32"]
    jp = dict(_layer(params["blocks"]["moe"], 0))
    jp["router"] = jnp.zeros_like(jp["router"])     # every expert tied
    tp = _port_tree(_np(jp))
    xf = np.random.default_rng(3).standard_normal(
        (5, cfg.d_model)).astype(np.float32)
    _, ji, _ = JMOE._routing(jp, cfg.moe, jnp.asarray(xf))
    _, ti, _ = MOE._routing(tp, get_config("qwen3-moe-30b-a3b").smoke().moe,
                            torch.from_numpy(xf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [list(range(cfg.moe.top_k))] * 5


# ------------------------------------------------------------- the LM, f32
def _jax_forward(jlm, params, toks):
    x = jlm.embed(params, {"tokens": jnp.asarray(toks)})
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32)[None],
                           toks.shape)
    xf, _, aux = jlm.backbone(params, x, pos, mode="train")
    return jlm.unembed(params, xf), aux


def _f32_cache(cache):
    """Either package's cache with every leaf made f32."""
    if isinstance(cache["blocks"], list):
        return {k: [type(c)(*(x.float() for x in c)) for c in v]
                for k, v in cache.items()}
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), cache)


def _cache_arrays(cache):
    """The port's cache as the reference's leaves: each field of the
    ``blocks`` stacked on axis 0, then the ``lead`` caches, in
    ``tree_flatten``'s order."""
    out = []
    for key in sorted(cache):
        if key == "blocks":
            out += [np.stack([_f32(getattr(c, f)) for c in cache[key]])
                    for f in cache[key][0]._fields]
        else:
            out += [_f32(x) for c in cache[key] for x in c]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_f32_matches_reference(arch, models):
    cfg, jlm, params, tlm = models[arch, "f32"]
    toks = _tokens(cfg)
    full, jaux = _jax_forward(jlm, params, toks)
    got = tlm(torch.from_numpy(toks))
    assert got.shape == (B, T_, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(full), **F32_TOL)

    Tp = T_ - K
    jcache = _f32_cache(jlm.init_cache(B, S))
    tcache = _f32_cache(tlm.init_cache(B, S))
    jlog, jcache = jax.jit(jlm.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :Tp])}, jcache)
    tlog, tcache = tlm.prefill(torch.from_numpy(toks[:, :Tp]), tcache)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **F32_TOL)
    want_c = jax.tree_util.tree_leaves(jcache)
    got_c = _cache_arrays(tcache)
    assert [g.shape for g in got_c] == [w.shape for w in want_c]
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g, _f32(w), **F32_TOL)
    dec = jax.jit(jlm.decode_step)
    for t in range(Tp, T_):
        jlg, jcache = dec(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        tlg, tcache = tlm.decode_step(tcache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **F32_TOL,
                                   err_msg=f"{arch} decode t={t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bf16_blocks_match_reference(arch, models):
    """Each block of the bf16 model on the reference's own input to it."""
    cfg, jlm, params, tlm = models[arch, "bf16"]
    toks = _tokens(cfg, seed=4)
    x = jlm.embed(params, {"tokens": jnp.asarray(toks)})
    pos = jnp.broadcast_to(jnp.arange(T_, dtype=jnp.int32)[None], (B, T_))
    tpos = torch.from_numpy(np.array(pos)).long()
    stacks = [(p, tb, False) for p, tb in zip(params.get("lead", []),
                                              tlm.lead)]
    stacks += [(_layer(params["blocks"], i), tb, True)
               for i, tb in enumerate(tlm.blocks)]
    for i, (jp, tb, use_moe) in enumerate(stacks):
        want, _, waux = JM.attn_block(jp, cfg, x, pos, use_moe=use_moe)
        got, _, gaux = tb(_t(x, torch.bfloat16), tpos)
        want_np = _f32(want)
        np.testing.assert_allclose(
            _f32(got), want_np, rtol=BF16_RTOL,
            atol=BF16_STEPS * np.abs(want_np).max(),
            err_msg=f"{arch} block {i}")
        if use_moe:
            # the router's input, the same for both packages
            hn = JL.rmsnorm(jp["ln1"], x, cfg.norm_eps)
            attn = JL.mla_attention if cfg.mla else JL.attention
            a, _ = attn(jp["attn"], cfg, hn, pos)
            h = JL.rmsnorm(jp["ln2"], x + a, cfg.norm_eps)
            h = np.asarray(h.reshape(B * T_, -1), np.float32)
            _, ji, _ = JMOE._routing(jp["moe"], cfg.moe,
                                     jnp.asarray(h, jnp.bfloat16))
            _, ti, _ = MOE._routing(tb["moe"], tlm.cfg.moe,
                                    _t(h, torch.bfloat16))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            assert float(gaux) == pytest.approx(float(waux), rel=1e-3)
        else:
            assert gaux is None
        x = want


def _pin_routing(monkeypatch):
    """Record the reference's routing (``top_i`` and router probabilities,
    call by call), and make the port route each call to the reference's
    ``top_i`` of the same call, weighted by its own probabilities, while
    recording the ``top_i`` and probabilities it would have taken itself.
    Run the reference first."""
    seen = {"jax": [], "jax_probs": [], "torch": [], "torch_probs": []}
    jroute, troute = JMOE._routing, MOE._routing

    def jwrap(p, m, xf):
        out = jroute(p, m, xf)
        probs = jax.nn.softmax(
            xf.astype(jnp.float32) @ p["router"].astype(jnp.float32), -1)
        jax.debug.callback(
            lambda i, pr: (seen["jax"].append(np.array(i)),
                           seen["jax_probs"].append(np.array(pr))),
            out[1], probs, ordered=True)
        return out

    def twrap(p, m, xf):
        _, own, aux = troute(p, m, xf)
        probs = torch.softmax(xf.float() @ p["router"].float(), -1)
        ref = torch.from_numpy(seen["jax"][len(seen["torch"])]).long()
        seen["torch"].append(own.numpy().copy())
        seen["torch_probs"].append(probs.numpy())
        w = probs.gather(1, ref)
        if m.router_norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-9)
        return w, ref, aux
    monkeypatch.setattr(JMOE, "_routing", jwrap)
    monkeypatch.setattr(MOE, "_routing", twrap)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bf16_matches_reference(arch, models, monkeypatch):
    """The whole bf16 LM: forward, prefill and decode.  The two packages
    round a few bf16 values one step apart, so the router probabilities
    differ a little, and where two experts are that near a tie the port
    takes the other one; a token routed elsewhere then differs in every
    later layer.  So the port is pinned to the reference's routing, the
    routing it would take itself must equal the reference's but at such
    ties (rare, and at most twice the largest probability difference
    apart in the reference's own probabilities), and the logits, prefill
    and decode must match at ``tests/test_models.py``'s bf16 tolerances."""
    cfg, jlm, params, tlm = models[arch, "bf16"]
    toks = _tokens(cfg, seed=4)
    seen = _pin_routing(monkeypatch)
    Tp = T_ - K
    want = {"forward": _jax_forward(jlm, params, toks)[0]}
    jcache = jlm.init_cache(B, S)
    want["prefill"], jcache = jax.jit(lambda *a: jlm.prefill(*a))(
        params, {"tokens": jnp.asarray(toks[:, :Tp])}, jcache)
    dec = jax.jit(lambda *a: jlm.decode_step(*a))
    want["decode"] = []
    for t in range(Tp, T_):
        jlg, jcache = dec(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        want["decode"].append(jlg)
    jax.effects_barrier()

    got = {"forward": tlm(torch.from_numpy(toks))}
    got["prefill"], tcache = tlm.prefill(torch.from_numpy(toks[:, :Tp]),
                                         tlm.init_cache(B, S))
    got["decode"] = []
    for t in range(Tp, T_):
        tlg, tcache = tlm.decode_step(tcache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        got["decode"].append(tlg)

    n_moe = len(tlm.blocks)
    assert len(seen["torch"]) == len(seen["jax"]) == n_moe * (2 + K)
    dprob = max(np.abs(a - b).max() for a, b in
                zip(seen["torch_probs"], seen["jax_probs"]))
    assert dprob < 2e-3                 # f32 routers of one-step inputs
    flips = total = 0
    for own, ref, probs in zip(seen["torch"], seen["jax"],
                               seen["jax_probs"]):
        total += ref.size
        for r, j in zip(*np.nonzero(own != ref)):
            flips += 1
            gap = abs(probs[r, own[r, j]] - probs[r, ref[r, j]])
            assert gap <= 2 * dprob, (arch, r, own[r], ref[r], gap, dprob)
    assert flips <= 0.05 * total, (flips, total)
    got["decode"] = torch.stack(got["decode"])
    want["decode"] = jnp.stack(want["decode"])
    for run in ("forward", "prefill", "decode"):
        np.testing.assert_allclose(_f32(got[run]), _f32(want[run]),
                                   **BF16_TOL[run], err_msg=f"{arch} {run}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_reference(arch, models):
    cfg, _, params, tlm = models[arch, "f32"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 23, 40)]
    jeng = JEngine(cfg, params, max_batch=2, max_seq=96)
    teng = Engine(tlm.cfg, model=tlm, max_batch=2, max_seq=96)
    for p in prompts:
        jeng.submit(p, max_new_tokens=5)
        teng.submit(p, max_new_tokens=5)
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert teng.waves == jeng.waves == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistent_with_forward(arch):
    """The port's prefill(T-k) + k decode steps reproduce its own forward
    in f32 with drop-free capacity (``tests/test_models.py``'s MoE case)."""
    cfg = get_config(arch).smoke()
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    tlm = LM(cfg, dtype=torch.float32, device="cpu", seed=1)
    toks = torch.from_numpy(_tokens(cfg, seed=6))
    full = _f32(tlm(toks))
    Tp = T_ - 8
    logits, cache = tlm.prefill(toks[:, :Tp],
                                _f32_cache(tlm.init_cache(B, S)))
    np.testing.assert_allclose(_f32(logits[:, 0]), full[:, Tp - 1],
                               **F32_TOL)
    for t in range(Tp, T_):
        lg, cache = tlm.decode_step(cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_f32(lg[:, 0]), full[:, t], **F32_TOL,
                                   err_msg=f"{arch} t={t}")
