"""The port's last four model families against the JAX package's, on the CPU
(training and checkpoints: ``test_torch_families_train.py``).

gemma3-27b (``local_global``: sliding-window layers with ring-buffer KV
caches and a global layer), zamba2-1.2b (``hybrid``: Mamba2 layers and one
weight-shared attention block), qwen2-vl-7b (M-RoPE over the frontend's
embeddings) and musicgen-large (4 codebooks), at their smoke configs and at
gemma3 with 8 layers and zamba2 with 5, whose banks have a ``tail`` (the
smoke configs' is None).  The JAX package's own parameters are carried in
by ``params_from_jax``, and both packages run the reference's
``train_batch_stub`` inputs through numpy:

* f32: forward logits, prefill logits, the whole prefill cache and four
  decode steps within 1e-4, with both packages' caches made f32 (as
  ``tests/test_models.py`` does for its f32 case).  gemma3 prefills 28
  tokens into rings of its window, 16, so the decode steps run past the
  ring's wrap; qwen2-vl prefills from embeddings with M-RoPE's
  ``positions3`` (an image grid, then text) and decodes from the token
  table, as the reference does.
* bf16: the same at ``tests/test_models.py``'s tolerances (atol 0.12 /
  rtol 0.05 for forward and prefill, atol 0.5 / rtol 0.03 for decode).
  musicgen is held at its decode tolerance throughout, as that test holds
  musicgen's decode: its per-book heads are drawn at 1/sqrt(K) (the
  reference's ``_dense_init`` scales by the first axis, K = 4), so its
  logits reach ~20, and hidden states one bf16 step apart between the
  frameworks (0.05 at magnitude 4 after 4 layers) move them by up to 0.31.
* A gemma3 cache shorter than the window: the ring holds max_seq slots.
* The serving engine's tokens equal to the reference's (bf16 caches),
  musicgen's K ids a step included.
* ``mamba2_block`` alone (a chunked prefill from a nonzero state, then
  single steps) and ``apply_mrope`` alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.models.frontends import mrope_position_ids as j_mrope_ids
from repro.models.frontends import train_batch_stub as j_batch_stub
from repro.models.model import LM as JLM
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.frontends import mrope_position_ids
from repro_torch.models.params import F32_LEAVES, params_from_jax
from repro_torch.serve.engine import Engine

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops at these sizes are launch-bound: one thread runs
    them as fast as eight, and spins no threads against the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (arch, n_layers of the smoke config or None)
CONFIGS = {"gemma3": ("gemma3-27b", None), "gemma3_tail": ("gemma3-27b", 8),
           "zamba2": ("zamba2-1.2b", None), "zamba2_tail": ("zamba2-1.2b", 5),
           "qwen2_vl": ("qwen2-vl-7b", None),
           "musicgen": ("musicgen-large", None)}
SMOKE = ["gemma3", "zamba2", "qwen2_vl", "musicgen"]
B, T_, K = 2, 32, 4            # batch, sequence, decode steps
S = T_ + 8                     # cache length
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = {"prefill": dict(atol=0.12, rtol=0.05),
            "decode": dict(atol=0.5, rtol=0.03)}


def configs(name):
    """(the reference's config, the port's) of ``name``."""
    arch, n = CONFIGS[name]
    j, t = jget_config(arch).smoke(), get_config(arch).smoke()
    return (j, t) if n is None else (j.with_(n_layers=n), t.with_(n_layers=n))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _f32_params(name):
    return jax.jit(JLM(configs(name)[0], dtype=jnp.float32,
                       remat=False).init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def models(name, dtype):
    """(reference config, reference LM, its params, port LM) of ``name`` in
    "f32" or "bf16".  The reference draws every leaf in f32 and casts it,
    but for its f32 leaves, so its bf16 init is its f32 init cast."""
    jcfg, tcfg = configs(name)
    params = _f32_params(name)
    jdt, tdt = jnp.float32, torch.float32
    if dtype == "bf16":
        jdt, tdt = jnp.bfloat16, torch.bfloat16
        params = jax.jit(lambda t: jax.tree_util.tree_map_with_path(
            lambda path, a: a if path[-1].key in F32_LEAVES
            else a.astype(jnp.bfloat16), t))(params)
    jlm = JLM(jcfg, dtype=jdt, remat=False)
    tlm = params_from_jax(_np(params), tcfg, device="cpu", dtype=tdt)
    return jcfg, jlm, params, tlm


@functools.lru_cache(maxsize=None)
def jitted(name, dtype):
    _, jlm, _, _ = models(name, dtype)
    return jax.jit(jlm.prefill), jax.jit(jlm.decode_step)


def batch(jcfg, seq=T_, seed=0):
    """The reference's ``train_batch_stub`` batch (numpy) and the same as
    the port's tensors, and decode tokens (B, seq) or (B, seq, K)."""
    jb = {k: np.array(v) for k, v in
          j_batch_stub(jcfg, B, seq, seed).items() if k != "labels"}
    tb = {k: torch.from_numpy(np.array(v, np.float32 if k == "embeds"
                                       else np.int32))
          for k, v in jb.items()}
    toks = jb.get("tokens")
    if toks is None:                  # frontend embeddings: decode by token
        toks = np.random.default_rng(seed).integers(
            0, jcfg.vocab_size, (B, seq)).astype(np.int32)
    return jb, tb, toks


def _head(b, n):
    return {k: v[:, :, :n] if k == "positions3" else v[:, :n]
            for k, v in b.items()}


def _stacked(node):
    """The port's per-layer cache lists as the reference's stacked banks."""
    if isinstance(node, dict):
        return {k: _stacked(v) for k, v in node.items()}
    if isinstance(node, list):
        return jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                      *[_stacked(x) for x in node])
    if isinstance(node, tuple):
        return tuple(_f32(x) for x in node)
    return _f32(node)


def _jforward(jlm, params, jb):
    x = jlm.embed(params, jb)
    T = x.shape[1]
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    xf, _, _ = jlm.backbone(params, x, pos, positions3=jb.get("positions3"),
                            mode="train")
    return jlm.unembed(params, xf)


def _serve_both(name, dtype, seq, cache_len, tol, check_cache):
    """Prefill seq - K tokens into caches of ``cache_len`` and decode K more
    in both packages, the reference's run first (a JAX computation just
    before each of the port's small CPU calls keeps its threads spinning
    and slows them tenfold); the port's cache."""
    jcfg, jlm, params, tlm = models(name, dtype)
    jb, tb, toks = batch(jcfg, seq)
    Tp = seq - K
    f32 = dtype == "f32"
    jcache = jax.jit(lambda: jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if f32 else a,
        jlm.init_cache(B, cache_len)))()
    tcache = tlm.init_cache(B, cache_len)
    if f32:
        for c in jax.tree_util.tree_leaves(
                tcache, is_leaf=lambda x: isinstance(x, torch.Tensor)):
            c.data = c.data.float()
    jpre, jdec = jitted(name, dtype)
    jlog, jcache = jpre(params, _head(jb, Tp), jcache)
    want = [_f32(jlog), [_f32(x) for x in jax.tree_util.tree_leaves(jcache)]]
    for t in range(Tp, seq):
        jlg, jcache = jdec(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        want.append(_f32(jlg))
    tlog, tcache = tlm.prefill(_head(tb, Tp), tcache)
    np.testing.assert_allclose(_f32(tlog), want[0], **tol["prefill"])
    if check_cache:
        got = jax.tree_util.tree_leaves(_stacked(tcache))
        assert len(got) == len(want[1])
        for a, b in zip(got, want[1]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **tol["prefill"])
    for t, jlg in zip(range(Tp, seq), want[2:]):
        tlg, tcache = tlm.decode_step(tcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_f32(tlg), jlg, **tol["decode"],
                                   err_msg=f"{name} {dtype} decode t={t}")
    return tcache


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f32_forward_prefill_decode_match_reference(name):
    jcfg, jlm, params, tlm = models(name, "f32")
    jb, tb, _ = batch(jcfg)
    want = _f32(jax.jit(functools.partial(_jforward, jlm))(params, jb))
    tlm(tb)                                   # the port's first call warms up
    got = _f32(tlm(tb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)
    tol = {"prefill": F32_TOL, "decode": F32_TOL}
    tcache = _serve_both(name, "f32", T_, S, tol, check_cache=True)
    if name.startswith("gemma3"):
        w = jcfg.sliding_window
        assert T_ - K > w          # the prefill overruns the ring
        assert all(c.k.shape[1] == w for g in tcache["groups"]
                   for c in g["local"])
        assert all(g["global"].k.shape[1] == S for g in tcache["groups"])


@pytest.mark.parametrize("name", SMOKE)
def test_bf16_forward_prefill_decode_match_reference(name):
    jcfg, jlm, params, tlm = models(name, "bf16")
    jb, tb, _ = batch(jcfg, seed=1)
    tol = BF16_TOL
    if name == "musicgen":
        tol = {"prefill": BF16_TOL["decode"], "decode": BF16_TOL["decode"]}
    want = _f32(jax.jit(functools.partial(_jforward, jlm))(params, jb))
    np.testing.assert_allclose(_f32(tlm(tb)), want, **tol["prefill"])
    _serve_both(name, "bf16", T_, S, tol, check_cache=False)


def test_ring_shorter_than_window_holds_max_seq():
    """A cache shorter than the window (max_seq 14 < 16): the local layers'
    rings hold 14 slots, and prefill and decode match the reference."""
    jcfg = models("gemma3", "f32")[0]
    assert jcfg.sliding_window == 16
    tol = {"prefill": F32_TOL, "decode": F32_TOL}
    tcache = _serve_both("gemma3", "f32", 12, 14, tol, check_cache=True)
    assert {c.k.shape[1] for g in tcache["groups"] for c in g["local"]} == {
        14}


@pytest.mark.parametrize("name", SMOKE)
def test_engine_returns_the_reference_tokens(name):
    """Both engines serve the launcher's seeded prompts (prompts (T, K) for
    musicgen) with the default bf16 caches; 5 requests in waves of 2.
    gemma3's prompts are padded to 16 tokens, its window: the rings fill
    at the prefill and wrap in the first decode step."""
    jcfg, _, params, tlm = models(name, "f32")
    prompts = launch_serve.prompts(jcfg, 5, 64, seed=2)
    jeng = JEngine(jcfg, params, max_batch=2, max_seq=64)
    teng = Engine(configs(name)[1], model=tlm, max_batch=2, max_seq=64)
    for p in prompts:
        jeng.submit(p, max_new_tokens=5)
        teng.submit(p, max_new_tokens=5)
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    if name == "musicgen":
        assert all(len(tok) == jcfg.n_codebooks for r in tdone
                   for tok in r.out_tokens)


# ---------------------------------------------------------------- modules
def test_mamba2_block_chunked_from_a_state_then_steps():
    """A chunked prefill of 64 tokens (two chunks of 32) from a nonzero
    state, then three single steps: outputs and states within 1e-4."""
    jcfg, tcfg = configs("zamba2")
    p = jax.jit(lambda k: JSSM.init_mamba2(k, jcfg, jnp.float32))(
        jax.random.PRNGKey(3))
    tp = {k: ({"scale": torch.from_numpy(np.array(v["scale"]))}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in p.items()}
    s = jcfg.ssm
    d_in = s.expand * jcfg.d_model
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((B, s.d_conv - 1, d_in + 2 * s.d_state))
    h = rng.standard_normal((B, d_in // s.headdim, s.headdim, s.d_state))
    x = rng.standard_normal((B, 64 + 3, jcfg.d_model)).astype(np.float32)
    jst = JSSM.Mamba2State(jnp.asarray(conv, jnp.float32),
                           jnp.asarray(h, jnp.float32))
    tst = SSM.Mamba2State(torch.tensor(conv, dtype=torch.float32),
                          torch.tensor(h, dtype=torch.float32))
    block = jax.jit(lambda p, x, st: JSSM.mamba2_block(p, jcfg, x, st))
    for lo, hi in ((0, 64), (64, 65), (65, 66), (66, 67)):
        jy, jst = block(p, jnp.asarray(x[:, lo:hi]), jst)
        ty, tst = SSM.mamba2_block(tp, tcfg, torch.from_numpy(x[:, lo:hi]),
                                   tst)
        for got, want in ((ty, jy), *zip(tst, jst)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                _f32(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                err_msg=f"tokens {lo}:{hi}")


def test_apply_mrope_matches_reference():
    jcfg, tcfg = configs("qwen2_vl")
    T = 48
    x = np.random.default_rng(5).standard_normal(
        (B, T, jcfg.n_heads, jcfg.head_dim)).astype(np.float32)
    p3 = mrope_position_ids(B, T)
    np.testing.assert_array_equal(p3, j_mrope_ids(B, T))
    assert len({tuple(r) for r in p3[:, 0, :8].T}) > 1   # streams differ
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(p3), jcfg.rope_theta,
                          jcfg.mrope_sections)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3),
                        tcfg.rope_theta, tcfg.mrope_sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # t on all three streams is plain RoPE
    same = np.broadcast_to(np.arange(T, dtype=np.int32), (3, B, T))
    np.testing.assert_allclose(
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(same.copy()),
                      tcfg.rope_theta, tcfg.mrope_sections).numpy(),
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0].copy()),
                     tcfg.rope_theta).numpy(), atol=1e-6)
