"""The port's decoder LM against the JAX package's, on the smoke configs.

The JAX package's ``LM.init(PRNGKey(0))`` parameters are carried into the
port's ``LM`` by ``params_from_jax`` (bf16 leaves as float32 numpy; bf16 ->
f32 -> bf16 is exact), and both run the same seeded tokens on the CPU, where
the port's kernels run their plain versions.

* f32 parameters: forward logits, prefill logits, the prefill cache and four
  decode steps' logits agree to 1e-4.  Both packages' caches are made f32
  for this, as ``tests/test_models.py`` does for its f32 case: with the
  default bf16 caches, f32 keys that agree to 1e-6 are rounded to bf16,
  and the few that lie near a rounding boundary land one bf16 step apart
  (seen: 0.0078 in one key, 5e-4 in the logits), which says nothing about
  the port.
* bf16 parameters: the same at ``tests/test_models.py``'s tolerances (atol
  0.12 / rtol 0.05 for prefill and forward, atol 0.5 / rtol 0.03 for
  decode): the two frameworks round bf16 products at other places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.models.config import param_count as j_param_count
from repro.models.model import LM as JLM
from repro.models.model import derive_pattern as j_derive_pattern
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.models import model as M
from repro_torch.models.config import param_count
from repro_torch.models.params import F32_LEAVES, params_from_jax

PORTED = ["smollm-135m", "qwen3-14b", "falcon-mamba-7b"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"]     # tests/test_torch_moe.py
# tests/test_torch_families.py, tests/test_torch_families_train.py
FAMILIES = ["zamba2-1.2b", "gemma3-27b", "qwen2-vl-7b", "musicgen-large"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, T, K = 2, 32, 4          # batch, sequence, decode steps after the prefill
S = T + 8                   # cache length


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def pairs():
    """(cfg, JAX LM, its params, port LM) per (arch, dtype), built once."""
    out = {}
    for arch in PORTED:
        cfg = jget_config(arch).smoke()
        for name, (jdt, tdt) in DTYPES.items():
            jlm = JLM(cfg, dtype=jdt, remat=False)
            params = jlm.init(jax.random.PRNGKey(0))
            tlm = params_from_jax(_np_tree(params), get_config(arch).smoke(),
                                  device="cpu", dtype=tdt)
            out[arch, name] = (cfg, jlm, params, tlm)
    return out


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _jax_forward(jlm, params, toks):
    x = jlm.embed(params, {"tokens": jnp.asarray(toks)})
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32)[None],
                           toks.shape)
    xf, _, _ = jlm.backbone(params, x, pos, mode="train")
    return jlm.unembed(params, xf)


def _f32_cache(cache):
    """A cache with every bf16 leaf made f32 (either package's layout)."""
    if isinstance(cache, dict) and isinstance(cache.get("blocks"), list):
        return {"blocks": [type(b)(*(x.float() for x in b))
                           for b in cache["blocks"]]}
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), cache)


def _stacked_cache(cache):
    """The port's per-layer cache as the reference's stacked arrays."""
    blocks = cache["blocks"]
    return [np.stack([_f32(getattr(b, f)) for b in blocks])
            for f in blocks[0]._fields]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", PORTED)
def test_serving_matches_reference(arch, dtype, pairs):
    cfg, jlm, params, tlm = pairs[arch, dtype]
    toks = _tokens(cfg)
    f32 = dtype == "f32"
    pre_tol = dict(atol=1e-4, rtol=1e-4) if f32 else dict(atol=0.12,
                                                          rtol=0.05)
    dec_tol = dict(atol=1e-4, rtol=1e-4) if f32 else dict(atol=0.5, rtol=0.03)

    full = _jax_forward(jlm, params, toks)
    got = tlm(torch.from_numpy(toks))
    assert got.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(full), **pre_tol)

    Tp = T - K
    jcache, tcache = jlm.init_cache(B, S), tlm.init_cache(B, S)
    if f32:
        jcache, tcache = _f32_cache(jcache), _f32_cache(tcache)
    jlog, jcache = jax.jit(jlm.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :Tp])}, jcache)
    tlog, tcache = tlm.prefill(torch.from_numpy(toks[:, :Tp]), tcache)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **pre_tol)
    for got_c, want_c in zip(_stacked_cache(tcache), jcache["blocks"]):
        assert got_c.shape == want_c.shape
        np.testing.assert_allclose(got_c, _f32(want_c), **pre_tol)

    dec = jax.jit(jlm.decode_step)
    for t in range(Tp, T):
        jlg, jcache = dec(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        tlg, tcache = tlm.decode_step(tcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **dec_tol,
                                   err_msg=f"{arch} {dtype} decode t={t}")


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_consistent_with_forward(arch, pairs):
    """The port's prefill(T-k) + k decode steps reproduce its own forward,
    as ``tests/test_models.py`` checks the reference (bf16 parameters)."""
    cfg, _, _, tlm = pairs[arch, "bf16"]
    toks = torch.from_numpy(_tokens(cfg, seed=1))
    full = _f32(tlm(toks))
    Tp = T - 8
    logits, cache = tlm.prefill(toks[:, :Tp], tlm.init_cache(B, S))
    np.testing.assert_allclose(_f32(logits[:, 0]), full[:, Tp - 1],
                               atol=0.12, rtol=0.05)
    for t in range(Tp, T):
        lg, cache = tlm.decode_step(cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_f32(lg[:, 0]), full[:, t], atol=0.5,
                                   rtol=0.03, err_msg=f"{arch} t={t}")


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_and_param_count_equal_reference(arch):
    want, got = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    assert param_count(got) == j_param_count(want)
    assert param_count(got.smoke()) == j_param_count(want.smoke())
    assert tuple(M.derive_pattern(got)) == tuple(j_derive_pattern(want))


def test_registry_equals_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert SHAPES == J_SHAPES
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert shape_applicable(arch, shape) == j_shape_applicable(arch,
                                                                       shape)


@pytest.mark.parametrize("arch", PORTED + ["starcoder2-15b"] + MOE
                         + FAMILIES)
def test_port_init_matches_reference_shapes(arch):
    """The port's own seeded init has the reference's leaves: the same
    count per parameter, the same dtypes (bf16, with the f32 leaves kept
    f32), and parameters frozen."""
    cfg = get_config(arch).smoke()
    tlm = M.LM(cfg, device="cpu", seed=3)
    jparams = JLM(jget_config(arch).smoke(), remat=False).init(
        jax.random.PRNGKey(0))
    n_j = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        jparams))
    assert sum(p.numel() for p in tlm.parameters()) == n_j
    for name, p in tlm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf in F32_LEAVES
                           else torch.bfloat16), name
        assert not p.requires_grad
    again = M.LM(cfg, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(tlm.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_pattern_builds_and_serves(arch):
    """The four patterns and options the port once refused (local_global,
    hybrid with Mamba2, M-RoPE with frontend embeddings, codebooks) build
    from the port's own init with the reference's tree, stacked as its
    banks, and serve a prefill and a decode step to finite logits of the
    reference's shape."""
    cfg = get_config(arch).smoke()
    tlm = M.LM(cfg, device="cpu", seed=1)
    jparams = jax.eval_shape(JLM(jget_config(arch).smoke(), remat=False).init,
                             jax.random.PRNGKey(0))
    banks = tree.stack_layers(tlm.params(), torch.stack)
    assert tree.treedef_token(banks) == str(jax.tree_util.tree_structure(
        jparams))
    assert [tuple(x.shape) for x in tree.leaves(banks)] == [
        x.shape for x in jax.tree_util.tree_leaves(jparams)]
    book = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab_size, (2, 8, *book),
                         generator=torch.Generator().manual_seed(0))
    logits, cache = tlm.prefill(toks, tlm.init_cache(2, 12))
    logits, cache = tlm.decode_step(cache, toks[:, -1:], 8)
    assert logits.shape == (2, 1, *book, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.LM(get_config("smollm-135m").smoke())


def test_params_from_jax_rejects_a_wrong_layer_count(pairs):
    cfg, _, params, _ = pairs["smollm-135m", "f32"]
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(_np_tree(params), cfg.with_(n_layers=3),
                        device="cpu", dtype=torch.float32)
