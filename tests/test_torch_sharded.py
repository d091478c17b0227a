"""The port's sharded path on spawned gloo ranks (CPU), against the
single-process path and the JAX package's.

Two ranks (``torch_gloo.sharded2``), smoke configs in f32:

* smollm-135m's and falcon-mamba-7b's forwards on meshes (data 2, model 1)
  and (data 1, model 2) equal the single-process forward within 1e-4;
  smollm with ``n_kv_heads=2`` on (model 2) turns the rules' head gate on,
  and B3's plain version is handed half the heads of each kind;
* one ``build_train_step`` step on (data 2), on (model 2) with heads
  sharded (``n_kv_heads=2``), on (model 2) with 3 query heads (the head
  gate off, and wo's row-parallel gradient, split over H * hd, not one of
  whole heads), and on (data 2) with FSDP-sharded params and
  ``hoist_fsdp``: the f32 master params and
  moments and the loss within 1e-5 of the single-process step (the global
  norm sums the shards' squares in another order), the new bf16 params
  within 1e-5 too;
* a checkpoint saved by either package, restored, placed on (model 2) by
  ``load_for_mesh`` and gathered back: equal to the saved arrays bit for
  bit;
* falcon-mamba-7b on (model 2): its DTensor parameters keep its decode
  step off the CUDA graph, which the plain model would take on the card;
  on (data 2) and (model 2) its prefill and three decode steps equal the
  single-process ones within 1e-4, the Mamba1 step's ops handed each
  rank's rows or channels.

Four ranks (``torch_gloo.sharded4``), a 2 x 2 mesh: qwen3-moe-30b-a3b's
smoke ``moe_forward`` with the JAX package's weights equals the
reference's ``shard_map`` path on 4 simulated devices (a JAX subprocess)
within 1e-4, at capacity factor 1.25 (experts overflow per token shard)
and 8.0, where it also equals the port's dense path within 1e-4; its
gradients (of a weighted sum of the output, and of aux) with respect to
the router, the experts and x equal ``jax.grad`` of the reference's
within 1e-4; and the
checkpoints restored onto the 2 x 2 mesh, bit for bit.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_gloo
from conftest import jax_subprocess_env
from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.models.model import LM as JLM
from repro_torch import tree as T
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.models.model import LM

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-4
TRAIN_TOL = 1e-5
MOE_TOL = 1e-4
ARCH = "smollm-135m"

_MOE_REF = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch import shardings as SH
    from repro.models import moe as M
    from repro.models.axes import logical_axis_rules
    cfg0 = get_config("qwen3-moe-30b-a3b").smoke()
    p = M.init_moe(jax.random.PRNGKey(0), cfg0, jnp.float32)
    x = np.random.default_rng(0).normal(size=(4, 8, cfg0.d_model))
    x[:, :4] = x[:1, :1]           # alike tokens overflow their experts
    x = jnp.asarray(x.astype(np.float32))
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))   # Auto axes: grad-able
    out = {"x": np.asarray(x), "r": r}
    out.update({f"p_{k}": np.asarray(v) for k, v in p.items()})
    for cf in (1.25, 8.0):
        cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
            cfg0.moe, capacity_factor=cf))
        with logical_axis_rules(mesh, SH.logical_rules(mesh, 4, cfg)):
            o, aux = jax.jit(lambda p, x: M.moe_forward(p, cfg, x))(p, x)
            # the gradients of sum(out * r) and of aux, each alone, as
            # the train step's loss takes them (aux with its own weight)
            g = {"out": jax.jit(jax.grad(lambda p, x: jnp.sum(
                     M.moe_forward(p, cfg, x)[0] * r), (0, 1)))(p, x),
                 "aux": jax.jit(jax.grad(
                     lambda p, x: M.moe_forward(p, cfg, x)[1], (0, 1)))(p, x)}
        out[f"out_{cf}"], out[f"aux_{cf}"] = np.asarray(o), np.asarray(aux)
        for of, (gp, gx) in g.items():
            out[f"g{of}_{cf}_x"] = np.asarray(gx)
            out.update({f"g{of}_{cf}_{k}": np.asarray(v)
                        for k, v in gp.items()})
    np.savez(sys.argv[1], **out)
""")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """smollm-135m's smoke params (bf16) saved by each package; the saved
    leaves in flatten order (bf16 as their bits)."""
    tmp = tmp_path_factory.mktemp("ckpts")
    cfg = get_config(ARCH).smoke()
    port = LM(cfg, device="cpu", seed=3).params()
    save_checkpoint(str(tmp / "port"), 5, port, device="cpu")
    jparams = JLM(jget_config(ARCH).smoke(), remat=False).init(
        jax.random.PRNGKey(1))
    jckpt.save_checkpoint(str(tmp / "jax"), 7, jparams)
    saved = {"port": [t.view(torch.int16).numpy() if t.dtype ==
                      torch.bfloat16 else t.numpy() for t in
                      T.leaves(T.stack_layers(port, torch.stack))],
             "jax": [_bits(a) for a in jax.tree_util.tree_leaves(jparams)]}
    return {"dirs": {"port": (str(tmp / "port"), ARCH),
                     "jax": (str(tmp / "jax"), ARCH)},
            "steps": {"port": 5, "jax": 7}, "saved": saved}


@pytest.fixture(scope="module")
def two(tmp_path_factory, ckpts):
    return torch_gloo.run("sharded2", 2, tmp_path_factory.mktemp("two"),
                          ckpts=ckpts["dirs"])[0]


@pytest.fixture(scope="module")
def four(tmp_path_factory, ckpts):
    tmp = tmp_path_factory.mktemp("four")
    ref_path = tmp / "moe_ref.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", _MOE_REF, str(ref_path)], cwd=REPO,
        env=dict(jax_subprocess_env(devices=4),
                 PYTHONPATH=str(REPO / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, log[-3000:]
    out = torch_gloo.run("sharded4", 4, tmp, ref_path=str(ref_path),
                         ckpts=ckpts["dirs"])[0]
    return out, dict(np.load(ref_path))


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b"])
@pytest.mark.parametrize("shape", ["{'data': 2, 'model': 1}",
                                   "{'data': 1, 'model': 2}"])
def test_sharded_forward_matches_single_process(two, arch, shape):
    r = _ok(two[f"forward {arch} {shape}"])
    np.testing.assert_allclose(r["got"], r["want"], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("shape, local", [
    ("{'data': 2, 'model': 1}", [((2, 1, 256), (2, 256, 8))]),
    ("{'data': 1, 'model': 2}", [((4, 1, 128), (4, 128, 8))])])
def test_sharded_mamba1_decode_steps_match_single_process(two, shape,
                                                          local):
    """falcon-mamba-7b's decode steps on the mesh run the Mamba1 step on
    each rank's rows or channels (its plain version here, its kernels on
    the card) and equal the single-process steps."""
    r = _ok(two[f"decode falcon-mamba-7b {shape}"])
    assert r["local_z_h"] == local and r["steps"] == 3 * 4   # 4 layers
    np.testing.assert_allclose(r["got"], r["want"], atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_a_sharded_model_decodes_eagerly(two):
    """A model with DTensor parameters stays off the decode graph, which
    the same model unsharded would take on the card."""
    assert _ok(two["decode graph"]) == {"plain": True, "sharded": False}


def test_heads_sharded_forward(two):
    """Two KV heads on (model 2): the head gate is on, and every B3 call
    gets one KV head and half the query heads of the whole batch."""
    r = _ok(two["forward heads"])
    assert r["rules"]["heads"] == "model" and r["rules"]["kv"] == "model"
    assert r["local_b_h_hkv"] == [(4, 2, 1)], r["local_b_h_hkv"]
    np.testing.assert_allclose(r["got"], r["want"], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("case", ["data2", "model2", "model2_odd_heads",
                                  "hoist"])
def test_train_step_matches_single_process(two, case):
    r = _ok(two[f"train {case}"])
    assert r["dtypes"] == ["torch.bfloat16"]
    assert r["fsdp"] == (case == "hoist")
    got, want = r["got"], r["want"]
    assert abs(got["loss"] - want["loss"]) <= TRAIN_TOL
    for key in ("master", "m", "v", "params"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, atol=TRAIN_TOL, rtol=0,
                                       err_msg=key)


@pytest.mark.parametrize("of", ["out", "aux"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_expert_parallel_moe_gradients_match_reference(four, cf, of):
    """d sum(out * r) and d aux with respect to the router, the experts and
    x on the 2 x 2 mesh, against ``jax.grad`` of the reference's
    ``shard_map`` path: aux, computed whole on each 'model' rank, counts
    once in the router's and x's gradients."""
    out, ref = four
    got = _ok(out["moe"])[cf]["grads"][of]
    for k in ("router", "w_gate", "w_up", "w_down", "x"):
        np.testing.assert_allclose(got[k], ref[f"g{of}_{cf}_{k}"],
                                   atol=MOE_TOL, rtol=MOE_TOL, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("by", ["port", "jax"])
def test_checkpoint_restores_onto_ranks_bit_for_bit(two, four, ckpts, ranks,
                                                    by):
    r = _ok(two["restore"] if ranks == 2 else four[0]["restore"])[by]
    assert r["step"] == ckpts["steps"][by] and r["sharded"]
    want = ckpts["saved"][by]
    assert len(r["leaves"]) == len(want)
    for a, b in zip(r["leaves"], want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_expert_parallel_moe_matches_reference(four, cf):
    out, ref = four
    r = _ok(out["moe"])[cf]
    np.testing.assert_allclose(r["out"], ref[f"out_{cf}"], atol=MOE_TOL,
                               rtol=MOE_TOL)
    assert abs(r["aux"] - float(ref[f"aux_{cf}"])) <= MOE_TOL
    if cf == 8.0:                  # nothing dropped: the dense path's output
        np.testing.assert_allclose(r["out"], r["dense"], atol=MOE_TOL,
                                   rtol=MOE_TOL)
