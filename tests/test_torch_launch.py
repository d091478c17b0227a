"""The port's sharding rules, analytic cost model, reshard plan and dry run
against the JAX package's.

* ``param_specs`` on the port's params stacked into the reference's layer
  banks equals the reference's spec tree leaf for leaf (and the stacked
  shapes equal the reference's abstract params) for the five archs of
  ``tests/test_launch.py``, on mesh shapes 1x1, 16x16 and 2x16x16;
  ``opt_state_specs`` (ZeRO-1) equals the reference's too, and the
  per-layer specs the port places with are the banks' without their stack
  dims.  Cache specs equal the reference's for musicgen-large's smoke
  cache; ``logical_rules`` (its head-divisibility gate) and ``batch_axis``
  equal the reference's.
* ``analytic_cost`` returns the reference's dict for every arch, every
  shape ``shape_applicable`` allows, in every mode, and the cases of
  ``tests/test_launch.py::test_analytic_cost_sane`` hold.
* ``plan_reshard`` equals the reference's on ``tests/test_checkpoint.py``'s
  tree and on smollm-135m's smoke params.
* One dry-run cell in a subprocess: smollm-135m decode_32k on a fake 2 x 2
  mesh; its parameter bytes equal the reference's abstract params' bytes,
  its elements ``param_count`` plus the norm scales it leaves out, and
  rank 0's bytes those of the specs' shards.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.checkpoint.elastic import plan_reshard as jplan_reshard
from repro.configs import get_config as jget_config
from repro.launch import shardings as JSH
from repro.launch.analytic import analytic_cost as janalytic_cost
from repro.models.model import LM as JLM
from repro_torch import tree as T
from repro_torch.checkpoint.elastic import plan_reshard
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import shardings as SH
from repro_torch.launch.analytic import analytic_cost
from repro_torch.models.config import param_count
from repro_torch.models.model import LM

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-135m", "deepseek-v2-lite-16b", "falcon-mamba-7b",
         "zamba2-1.2b", "gemma3-27b")
MESHES = ({"data": 1, "model": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})


class FakeMesh:
    """A mesh shape as the reference's rules read it (``mesh.shape``)."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jspecs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _specs(tree):
    return [tuple(s) for s in T.leaves(tree)]


@pytest.fixture(scope="module")
def trees():
    """Per arch: (smoke cfg, the reference's abstract params, the port's
    meta params)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        jcfg = jget_config(arch).smoke()
        shapes = jax.eval_shape(JLM(jcfg, remat=False).init,
                                jax.random.PRNGKey(0))
        out[arch] = (cfg, jcfg, shapes, LM(cfg, device="meta").params())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(trees, arch):
    cfg, jcfg, shapes, params = trees[arch]
    stacked = SH.stacked(params)
    assert [tuple(x.shape) for x in T.leaves(stacked)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(shapes)]
    for shape in MESHES:
        jspec = JSH.param_specs(shapes, jcfg, FakeMesh(shape))
        spec = SH.param_specs(stacked, cfg, shape)
        assert _specs(spec) == _jspecs(jspec), shape
        assert _specs(SH.opt_state_specs(spec, None, shape, stacked)) == \
            _jspecs(JSH.opt_state_specs(jspec, None, FakeMesh(shape),
                                        shapes)), shape
        # the per-layer specs: a bank's without its stack dims, a spec a
        # leaf of each layer
        layer = SH.layer_param_specs(params, cfg, shape)
        assert len(T.leaves(layer)) == len(T.leaves(params))
        for s, x in zip(T.leaves(layer), T.leaves(params)):
            assert len(s) == x.ndim


def test_layer_specs_are_the_banks_without_stack_dims(trees):
    cfg, _, _, params = trees["smollm-135m"]
    shape = {"data": 16, "model": 16}
    bank = SH.param_specs(SH.stacked(params), cfg, shape)["blocks"]
    for layer in SH.layer_param_specs(params, cfg, shape)["blocks"]:
        assert _specs(layer) == [s[1:] for s in _specs(bank)]
    assert tuple(bank["attn"]["wq"]) == (None, None, "model")


@pytest.mark.parametrize("shape", MESHES)
def test_cache_specs_equal_reference(shape):
    cfg = get_config("musicgen-large").smoke()
    jcfg = jget_config("musicgen-large").smoke()
    jshapes = jax.eval_shape(lambda: JLM(jcfg, remat=False).init_cache(8, 64))
    cache = SH.stacked(LM(cfg, device="meta").init_cache(8, 64))
    for bax in ("data", None, JSH.batch_axis(FakeMesh(shape), 8)):
        assert _specs(SH.cache_specs(cache, 8, 64, shape, bax)) == _jspecs(
            JSH.cache_specs(jshapes, 8, 64, FakeMesh(shape), bax))


def test_logical_rules_and_batch_axis_equal_reference():
    for shape in MESHES + ({"data": 4, "model": 2}, {"model": 8}):
        for batch in (1, 8, 32, 256):
            assert SH.batch_axis(shape, batch) == JSH.batch_axis(
                FakeMesh(shape), batch)
            for arch in ARCH_IDS:
                assert SH.logical_rules(shape, batch, get_config(arch)) == \
                    JSH.logical_rules(FakeMesh(shape), batch,
                                      jget_config(arch)), (arch, shape)
    # the divisibility gate: heads over "model" only where KV heads divide
    mesh = {"data": 16, "model": 16}
    assert SH.logical_rules(mesh, 256, get_config("gemma3-27b"))["heads"] \
        == "model"
    assert SH.logical_rules(mesh, 256, get_config("qwen3-14b"))["heads"] \
        is None


def test_analytic_cost_equal_reference():
    n = 0
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape, shp in SHAPES.items():
            if not shape_applicable(arch, shape):
                continue
            for mode in ("train", "prefill", "decode"):
                got = analytic_cost(cfg, shp["global_batch"],
                                    shp["seq_len"], mode)
                assert got == janalytic_cost(jcfg, shp["global_batch"],
                                             shp["seq_len"], mode)
                n += 1
    assert n == 3 * (len(ARCH_IDS) * 3 + sum(
        shape_applicable(a, "long_500k") for a in ARCH_IDS))


def test_analytic_cost_sane():
    cfg = get_config("qwen3-14b")
    train = analytic_cost(cfg, 256, 4096, "train")
    prefill = analytic_cost(cfg, 32, 32768, "prefill")
    decode = analytic_cost(cfg, 128, 32768, "decode")
    assert train["flops"] > train["model_flops"]
    assert prefill["flops"] > prefill["model_flops"] * 0.5
    assert decode["bytes"] > 0 and decode["flops"] > 0
    total, active = param_count(cfg)
    assert total == active


def test_plan_reshard_equal_reference(trees):
    tree = {"w": np.zeros((64, 64), np.float32)}
    args = ({"data": 4, "model": 4}, {"data": 8, "model": 4})
    got = plan_reshard(tree, *args, {"w": SH.Spec("data", "model")})
    assert got == jplan_reshard(tree, *args, {"w": P("data", "model")})
    assert got["total_bytes"] == 64 * 64 * 4
    assert got["approx_bytes_moved_per_device"] > 0
    cfg, jcfg, shapes, params = trees["smollm-135m"]
    stacked = SH.stacked(params)
    for old, new in ((MESHES[1], MESHES[2]), ({"data": 2, "model": 2},
                                              MESHES[1])):
        spec = SH.param_specs(stacked, cfg, new)
        jspec = JSH.param_specs(shapes, jcfg, FakeMesh(new))
        assert plan_reshard(stacked, old, new, spec) == jplan_reshard(
            shapes, old, new, jspec)


def test_dryrun_cell(tmp_path):
    """A full-size cell on a fake 2 x 2 mesh, in its own process (the fake
    process group must not share one with a real group)."""
    out = tmp_path / "cell.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--mesh", "data=2,model=2",
         "--out", str(out)], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    mem = rec["memory"]
    cfg, jcfg = get_config("smollm-135m"), jget_config("smollm-135m")
    jshapes = jax.eval_shape(JLM(jcfg, remat=False).init,
                             jax.random.PRNGKey(0))
    jleaves = jax.tree_util.tree_leaves(jshapes)
    assert mem["param_bytes"] == sum(x.size * x.dtype.itemsize
                                     for x in jleaves)
    norms = (2 * cfg.n_layers + 1) * cfg.d_model    # ln1, ln2, final_norm
    assert mem["param_elements"] == param_count(cfg)[0] + norms
    assert mem["param_bytes"] == 2 * mem["param_elements"]       # all bf16
    shape = {"data": 2, "model": 2}
    params = LM(cfg, device="meta").params()
    specs = SH.layer_param_specs(params, cfg, shape)
    assert mem["params_per_device"] == sum(
        x.numel() * x.element_size() // int(np.prod(
            [SH.axis_size(a, shape) for a in s]))
        for x, s in zip(T.leaves(params), T.leaves(specs)))
    assert mem["cache_per_device"] > 0
    assert rec["flops"] > rec["model_flops"] > 0
    assert rec["collectives"].get("all_reduce", 0) > 0
    assert rec["analytic"] == janalytic_cost(jcfg, 128, 32768, "decode")
