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
  rank 0's bytes those of the specs' shards.  The same cell on the default
  mesh, the production 16 x 16 (the 2 x 16 x 16 pod mesh takes ~100 s on
  this CPU, nearly all of it in DTensor's redistribute planner, which
  searches a graph of placements on a three-axis mesh).  Two cells on
  meshes of 8 and 4 ranks in one process, as ``--both-meshes`` runs them:
  the second gets a fake group of its size and the 2 x 2 cell's record.
  A training cell of qwen3-14b (cut to 5 layers) on 2 x 16, where 40
  heads do not split over 16 ranks.
* The sweep: ``make_production_mesh``, ``cell_path`` and the skip records
  equal the reference's (in one JAX subprocess, where the reference's dry
  run sets up 512 host devices); ``--all`` launches one subprocess a cell,
  in the reference's order, through a stub.
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
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as SH
from repro_torch.launch.analytic import analytic_cost
from repro_torch.launch.mesh import make_production_mesh
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


def _shard_bytes(cfg, shape) -> int:
    """Rank 0's bytes of the params laid out by the port's specs."""
    params = LM(cfg, device="meta").params()
    specs = SH.layer_param_specs(params, cfg, shape)
    return sum(x.numel() * x.element_size() // int(np.prod(
        [SH.axis_size(a, shape) for a in s]))
        for x, s in zip(T.leaves(params), T.leaves(specs)))


def _dryrun(tmp_path, *args) -> dict:
    """One cell's record from ``python -m repro_torch.launch.dryrun``."""
    out = tmp_path / "cell.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", *args, "--out", str(out)],
        cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def cell_2x2(tmp_path_factory):
    """smollm-135m decode_32k on a fake 2 x 2 mesh, from a fresh process."""
    return _dryrun(tmp_path_factory.mktemp("cell"), "--mesh",
                   "data=2,model=2")


def test_dryrun_cell(cell_2x2):
    """A full-size cell on a fake 2 x 2 mesh, in its own process (the fake
    process group must not share one with a real group)."""
    rec = cell_2x2
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
    assert mem["params_per_device"] == _shard_bytes(cfg, {"data": 2,
                                                          "model": 2})
    assert mem["cache_per_device"] > 0
    assert rec["flops"] > rec["model_flops"] > 0
    assert rec["collectives"].get("all_reduce", 0) > 0
    assert rec["analytic"] == janalytic_cost(jcfg, 128, 32768, "decode")


def test_dryrun_cell_on_the_production_mesh(tmp_path):
    rec = _dryrun(tmp_path)
    cfg = get_config("smollm-135m")
    mesh = {"data": 16, "model": 16}
    assert rec["ok"] and rec["mesh"] == mesh and rec["chips"] == 256
    assert rec["memory"]["params_per_device"] == _shard_bytes(cfg, mesh)
    assert rec["rules"] == SH.logical_rules(mesh, 128, cfg)


_TWO_MESHES = """
import json, sys
import torch.distributed as dist
from repro_torch.launch.dryrun import run_cell
recs = []
for mesh in ({"data": 4, "model": 2}, {"data": 2, "model": 2}):
    rec = run_cell("smollm-135m", "decode_32k", mesh)
    recs.append(dict(rec, world=dist.get_world_size()))
print(json.dumps(recs))
"""


def test_run_cell_recreates_the_fake_group_for_another_mesh(tmp_path,
                                                            cell_2x2):
    """Two meshes in one process (as ``--both-meshes`` runs them): the
    second cell gets a fake group of its own size, and its record equals
    the one a fresh process writes."""
    r = subprocess.run([sys.executable, "-c", _TWO_MESHES], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    first, second = json.loads(r.stdout.splitlines()[-1])
    assert (first["chips"], first["world"]) == (8, 8)
    assert (second["chips"], second["world"]) == (4, 4)
    for key in ("mesh", "memory", "collectives", "flops", "rules"):
        assert second[key] == cell_2x2[key], key


_ODD_HEADS = """
import dataclasses, json
from repro_torch.launch import dryrun
real = dryrun.get_config
dryrun.get_config = lambda a: dataclasses.replace(real(a), n_layers=5)
dryrun.SHAPES["train_4k"] = dict(dryrun.SHAPES["train_4k"], global_batch=8,
                                 seq_len=256)
rec = dryrun.run_cell("qwen3-14b", "train_4k", {"data": 2, "model": 16}, 1)
print(json.dumps({k: rec[k] for k in ("ok", "rules")}))
"""


def test_dryrun_train_cell_with_heads_split_unevenly(tmp_path):
    """qwen3-14b's 40 heads on 16 "model" ranks (the head gate off; cut to
    5 layers and 8 x 256 tokens): the gradient that the row-parallel wo
    sends back, split over H * hd, is laid out by heads before it is
    viewed as heads, as the reference's constraints lay out cotangents."""
    r = subprocess.run([sys.executable, "-c", _ODD_HEADS], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.splitlines()[-1])
    assert rec["ok"] and rec["rules"]["heads"] is None


# The reference's sweep facts, in a JAX subprocess: importing its dry run
# sets up 512 host devices before JAX loads
_JAX_SWEEP = r"""
import json, os, sys
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh

d, cells = sys.argv[1], json.loads(sys.argv[2])
out = {"meshes": [list(make_production_mesh(multi_pod=mp).shape.items())
                  for mp in (False, True)]}
dryrun.OUT_DIR = d
out["paths"] = [os.path.relpath(dryrun.cell_path(*c), d) for c in cells]
cmds = []

class Done:
    returncode = 0

def run(cmd):
    cmds.append(cmd[3:])
    return Done()

dryrun.subprocess.run = run
sys.argv = ["dryrun", "--all", "--force"]
assert dryrun.main() == 0
out["cmds"] = cmds
out["records"] = {p: json.load(open(os.path.join(d, p)))
                  for p in sorted(os.listdir(d))}
print(json.dumps(out))
"""
CELLS = [("smollm-135m", "train_4k", False), ("gemma3-27b", "long_500k",
                                               True)]


@pytest.fixture(scope="module")
def ref_sweep(tmp_path_factory):
    from conftest import jax_subprocess_env
    d = tmp_path_factory.mktemp("jax_dryrun")
    r = subprocess.run([sys.executable, "-c", _JAX_SWEEP, str(d),
                        json.dumps(CELLS)], capture_output=True, text=True,
                       timeout=300, env=jax_subprocess_env())
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


def test_production_mesh_equals_reference(ref_sweep):
    got = [[list(kv) for kv in make_production_mesh(multi_pod=mp).items()]
           for mp in (False, True)]
    assert got == ref_sweep["meshes"]
    assert got[1] == [["pod", 2], ["data", 16], ["model", 16]]


def test_sweep_launches_a_subprocess_a_cell_as_the_reference(
        ref_sweep, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    assert [os.path.relpath(dryrun.cell_path(*c), tmp_path)
            for c in CELLS] == ref_sweep["paths"]
    cmds = []
    monkeypatch.setattr(dryrun, "_launch",
                        lambda cmd: cmds.append(cmd) or 0)
    assert dryrun.main(["--all", "--force"]) == 0
    # the reference's cells, in its order, each with its flags
    assert [c[3:] for c in cmds] == ref_sweep["cmds"]
    assert all(c[:3] == [sys.executable, "-m", "repro_torch.launch.dryrun"]
               for c in cmds)
    want = {(a, s, mp) for a in ARCH_IDS for s in SHAPES
            if shape_applicable(a, s) for mp in (False, True)}
    got = [(c[4], c[6], "--multi-pod" in c) for c in cmds]
    assert len(got) == len(want) and set(got) == want
    # skip records where the reference writes them, with its fields
    records = {p.name: json.loads(p.read_text())
               for p in sorted(tmp_path.iterdir())}
    assert records == ref_sweep["records"] and records
    assert all(r["skipped"] and r["shape"] == "long_500k"
               for r in records.values())


def test_sweep_skips_written_cells_unless_forced(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    cmds = []
    monkeypatch.setattr(dryrun, "_launch",
                        lambda cmd: cmds.append(cmd) or 0)
    cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES
             if shape_applicable(a, s) for mp in (False, True)]
    for c in cells[1:]:
        Path(dryrun.cell_path(*c)).write_text("{}")
    assert dryrun.main(["--all"]) == 0
    assert [(c[4], c[6], "--multi-pod" in c) for c in cmds] == cells[:1]
    monkeypatch.setattr(dryrun, "_launch", lambda cmd: 1)
    assert dryrun.main(["--all", "--force"]) == 1


@pytest.mark.parametrize("argv", [["--all", "--mesh", "data=2,model=2"],
                                  ["--all", "--out", "x.json"],
                                  ["--arch", "smollm-135m"],
                                  ["--arch", "smollm-135m", "--shape",
                                   "train_4k", "--both-meshes", "--out",
                                   "x.json"],
                                  ["--arch", "smollm-135m", "--shape",
                                   "train_4k", "--mesh", "data=2,model=2"]])
def test_dryrun_cli_refuses_mixed_flags(argv, tmp_path, monkeypatch):
    """A custom mesh or path never writes into the production records."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    with pytest.raises(SystemExit):
        dryrun.main(argv)
    assert not list(tmp_path.iterdir())

