"""The port's checkpoints against the JAX package's, on the CPU.

* ``tests/test_checkpoint.py``'s cases on the port (``device="cpu"``: the
  MANIFEST hashed by the plain version of the integrity hash).
* Across the packages: the same tree saved by either gives the same files,
  byte for byte; a checkpoint saved by one restores in the other bit-equal,
  bf16, f32 and int32 leaves alike, the port's per-layer blocks written as
  the reference's layer banks; each package's MANIFEST verifies under the
  other.
* The MoE models' trees (deepseek-v2-lite-16b with MLA and a dense
  ``lead`` block, qwen3-moe-30b-a3b): the same files from either package,
  ``lead`` kept a plain list of blocks and the router f32, and each
  restores the other's bit-equal.
* Replication of a training checkpoint to POD1 and its restore after the
  primary is lost.
* ``launch.serve --ckpt-dir``: the port serves the reference's tokens from
  one params-only checkpoint, and both packages refuse a training
  checkpoint (params and optimizer state) there, the reference's fault
  kept as it is (ROADMAP Queue C).
"""
import filecmp
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.core.integrity import Manifest as JManifest
from repro.models.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.serve.engine import Engine as JEngine
from repro_torch import tree as T
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.checkpoint.replicate import CheckpointReplicator
from repro_torch.configs import get_config
from repro_torch.core.integrity import Manifest
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.models.params import params_from_jax
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine

REPO = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m"


def tree_example():
    return {
        "w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
        "b": torch.ones((7,), dtype=torch.bfloat16) * 1.5,
        "step_scale": torch.tensor(3.0),
        "nested": {"m": torch.zeros((8, 2), dtype=torch.float32)},
    }


def _save(root, step, tree, **kw):
    return save_checkpoint(str(root), step, tree, device="cpu", **kw)


def _restore(root, tree, **kw):
    return restore_checkpoint(str(root), tree, device="cpu", **kw)


# ------------------------------------------- tests/test_checkpoint.py's
def test_roundtrip_exact(tmp_path):
    t = tree_example()
    _save(tmp_path, 5, t)
    got = _restore(tmp_path, t)
    assert got is not None
    step, tree, d = got
    assert step == 5
    for a, b in zip(T.leaves(t), T.leaves(tree)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_keeps_last_k_and_latest_wins(tmp_path):
    t = tree_example()
    for s in (1, 2, 3, 4, 5):
        _save(tmp_path, s, t, keep=3)
    steps = sorted(int(n.split("-")[1]) for n in os.listdir(tmp_path))
    assert steps == [3, 4, 5]
    assert latest_step(str(tmp_path)) == 5


def test_corrupt_checkpoint_falls_back(tmp_path):
    t = tree_example()
    _save(tmp_path, 1, t)
    _save(tmp_path, 2, t)
    d2 = os.path.join(tmp_path, "step-000002")
    victim = [f for f in os.listdir(d2) if f.startswith("leaf-")][0]
    with open(os.path.join(d2, victim), "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    got = _restore(tmp_path, t)
    assert got is not None and got[0] == 1     # fell back to step 1


def test_uncommitted_checkpoint_ignored(tmp_path):
    t = tree_example()
    _save(tmp_path, 1, t)
    d = _save(tmp_path, 2, t)
    os.remove(os.path.join(d, "COMMITTED"))    # a crash mid-commit
    got = _restore(tmp_path, t)
    assert got is not None and got[0] == 1


def test_replicator_restores_from_replica_when_primary_lost(tmp_path):
    rep = CheckpointReplicator(str(tmp_path), primary="POD0",
                               replicas=("POD1", "STORE"), device="cpu")
    t = tree_example()
    ckpt_root = os.path.join(rep.site_dir("POD0"), "ckpts")
    d = _save(ckpt_root, 7, t)
    rel = os.path.relpath(d, rep.site_dir("POD0"))
    assert rep.replicate(rel)
    shutil.rmtree(ckpt_root)                   # the pod is lost
    got = rep.restore_anywhere("ckpts", t)
    assert got is not None
    step, tree, _, site = got
    assert step == 7 and site in ("POD1", "STORE")
    assert torch.equal(tree["w"], t["w"])


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        save_checkpoint(str(tmp_path), 1, tree_example())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointReplicator(str(tmp_path))


# ------------------------------------------------------- across packages
def _jax_example():
    return {
        "w": jnp.arange(24, dtype=jnp.float32).reshape(4, 6),
        "b": jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16),
        "i": jnp.asarray([[7, -2, 2 ** 30], [0, 1, -2 ** 31]], jnp.int32),
        "step": jnp.int32(11),
        "nested": {"m": jnp.full((9, 2), 0.3, jnp.float32)},
    }


def _torch_of(jtree):
    def leaf(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a, np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(leaf, jtree)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    return [n for n in names if not filecmp.cmp(os.path.join(a, n),
                                                 os.path.join(b, n),
                                                 shallow=False)]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    jt = _jax_example()
    tt = _torch_of(jt)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jckpt.save_checkpoint(str(jdir), 4, jt)
    _save(tdir, 4, tt)
    assert _same_files(jdir / "step-000004", tdir / "step-000004") == []
    if direction == "jax_to_torch":
        step, tree, _ = _restore(jdir, tt)
        for a, b in zip(T.leaves(tt), T.leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        step, tree, _ = jckpt.restore_checkpoint(str(tdir), jt)
        for a, b in zip(jax.tree_util.tree_leaves(jt),
                        jax.tree_util.tree_leaves(tree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert step == 4


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jget_config(ARCH).smoke()
    params = JLM(jcfg, remat=False).init(jax.random.PRNGKey(0))
    return jcfg, params


def _port_model(params, dtype=torch.bfloat16):
    return params_from_jax(
        jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params),
        get_config(ARCH).smoke(), device="cpu", dtype=dtype)


def test_training_state_restores_across_packages(jax_model, tmp_path):
    """{"params", "opt"} of a bf16 model: the port's per-layer blocks and
    the reference's layer banks give the same files, and each restores the
    other's bit-equal."""
    _, params = jax_model
    jt = {"params": params, "opt": jadamw.init(params)}
    tlm = _port_model(params)
    tt = {"params": tlm.params(), "opt": adamw.init(tlm.params())}
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jt)
    _save(tmp_path / "torch", 2, tt)
    assert _same_files(tmp_path / "jax" / "step-000002",
                       tmp_path / "torch" / "step-000002") == []
    _, got, _ = _restore(tmp_path / "jax", tt)
    assert len(got["params"]["blocks"]) == jax_model[0].n_layers
    for a, b in zip(T.leaves(tt), T.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, jgot, _ = jckpt.restore_checkpoint(str(tmp_path / "torch"), jt)
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    jax.tree_util.tree_leaves(jgot)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_moe_training_state_restores_across_packages(arch, tmp_path):
    jcfg = jget_config(arch).smoke()
    params = jax.jit(JLM(jcfg, remat=False).init)(jax.random.PRNGKey(0))
    jt = {"params": params, "opt": jax.jit(jadamw.init)(params)}
    tlm = params_from_jax(
        jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params),
        get_config(arch).smoke(), device="cpu", dtype=torch.bfloat16)
    tt = {"params": tlm.params(), "opt": adamw.init(tlm.params())}
    assert isinstance(tt["params"].get("lead", []), list)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jt)
    _save(tmp_path / "torch", 1, tt)
    assert _same_files(tmp_path / "jax" / "step-000001",
                       tmp_path / "torch" / "step-000001") == []
    _, got, _ = _restore(tmp_path / "jax", tt)
    assert len(got["params"].get("lead", [])) == jcfg.moe.first_dense_layers
    assert all(b["moe"]["router"].dtype == torch.float32
               for b in got["params"]["blocks"])
    for a, b in zip(T.leaves(tt), T.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, jgot, _ = jckpt.restore_checkpoint(str(tmp_path / "torch"), jt)
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    jax.tree_util.tree_leaves(jgot)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_verifies_under_the_other_package(writer, tmp_path):
    jt = _jax_example()
    if writer == "jax":
        d = jckpt.save_checkpoint(str(tmp_path), 1, jt)
    else:
        d = _save(tmp_path, 1, _torch_of(jt))
    mpath = os.path.join(d, "MANIFEST.json")
    jm, tm = JManifest.load(mpath), Manifest.load(mpath)
    assert jm.entries == tm.entries
    assert jm.verify(d) == {} and tm.verify(d, device="cpu") == {}
    # both find the same corruption
    victim = os.path.join(d, "leaf-00001.c00.npy")
    with open(victim, "r+b") as f:
        f.seek(130)
        f.write(b"\x00\x01")
    assert (jm.verify(d) == tm.verify(d, device="cpu")
            == {"leaf-00001.c00.npy": "checksum mismatch"})


# --------------------------------------------------------------- serving
def _params_only(jax_model, root):
    jcfg, params = jax_model
    f32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    jckpt.save_checkpoint(str(root), 3, {"params": f32})
    return jcfg, f32


def test_serve_from_checkpoint_gives_reference_tokens(jax_model, tmp_path):
    jcfg, f32 = _params_only(jax_model, tmp_path)
    prompts = launch_serve.prompts(jcfg, 5, 64, seed=1)
    _, jtree, _ = jckpt.restore_checkpoint(str(tmp_path), {"params": f32})
    jeng = JEngine(jcfg, jtree["params"], max_batch=2, max_seq=64)
    model = launch_serve.load_model(get_config(ARCH).smoke(), "cpu", seed=9,
                                    ckpt_dir=str(tmp_path))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    teng = Engine(get_config(ARCH).smoke(), model=model, max_batch=2,
                  max_seq=64)
    for p in prompts:
        jeng.submit(p, max_new_tokens=4)
        teng.submit(p, max_new_tokens=4)
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)


def test_serve_cli_loads_a_params_checkpoint(jax_model, tmp_path):
    _params_only(jax_model, tmp_path)
    out = _cli("--arch", ARCH, "--device", "cpu", "--requests", "2",
               "--max-new", "3", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "loaded checkpoint step 3 from" in out.stdout
    assert "served 2 requests / 6 tokens" in out.stdout


def test_training_checkpoint_refused_by_both_serve_paths(jax_model,
                                                         tmp_path):
    """The reference restores by the example tree {"params": ...}; a
    training checkpoint holds {"opt", "params"}, so both raise."""
    jcfg, params = jax_model
    jckpt.save_checkpoint(str(tmp_path), 6,
                          {"params": params, "opt": jadamw.init(params)})
    with pytest.raises(ValueError, match="Too many leaves"):
        jckpt.restore_checkpoint(str(tmp_path), {"params": params})
    with pytest.raises(ValueError, match="leaves for a tree of"):
        launch_serve.load_model(get_config(ARCH).smoke(), "cpu",
                                ckpt_dir=str(tmp_path))
