"""Training, checkpoints and the CLIs of the port's last four model families,
against the JAX package's, on the CPU.

The models of ``test_torch_families.py`` (gemma3-27b, zamba2-1.2b,
qwen2-vl-7b and musicgen-large at their smoke configs; gemma3 at 8 layers
and zamba2 at 5, with a ``tail``):

* the loss and every gradient against ``jax.value_and_grad(loss_fn)``
  within 1e-4 (f32), remat off for the smoke configs and on for the tail
  configs; qwen2-vl trains on the frontend's embeddings with M-RoPE's
  ``positions3``, so its token table's gradient is zero, as JAX gives it;
  musicgen's loss is the mean over its 4 codebooks;
* a training checkpoint ({"params", "opt"}, bf16 params and f32 AdamW
  state) of gemma3 and zamba2 (``tail`` None) and of zamba2 with a tail:
  the same files from either package, byte for byte (the two-level
  ``groups`` banks, the hybrid's ``shared`` block), each restoring the
  other's bit-equal, and each MANIFEST verifying under both packages'
  hashes;
* AdamW's update in slices equal to the whole leaf's, bit for bit;
* the synthetic batches (codebook tokens, or embeddings and
  ``positions3``) equal to the reference's, step after step;
* the serving CLI and the training loop run each family on the CPU, the
  synthetic batches reaching ``loss_fn`` as the data pipeline made them.
"""
import os
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core.integrity import Manifest as JManifest
from repro.data.synthetic import for_model as jfor_model
from repro.optim import adamw as jadamw
from repro_torch import tree as T
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.core.integrity import Manifest
from repro_torch.data.synthetic import for_model
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.train import loop
from test_torch_families import CONFIGS, SMOKE, B, configs, models

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops at these sizes are launch-bound: one thread runs
    them as fast as eight, and spins no threads against the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_TOL = 1e-4
T_ = 32


def _batch(jcfg, seed=7):
    """A reference ``train_batch_stub`` batch with labels, as numpy."""
    from repro.models.frontends import train_batch_stub
    return {k: np.array(v) for k, v in
            train_batch_stub(jcfg, B, T_, seed).items()}


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v, np.float32 if k == "embeds"
                                           else np.int32))
            for k, v in b.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_equal_reference(name):
    jcfg, jlm, params, tlm = models(name, "f32")
    b = _batch(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jlm.loss_fn, has_aux=True))(params, b)
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    tlm.remat = name.endswith("_tail")
    tlm.requires_grad_(True)
    try:
        loss, _ = tlm.loss_fn(_torch_batch(b))
        grads = torch.autograd.grad(loss, T.leaves(tlm.parameter_tree()),
                                    allow_unused=True, materialize_grads=True)
    finally:
        tlm.requires_grad_(False)
        tlm.remat = True
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=GRAD_TOL)
    tgrads = T.unflatten(tlm.parameter_tree(), list(grads))
    got = T.leaves(T.stack_layers(tgrads, torch.stack))
    assert len(got) == len(jleaves)
    for a, g in zip(jleaves, got):
        assert g.shape == a.shape
        np.testing.assert_allclose(g.numpy(), a, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(a).max())
    if name == "qwen2_vl":
        assert not np.any(np.asarray(jgrads["embed"]))
        assert not torch.any(tgrads["embed"])


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    return [n for n in names if not filecmp.cmp(os.path.join(a, n),
                                                 os.path.join(b, n),
                                                 shallow=False)]


@pytest.mark.parametrize("name", ["gemma3", "zamba2", "zamba2_tail"])
def test_training_checkpoint_same_files_both_ways(name, tmp_path):
    _, _, params, tlm = models(name, "bf16")
    assert (params.get("tail") is None) == (not name.endswith("_tail"))
    jt = {"params": params, "opt": jax.jit(jadamw.init)(params)}
    tt = {"params": tlm.params(), "opt": adamw.init(tlm.params())}
    assert str(jax.tree_util.tree_structure(jt)) == T.treedef_token(
        T.stack_layers(tt, torch.stack))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jt)
    d = save_checkpoint(str(tmp_path / "torch"), 1, tt, device="cpu")
    assert _same_files(tmp_path / "jax" / "step-000001", d) == []
    _, got, _ = restore_checkpoint(str(tmp_path / "jax"), tt, device="cpu")
    for a, b in zip(T.leaves(tt), T.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, jgot, _ = jckpt.restore_checkpoint(str(tmp_path / "torch"), jt)
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    jax.tree_util.tree_leaves(jgot)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    for root in (tmp_path / "jax" / "step-000001", d):
        m = os.path.join(root, "MANIFEST.json")
        assert JManifest.load(m).verify(str(root)) == {}
        assert Manifest.load(m).verify(str(root), device="cpu") == {}


def test_adamw_slices_equal_the_whole_leaf(monkeypatch):
    """A leaf updated in slices of 7 elements gives the whole leaf's new
    params and state bit for bit (a leaf of 12 x 11 is 19 slices), below
    the clip; the global norm summed by slices within 1e-6 of the whole
    leaves' (it only reorders the sum)."""
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((12, 11)).astype(
        np.float32)).bfloat16(), "b": torch.ones(5, dtype=torch.bfloat16)}
    grads = T.tree_map(lambda p: torch.from_numpy(rng.standard_normal(
        tuple(p.shape)).astype(np.float32) * 0.05).bfloat16(), params)
    lr = torch.tensor(1e-2)
    outs, norms = [], []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        state = adamw.init(params)
        for _ in range(2):
            new, state, m = adamw.update(grads, state, lr)
        assert float(m["clip_scale"]) == 1.0
        outs.append(T.leaves(new) + T.leaves(state))
        norms.append(float(m["grad_norm"]))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert norms[1] == pytest.approx(norms[0], rel=1e-6)


@pytest.mark.parametrize("name", SMOKE)
def test_synthetic_batches_equal_reference(name):
    jcfg, tcfg = configs(name)
    want, got = jfor_model(jcfg, 3, 24, seed=7), for_model(tcfg, 3, 24, 7)
    for step in (0, 1, 17):
        a, b = want.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", SMOKE)
def test_serve_cli_runs_each_family(name, capsys):
    arch = CONFIGS[name][0]
    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", SMOKE)
def test_train_loop_feeds_the_synthetic_batches(name, monkeypatch):
    """Two steps of ``train.loop.train``: every batch reaches ``loss_fn``
    as ``data/synthetic.py`` made it (codebook tokens (B, T, 4); embeddings
    and ``positions3`` for qwen2-vl), and the losses are finite."""
    cfg = configs(name)[1]
    seen = []
    loss_fn = LM.loss_fn

    def recording(self, batch, *a, **kw):
        seen.append({k: v.clone() for k, v in batch.items()})
        return loss_fn(self, batch, *a, **kw)

    monkeypatch.setattr(LM, "loss_fn", recording)
    tc = loop.TrainConfig(steps=2, batch_size=2, seq_len=16, device="cpu",
                          log_every=0)
    res = loop.train(cfg, tc)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    data = for_model(cfg, 2, 16, 0)
    keys = {"gemma3": {"tokens", "labels"}, "zamba2": {"tokens", "labels"},
            "qwen2_vl": {"embeds", "labels", "positions3"},
            "musicgen": {"tokens", "labels"}}[name]
    for step, got in enumerate(seen):
        want = data.batch_at(step)
        assert set(got) == set(want) == keys
        for k in keys:
            assert torch.equal(got[k], torch.from_numpy(want[k]))
    if name == "musicgen":
        assert seen[0]["tokens"].shape == (2, 16, 4)
