"""The port's training path against the JAX package's, on the CPU.

Smoke configs of smollm-135m and falcon-mamba-7b, ``device="cpu"`` (the
kernels' plain versions, which autograd differentiates natively), inputs
seeded with numpy:

* ``softmax_xent``, ``warmup_cosine`` / ``constant`` and one or two AdamW
  updates against the reference's (f32 state within 1e-6 relative, bf16
  params equal);
* ``LM.loss_fn`` and its gradients, with and without remat, against
  ``jax.value_and_grad(model.loss_fn)`` from the same f32 params
  (``params_from_jax``), within 1e-4 (relative, and absolute against each
  leaf's largest gradient);
* the kernels' ``autograd.Function``s on the CPU with their plain versions
  standing in for the kernels: the backward's recompute and
  ``autograd.grad`` give native autograd's gradients;
* a 5-step ``train()`` loss trace against the reference's from one
  checkpoint the reference saves of its init (step 0), which both restore,
  at ``tests/test_models.py``'s bf16 tolerance (atol 0.12, rtol 0.05);
* the loop's loss decrease, restart, replication and gradient accumulation;
* the data pipelines (``SyntheticTokens``, ``ShardedDataset``,
  ``IterState``) batch for batch against the reference's;
* the ``launch.train`` CLI.
"""
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

from repro.checkpoint.ckpt import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.data import sharded as jsharded
from repro.data.synthetic import for_model as jfor_model
from repro.models.model import LM as JLM
from repro.models.model import softmax_xent as jsoftmax_xent
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import train as jtrain
from repro_torch import tree as T
from repro_torch.checkpoint.replicate import CheckpointReplicator
from repro_torch.configs import get_config
from repro_torch.data import sharded
from repro_torch.data.synthetic import for_model
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_torch
from repro_torch.kernels.mamba_scan import ops as sops
from repro_torch.kernels.mamba_scan.ref import selective_scan_torch
from repro_torch.models.model import LM, softmax_xent
from repro_torch.models.params import params_from_jax
from repro_torch.optim import adamw, schedule
from repro_torch.train.loop import TrainConfig, make_train_step, train

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["smollm-135m", "falcon-mamba-7b"]
GRAD_TOL = 1e-4
LOSS_TOL = dict(atol=0.12, rtol=0.05)      # tests/test_models.py, bf16


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _batch(cfg, B, T_, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T_ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ------------------------------------------------------------ loss pieces
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_equals_reference(dtype):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jsoftmax_xent(jnp.asarray(logits, dtype),
                               jnp.asarray(labels)))
    got = float(softmax_xent(torch.from_numpy(logits).to(getattr(torch,
                                                                 dtype)),
                             torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


def test_schedules_equal_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for warmup, total in ((20, 100), (0, 50), (5, 5)):
        want = np.asarray(jschedule.warmup_cosine(
            jnp.asarray(steps), 3e-4, warmup, total))
        got = schedule.warmup_cosine(torch.from_numpy(steps), 3e-4, warmup,
                                     total).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        schedule.constant(torch.from_numpy(steps), 1e-3).numpy(),
        np.asarray(jschedule.constant(jnp.asarray(steps), 1e-3)))


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 4, 2)}, "e": (2,)}
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_equals_reference(grad_scale):
    params = _opt_trees(2)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    tp = T.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    jstate, tstate = jadamw.init(jp), adamw.init(tp)
    for i in range(2):          # the second step's bias corrections too
        grads = jax.tree_util.tree_map(lambda a: a * grad_scale,
                                       _opt_trees(10 + i))
        jlr = jnp.float32(1e-3 * (i + 1))
        jp, jstate, jm = jadamw.update(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   grads), jstate, jlr)
        tp, tstate, tm = adamw.update(
            T.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                       grads), tstate, torch.tensor(1e-3 * (i + 1)))
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert float(tm["clip_scale"]) == pytest.approx(
            float(jm["clip_scale"]), rel=1e-6)
        for jt, tt in ((jstate.master, tstate.master), (jstate.m, tstate.m),
                       (jstate.v, tstate.v)):
            for a, b in zip(jax.tree_util.tree_leaves(jt), T.leaves(tt)):
                assert b.dtype == torch.float32
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=0)
        for a, b in zip(jax.tree_util.tree_leaves(jp), T.leaves(tp)):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def f32_models():
    """(JAX LM, its f32 params, the port's LM from them) per arch."""
    out = {}
    for arch in ARCHS:
        jlm = JLM(jget_config(arch).smoke(), dtype=jnp.float32, remat=False)
        params = jlm.init(jax.random.PRNGKey(0))
        tlm = params_from_jax(_np_tree(params), get_config(arch).smoke(),
                              device="cpu", dtype=torch.float32)
        out[arch] = (jlm, params, tlm)
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch, remat, f32_models):
    jlm, params, tlm = f32_models[arch]
    batch = _batch(jlm.cfg, 2, 32, seed=3)
    (jloss, _), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tlm.remat = remat
    tlm.requires_grad_(True)
    loss, aux = tlm.loss_fn(batch)
    leaves = T.leaves(tlm.parameter_tree())
    grads = torch.autograd.grad(loss, leaves)
    tlm.requires_grad_(False)
    assert float(aux["aux"]) == 0.0
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=GRAD_TOL)
    banks = T.stack_layers(T.unflatten(tlm.parameter_tree(), list(grads)),
                           torch.stack)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(T.leaves(banks))
    for a, b in zip(jleaves, T.leaves(banks)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(a).max())


# ------------------------------------------------- the kernels' Functions
def _grads(fn, ins, weights):
    ins = [x.detach().requires_grad_(True) for x in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    return outs, torch.autograd.grad(total, ins)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_backward_equals_native_autograd(monkeypatch, dtype,
                                                        window):
    monkeypatch.setattr(fops, "flash_attention_cuda", attention_torch)
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 17, 6, 32, generator=g).to(dtype)
    k = torch.randn(2, 17, 2, 32, generator=g).to(dtype)
    v = torch.randn(2, 17, 2, 32, generator=g).to(dtype)
    w = [torch.randn(2, 17, 6, 32, generator=g)]
    out, got = _grads(lambda *x: fops.FlashAttention.apply(*x, window),
                      (q, k, v), w)
    want_out, want = _grads(lambda *x: attention_torch(*x, window),
                            (q, k, v), w)
    assert torch.equal(out[0], want_out[0])
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scan_function_backward_equals_native_autograd(monkeypatch):
    monkeypatch.setattr(sops, "selective_scan_cuda", selective_scan_torch)
    rng = np.random.default_rng(5)
    B, T_, D, N = 2, 24, 8, 4
    ins = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((B, T_, D)),
        np.log1p(np.exp(rng.standard_normal((B, T_, D)))),
        rng.standard_normal((B, T_, N)), rng.standard_normal((B, T_, N)),
        -np.tile(np.arange(1, N + 1), (D, 1)),
        rng.standard_normal((B, D, N)))]
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((B, T_, D), (B, D, N))]
    out, got = _grads(sops.SelectiveScan.apply, ins, w)
    want_out, want = _grads(selective_scan_torch, ins, w)
    assert len(got) == 6
    for a, b in zip(out + got, want_out + want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the loop
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_trace_tracks_reference(arch, tmp_path):
    """Both loops restore one checkpoint of the reference's init (step 0)
    and train 5 steps on the same synthetic batches."""
    jcfg = jget_config(arch).smoke()
    params = JLM(jcfg, remat=False).init(jax.random.PRNGKey(0))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsave(jdir, 0, {"params": params, "opt": jadamw.init(params)})
    shutil.copytree(jdir, tdir)
    kw = dict(steps=5, batch_size=4, seq_len=32, peak_lr=1e-3, warmup=2,
              ckpt_every=100, log_every=0)
    want = jtrain(jcfg, JTrainConfig(ckpt_dir=jdir, **kw))
    got = train(get_config(arch).smoke(),
                TrainConfig(ckpt_dir=tdir, device="cpu", **kw))
    assert "step-000000" in got.restored_from
    assert len(got.losses) == len(want.losses) == 5
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)


def test_train_loss_decreases():
    cfg = get_config("smollm-135m").smoke()
    tc = TrainConfig(steps=40, batch_size=8, seq_len=64, peak_lr=1e-3,
                     warmup=5, ckpt_dir=None, log_every=0, device="cpu")
    res = train(cfg, tc)
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.05, (first, last)


def test_train_restart_resumes_and_completes(tmp_path):
    cfg = get_config("smollm-135m").smoke()
    ckpt = str(tmp_path / "ckpts")
    tc = TrainConfig(steps=24, batch_size=4, seq_len=32, ckpt_every=8,
                     ckpt_dir=ckpt, fail_at_step=13, log_every=0,
                     device="cpu")
    res = train(cfg, tc)
    assert res.restarts == 1
    assert res.final_step == 24
    assert res.restored_from is not None and "step-000008" in res.restored_from
    # steps 0..12, then 8..23 replayed from the step-8 checkpoint
    assert len(res.losses) == 13 + 16
    assert os.path.isdir(os.path.join(ckpt, "step-000024"))


def test_train_with_replication_protects_against_pod_loss(tmp_path):
    cfg = get_config("falcon-mamba-7b").smoke()
    rep = CheckpointReplicator(str(tmp_path), primary="POD0",
                               replicas=("POD1",), device="cpu")
    ckpt = os.path.join(rep.site_dir("POD0"), "ckpts")
    tc = TrainConfig(steps=4, batch_size=2, seq_len=16, ckpt_every=2,
                     ckpt_dir=ckpt, replicator=rep, log_every=0, remat=True,
                     device="cpu")
    train(cfg, tc)
    pod1 = os.path.join(rep.site_dir("POD1"), "ckpts")
    assert sorted(os.listdir(pod1)) == ["step-000002", "step-000004"]


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_equal_one_batch(arch, f32_models):
    """Two microbatches of 2 give one batch of 4's loss and gradients
    (through the first moment, 0.1 x the clipped gradient)."""
    _, params, _ = f32_models[arch]
    cfg = get_config(arch).smoke()
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, 4, 16, seed=6).items()}
    out = {}
    for mb in (1, 2):
        model = params_from_jax(_np_tree(params), cfg, device="cpu",
                                dtype=torch.float32)
        model.requires_grad_(True)
        step = make_train_step(model, adamw.AdamWConfig(),
                               TrainConfig(microbatches=mb, device="cpu"))
        _, state, loss, metrics = step(adamw.init(model.params()), batch)
        out[mb] = (float(loss), float(metrics["grad_norm"]),
                   T.leaves(state.m))
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    assert out[2][1] == pytest.approx(out[1][1], rel=1e-5)
    for a, b in zip(out[2][2], out[1][2]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_equal_reference(arch):
    want = jfor_model(jget_config(arch).smoke(), 3, 24, seed=7)
    got = for_model(get_config(arch).smoke(), 3, 24, seed=7)
    assert got.cfg == type(got.cfg)(**want.cfg.__dict__)
    for step in (0, 1, 17):
        a, b = want.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_sharded_batches_and_resume_equal_reference(tmp_path):
    toks = np.random.default_rng(8).integers(0, 1000, 5000).astype(np.int32)
    roots = {}
    for name, mod in (("jax", jsharded), ("torch", sharded)):
        roots[name] = str(tmp_path / name)
        assert mod.write_shards(roots[name], toks, shard_len=300) == 16
    for f in os.listdir(roots["jax"]):
        assert (Path(roots["jax"], f).read_bytes()
                == Path(roots["torch"], f).read_bytes()), f
    for host in (0, 1):
        jit = jsharded.ShardedDataset(roots["jax"], host, 2).batches(2, 63)
        tit = sharded.ShardedDataset(roots["torch"], host, 2).batches(2, 63)
        for _ in range(7):
            (jb, jst), (tb, tst) = next(jit), next(tit)
            for k in jb:
                np.testing.assert_array_equal(jb[k], tb[k])
            assert (tst.pending, tst.epoch) == (jst.pending, jst.epoch)
            np.testing.assert_array_equal(tst.leftover, jst.leftover)
        # the saved state resumes both at the same batch, across packages
        tst.save(str(tmp_path / "state.npz"))
        resumed = jsharded.IterState.load(str(tmp_path / "state.npz"))
        again = sharded.IterState.load(str(tmp_path / "state.npz"))
        jnext = next(jsharded.ShardedDataset(roots["jax"], host, 2)
                     .batches(2, 63, resumed))[0]
        tnext = next(sharded.ShardedDataset(roots["torch"], host, 2)
                     .batches(2, 63, again))[0]
        np.testing.assert_array_equal(jnext["tokens"], tnext["tokens"])
        np.testing.assert_array_equal(next(jit)[0]["tokens"],
                                      tnext["tokens"])


def test_sharded_straggler_requeue(tmp_path):
    """A shard read exceeding the deadline is requeued, not dropped."""
    import time
    root = str(tmp_path / "shards")
    sharded.write_shards(root, np.arange(2048, dtype=np.int32),
                         shard_len=256)
    ds = sharded.ShardedDataset(root, straggler_deadline_s=0.2)
    slow = {"shard-00001.npy"}

    def hook(name):
        if name in slow:
            slow.discard(name)      # slow exactly once
            time.sleep(0.5)

    ds.load_hook = hook
    it = ds.batches(batch=1, seq=255)
    seen = [next(it)[0]["tokens"][0, 0] for _ in range(8)]
    assert "shard-00001.npy" in ds.slow_shards
    assert any(int(s) == 256 for s in seen)


# ------------------------------------------------------------------ CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)


def test_cli_trains_and_replicates_on_the_cpu(tmp_path):
    pod0 = str(tmp_path / "POD0")
    out = _cli("--arch", "smollm-135m", "--device", "cpu", "--steps", "4",
               "--ckpt-dir", pod0, "--replicate-to", "POD1",
               "--ckpt-every", "2", "--seq", "32")
    assert out.returncode == 0, out.stderr
    assert "done: arch=smollm-135m-smoke steps=4 restarts=0" in out.stdout
    assert sorted(os.listdir(tmp_path / "POD1" / "ckpts")) == [
        "step-000002", "step-000004"]


def test_cli_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli("--arch", "smollm-135m", "--steps", "1")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
