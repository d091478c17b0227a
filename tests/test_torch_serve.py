"""The port's serving engine and launcher against the JAX package's.

The JAX package's f32 parameters for the smollm-135m smoke config are
carried into the port (``params_from_jax``), and both engines serve the same
seeded prompts on the CPU: the port's engine must return exactly the
reference's tokens, for same-length prompts, for mixed lengths (left-padded
to a 16/32/64 bucket) and for more requests than slots.  Both keep the
reference's default bf16 KV caches.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.model import LM as JLM
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import _bucket as j_bucket
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fkernel
from repro_torch.models.model import LM
from repro_torch.models.params import params_from_jax
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, _bucket

REPO = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def engines_params():
    jcfg = jget_config(ARCH).smoke()
    params = JLM(jcfg, dtype=jnp.float32, remat=False).init(
        jax.random.PRNGKey(0))
    tlm = params_from_jax(
        jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params),
        get_config(ARCH).smoke(), device="cpu", dtype=torch.float32)
    return jcfg, params, tlm


def _serve_both(engines_params, prompts, max_new, max_batch, max_seq):
    jcfg, params, tlm = engines_params
    jeng = JEngine(jcfg, params, max_batch=max_batch, max_seq=max_seq)
    teng = Engine(get_config(ARCH).smoke(), model=tlm, max_batch=max_batch,
                  max_seq=max_seq)
    for p in prompts:
        jeng.submit(p, max_new_tokens=max_new)
        teng.submit(p, max_new_tokens=max_new)
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    return jeng, jdone, teng, tdone


@pytest.mark.parametrize("case", ["same_length", "mixed_length_left_pad",
                                  "five_requests_two_slots"])
def test_engine_returns_the_reference_tokens(case, engines_params):
    rng = np.random.default_rng({"same_length": 0,
                                 "mixed_length_left_pad": 1,
                                 "five_requests_two_slots": 2}[case])
    V = engines_params[0].vocab_size
    if case == "same_length":
        prompts = [rng.integers(0, V, 16) for _ in range(2)]
        kw = dict(max_new=5, max_batch=2, max_seq=64)
    elif case == "mixed_length_left_pad":
        prompts = [rng.integers(0, V, n) for n in (5, 23, 40)]
        kw = dict(max_new=6, max_batch=4, max_seq=96)
    else:
        prompts = [rng.integers(0, V, 8) for _ in range(5)]
        kw = dict(max_new=3, max_batch=2, max_seq=48)
    jeng, jdone, teng, tdone = _serve_both(engines_params, prompts, **kw)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(r.done and len(r.out_tokens) == kw["max_new"] for r in tdone)
    assert teng.waves == jeng.waves
    if case == "five_requests_two_slots":
        assert teng.waves == 3
    assert len(teng.stats["prefill_s"]) == teng.waves
    assert len(teng.stats["decode_s"]) == teng.waves * (kw["max_new"] - 1)


def test_bucket_equals_reference():
    assert [_bucket(n) for n in range(1, 300)] == [j_bucket(n)
                                                   for n in range(1, 300)]


def test_cpu_serving_launches_no_kernel(engines_params):
    before = fkernel.launches
    _serve_both(engines_params, [np.arange(10)], max_new=2, max_batch=1,
                max_seq=32)
    assert fkernel.launches == before


def test_engine_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(get_config(ARCH).smoke())


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)


def test_cli_serves_on_the_cpu():
    out = _cli("--arch", ARCH, "--device", "cpu", "--requests", "3",
               "--max-new", "4")
    assert out.returncode == 0, out.stderr
    assert "served 3 requests / 12 tokens" in out.stdout


def test_cli_refuses_a_checkpoint_dir(tmp_path):
    """--ckpt-dir restores by the example tree {"params": ...}, as the
    reference does, so a training checkpoint (params and optimizer state)
    is refused; a params-only one is served (test_torch_checkpoint.py)."""
    model = LM(get_config(ARCH).smoke(), device="cpu")
    save_checkpoint(str(tmp_path), 2, {"params": model.params(),
                                       "opt": adamw.init(model.params())},
                    device="cpu")
    out = _cli("--arch", ARCH, "--device", "cpu", "--ckpt-dir",
               str(tmp_path))
    assert out.returncode != 0
    assert "ValueError" in out.stderr and "leaves for a tree of" in out.stderr
