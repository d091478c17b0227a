"""The port's relay and compressed collectives against the JAX package's.

* The analytic relay and naive-fan-out estimates equal the reference's.
* On 8 spawned gloo ranks (``torch_gloo.collectives``) with the inputs of
  ``tests/test_collectives.py``, each rank's relay broadcast (from rank 0,
  and from rank 3, where the ranks before it stay at zeros), naive
  broadcast and ring all-gather equal the reference's slice for that
  device, bit for bit; the reference runs under ``shard_map`` on 8
  simulated devices in a JAX subprocess.
* On 4 of those ranks, ``psum_compressed`` of one row each equals the
  reference's on 4 devices within one int8 step (the smallest source's
  scale): both gather the same int8 rows and scales, but XLA compiles the
  dequantizing multiply and the mean into one fused reduction, which
  rounds differently from the port's eager multiply, then sum, so the last
  bit of a mean can differ (by 6e-8 here).
* ``quantize_int8`` equals the reference's bit for bit on a seeded array
  with exact .5 ties (both round half to even).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gloo
from conftest import jax_subprocess_env
from repro.core import relay_collectives as JRC
from repro.optim import grad_compress as JGC
from repro_torch.core import relay_collectives as RC
from repro_torch.optim import grad_compress as GC

REPO = Path(__file__).resolve().parents[1]
X = np.arange(8 * 16 * 4, dtype=np.float32).reshape(8 * 16, 4)
Y = np.arange(8 * 4.0, dtype=np.float32).reshape(8, 4)
G = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)

_REF = textwrap.dedent("""
    import functools, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.core.relay_collectives import (naive_broadcast_inner,
                                              relay_broadcast_inner,
                                              ring_all_gather_inner)
    from repro.optim.grad_compress import psum_compressed
    x, y, g = (np.load(sys.argv[1])[k] for k in ("x", "y", "g"))
    mesh = jax.make_mesh((8,), ("pod",))

    def run(fn, a, m=mesh):
        f = jax.jit(shard_map(fn, mesh=m, in_specs=(P("pod"),),
                              out_specs=P("pod")))
        return np.asarray(f(jnp.asarray(a)))
    out = {}
    for src in (0, 3):
        out[f"relay_src{src}"] = run(functools.partial(
            relay_broadcast_inner, axis_name="pod", axis_size=8, src=src,
            n_chunks=4), x)
    out["naive"] = run(functools.partial(
        naive_broadcast_inner, axis_name="pod", axis_size=8, src=0), x)
    out["ring"] = run(functools.partial(
        ring_all_gather_inner, axis_name="pod", axis_size=8), y)
    four = jax.make_mesh((4,), ("pod",), devices=jax.devices()[:4])
    out["compressed"] = run(functools.partial(psum_compressed,
                                              axis_name="pod"), g, four)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """(each rank's results, the reference's outputs split by device)."""
    tmp = tmp_path_factory.mktemp("collectives")
    np.savez(tmp / "in.npz", x=X, y=Y, g=G)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], cwd=REPO,
        env=dict(jax_subprocess_env(devices=8),
                 PYTHONPATH=str(REPO / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = torch_gloo.run("collectives", 8, tmp, x=X, y=Y, g=G)
    log = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, log[-3000:]
    want = dict(np.load(tmp / "ref.npz"))
    return ranks, {k: np.split(v, 4 if k == "compressed" else 8)
                   for k, v in want.items()}


def test_estimates_equal_reference():
    for p in (1, 2, 4, 8):
        for n in (1, 2, 8, 16):
            for nbytes, bw in ((1e9, 50e9), (7.3e15, 12.5e9)):
                assert RC.estimate_relay_time(nbytes, bw, p, n) == \
                    JRC.estimate_relay_time(nbytes, bw, p, n)
                assert RC.estimate_naive_time(nbytes, bw, p) == \
                    JRC.estimate_naive_time(nbytes, bw, p)
    assert RC.estimate_relay_time(1e9, 50e9, 8, 16) < \
        RC.estimate_relay_time(1e9, 50e9, 8, 2)


@pytest.mark.parametrize("case", ["relay_src0", "relay_src3", "naive",
                                  "ring"])
def test_point_to_point_collectives_equal_reference(eight, case):
    ranks, want = eight
    for r, res in enumerate(ranks):
        assert "error" not in res[case], res[case]
        np.testing.assert_array_equal(res[case], want[case][r])
    if case == "relay_src3":       # the chain leaves the ranks before 3 at 0
        assert not ranks[1][case].any() and ranks[5][case].any()


def test_compressed_mean_equals_reference(eight):
    ranks, want = eight
    step = float(np.min(np.max(np.abs(G), axis=1))) / 127.0
    for r in range(4):
        got = ranks[r]["compressed"]
        assert "error" not in got, got
        np.testing.assert_allclose(got, want["compressed"][r], rtol=0,
                                   atol=step)
        np.testing.assert_array_equal(got, ranks[0]["compressed"])
    assert "compressed" not in ranks[4]


def test_quantize_int8_bit_equal_with_ties():
    """Max |x| = 127 makes the scale 1, so x / scale lands on exact .5
    ties, which both packages round half to even."""
    rng = np.random.default_rng(5)
    ties = np.arange(-20.5, 21.0, 1.0)
    x = np.concatenate([[127.0], ties, rng.normal(size=256) * 40]
                       ).astype(np.float32)
    for arr in (x, x[1:] * 3.7):
        q, s = GC.quantize_int8(torch.from_numpy(arr))
        jq, js = JGC.quantize_int8(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)
        np.testing.assert_array_equal(
            GC.dequantize_int8(q, s).numpy(),
            np.asarray(JGC.dequantize_int8(jq, js)))
        assert GC.compression_error(torch.from_numpy(arr)).item() == \
            float(JGC.compression_error(jnp.asarray(arr)))
    assert np.array_equal(GC.quantize_int8(torch.from_numpy(x))[0][1:4]
                          .numpy(), [-20, -20, -18])   # half to even
