"""The port's lane segment step against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages.  The
port's plain PyTorch version (``device="cpu"``) must equal the JAX package's
numpy reference bit for bit, NaN in the same places, because the ensemble's
lane-0 gate is float-exact.  It is also held to the Pallas kernel itself in
interpret mode, in a subprocess with x64 enabled (the installed jax has no
scoped x64 switch, so the JAX package's own wrapper cannot run it), within
the tolerance of ``tests/test_ensemble.py``: XLA may contract
``bd + rate * t`` into a fused multiply-add there.  The CUDA kernel is held
to the plain version on the card by ``chip_smoke.py``; here only the
wrapper's checks and build command, which need no card, are tested.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import jax_subprocess_env

from repro.kernels.lane_step.ref import lane_segment_step_np as jref_step
from repro_torch.ensemble.batch import make_segment_fn
from repro_torch.kernels.lane_step import lane_step as kernel
from repro_torch.kernels.lane_step import ref
from repro_torch.kernels.lane_step.ops import lane_segment_step
from repro_torch.kernels.nvcc import CudaLibrary

REPO = Path(__file__).resolve().parents[1]
NAMES = ("t_left", "new_bytes", "adv", "moved", "hit")


def _ensemble_inputs(shape, seed=7):
    """Drawn as tests/test_ensemble.py draws its backend inputs."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 3600.0, size=shape)
    bd = rng.uniform(0.0, 1e12, size=shape)
    rate = np.where(rng.random(shape) < 0.2, 0.0,
                    rng.uniform(1e6, 1e9, size=shape))
    bound = bd + rng.uniform(0.0, 1e11, size=shape)
    return t, bd, rate, bound


def _edge_inputs(shape, seed=3):
    """Random rows with edge cases written over some of them: rate 0,
    negative and NaN; bound below bytes_done; t 0 and inf; a boundary
    exactly reached; a NaN bound; signed zeros."""
    t, bd, rate, bound = (a.copy() for a in _ensemble_inputs(shape, seed))
    edges = [  # (t, bytes_done, rate, bound)
        (10.0, 5.0, 0.0, 100.0), (10.0, 5.0, -3.0, 100.0),
        (10.0, 5.0, np.nan, 100.0), (10.0, 100.0, 2.0, 50.0),
        (0.0, 5.0, 2.0, 100.0), (np.inf, 5.0, 2.0, 100.0),
        (np.inf, 5.0, 0.0, 100.0), (10.0, 0.0, 10.0, 100.0),
        (10.0, 5.0, 2.0, np.nan), (0.0, 0.0, 1.0, -0.0),
        (np.nan, 5.0, 2.0, 100.0), (10.0, 5.0, np.inf, 100.0),
        (10.0, 5.0, 2.0, np.inf), (5e-324, 1e300, 1e-300, 1e308)]
    flat = [a.reshape(-1) for a in (t, bd, rate, bound)]
    step = max(1, flat[0].size // len(edges))
    for k, row in enumerate(edges):
        for a, v in zip(flat, row):
            a[k * step] = v
    return t, bd, rate, bound


CASES = {
    "ensemble_16x8": lambda: _ensemble_inputs((16, 8)),
    "edges_13x301": lambda: _edge_inputs((13, 301)),
    "edges_8x128": lambda: _edge_inputs((8, 128), seed=5),
    "ensemble_3x1": lambda: _ensemble_inputs((3, 1), seed=11),
}


def assert_bit_equal(got, want, name):
    """Equal bit patterns wherever ``want`` is not NaN (so -0.0 != 0.0),
    and NaN in the same places."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
    np.testing.assert_array_equal(got[~nan].view(np.int64),
                                  want[~nan].view(np.int64), err_msg=name)


def _run_plain(inputs):
    out = ref.lane_segment_step_torch(*(torch.from_numpy(a) for a in inputs))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_bit_equal_to_reference(case):
    inputs = CASES[case]()
    with np.errstate(invalid="ignore", over="ignore"):
        want = jref_step(*inputs)
        port_np = ref.lane_segment_step_np(*inputs)
    for got, w, name in zip(_run_plain(inputs), want, NAMES):
        assert_bit_equal(got, w, name)
    for got, w, name in zip(port_np, want, NAMES):
        assert_bit_equal(got, w, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_torch_backend_on_cpu_are_bit_equal(case):
    t, bd, rate, bound = CASES[case]()
    with np.errstate(invalid="ignore", over="ignore"):
        want = jref_step(t, bd, rate, bound)
    op = lane_segment_step(t, bd, rate, bound, device="cpu")
    assert all(o.device.type == "cpu" for o in op)
    seg = make_segment_fn("torch", "cpu")(t, bd, rate, bound)
    for o, s, w, name in zip(op, seg, want, NAMES):
        assert isinstance(s, np.ndarray)
        assert_bit_equal(o.numpy(), w, name)
        assert_bit_equal(s, w, name)


def test_op_broadcasts_t_per_lane():
    """The engine's ``rem`` is [lane, row]; a per-lane column or a scalar
    broadcasts the same way numpy's reference broadcasts it."""
    _, bd, rate, bound = _ensemble_inputs((6, 40))
    for t in (np.linspace(0.0, 3600.0, 6)[:, None], 1800.0):
        with np.errstate(invalid="ignore", over="ignore"):
            want = jref_step(t, bd, rate, bound)
        got = lane_segment_step(t, bd, rate, bound, device="cpu")
        for o, w, name in zip(got, want, NAMES):
            assert_bit_equal(o.numpy(), w, name)


# --------------------------------------------------- the Pallas kernel itself
_PALLAS_SCRIPT = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.kernels.lane_step.lane_step import lane_step_pallas
d = np.load(sys.argv[1])
out = {}
for case in sorted({k.split("/")[0] for k in d.files}):
    ins = [jnp.asarray(d[f"{case}/{k}"]) for k in ("t", "bd", "rate", "bound")]
    res = lane_step_pallas(*ins, interpret=True)
    for name, o in zip(("t_left", "new_bytes", "adv", "moved", "hit"), res):
        out[f"{case}/{name}"] = np.asarray(o)
np.savez(sys.argv[2], **out)
"""


def _pad(x, Lp, Rp):
    out = np.zeros((Lp, Rp), dtype=np.float64)
    out[:x.shape[0], :x.shape[1]] = x
    return out


@pytest.fixture(scope="module")
def pallas_outputs(tmp_path_factory):
    """Every case through ``lane_step_pallas(interpret=True)`` in one x64
    subprocess, on inputs padded to the kernel's 8 x 128 tiles (pad slots
    get rate 0, so they never hit); the padding is cut off again."""
    tmp = tmp_path_factory.mktemp("pallas")
    ins, shapes = {}, {}
    for case, make in CASES.items():
        t, bd, rate, bound = make()
        L, R = bd.shape
        Lp, Rp = -(-L // 8) * 8, -(-R // 128) * 128
        shapes[case] = (L, R)
        for k, a in (("t", t), ("bd", bd), ("rate", rate), ("bound", bound)):
            ins[f"{case}/{k}"] = _pad(a, Lp, Rp)
    np.savez(tmp / "in.npz", **ins)
    env = dict(jax_subprocess_env(x64=True), PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT,
                           str(tmp / "in.npz"), str(tmp / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    d = np.load(tmp / "out.npz")
    return {case: [d[f"{case}/{n}"][:L, :R] for n in NAMES]
            for case, (L, R) in shapes.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_kernel(case, pallas_outputs):
    """Four outputs exactly equal; ``new_bytes`` within the tolerance of
    tests/test_ensemble.py (the Pallas side may fuse a multiply-add)."""
    got = _run_plain(CASES[case]())
    for g, p, name in zip(got, pallas_outputs[case], NAMES):
        assert p.dtype == g.dtype, name
        if name == "new_bytes":
            np.testing.assert_allclose(g, p, rtol=1e-12, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, p, err_msg=name)


# ------------------------------------------------------- the kernel's wrapper
def _tensors(shape=(4, 8), dtype=torch.float64, device="cpu"):
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(4)]


@pytest.mark.parametrize("case", ["cpu", "dtype_on_cpu", "meta", "op_meta",
                                  "op_cuda_without_cuda"])
def test_kernel_wrapper_raises_instead_of_falling_back(case):
    """The wrapper launches only on float64 CUDA tensors; anything else
    raises before a launch, and the launch count does not move."""
    before = kernel.launches
    if case == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            kernel.lane_step_cuda(*_tensors())
    elif case == "dtype_on_cpu":
        with pytest.raises(TypeError, match="float64"):
            kernel.lane_step_cuda(*_tensors(dtype=torch.float32))
    elif case == "meta":
        with pytest.raises(ValueError, match="CUDA"):
            kernel.lane_step_cuda(*_tensors(device="meta"))
    elif case == "op_meta":
        with pytest.raises(ValueError, match="meta"):
            lane_segment_step(*(np.zeros((2, 3)) for _ in range(4)),
                              device="meta")
    else:
        if torch.cuda.is_available():
            pytest.skip("this case checks a machine without CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lane_segment_step(*(np.zeros((2, 3)) for _ in range(4)))
    assert kernel.launches == before


def test_build_command_targets_hopper_from_package_source():
    cmd = kernel.LIBRARY.nvcc_command("nvcc", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    src = Path(cmd[-1])
    assert src.name == "lane_step.cu" and src.is_file()
    pkg = Path(kernel.__file__).resolve().parent
    assert pkg in src.parents
    assert kernel.LIBRARY.library_path().parent == pkg / "build"
    assert kernel.LIBRARY.library_path().name.startswith("liblane_step_")


def test_kernel_source_never_contracts_into_fma():
    """Every floating-point product and sum in the kernel is a rounding
    intrinsic, so nvcc cannot fuse ``bd + rate * t``."""
    body = (Path(kernel.__file__).parent / "csrc" / "lane_step.cu").read_text()
    code = body[body.index("__global__"):body.index("}  // namespace")]
    for op in ("__dsub_rn(bo, b)", "__ddiv_rn(ahead, r)",
               "__dadd_rn(b, __dmul_rn(r, ti))", "__dmul_rn(r, adv)",
               "__dsub_rn(ti, need)"):
        assert op in code, op
    assert "fmax" not in code


@pytest.mark.parametrize("nvcc_ok", [True, False])
def test_cuda_library_builds_once_per_source(tmp_path, monkeypatch, nvcc_ok):
    """The shared builder runs nvcc once per source digest, keeps its
    output, and on a failed build raises and leaves no library behind."""
    src = tmp_path / "pkg" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// v1\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        + ('echo lib > "$2"\necho "ptxas info : Used 3 registers" >&2\n'
           if nvcc_ok else 'echo "error: bad source" >&2\nexit 1\n'))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    lib = CudaLibrary(src, "k", lambda cdll: None)
    if not nvcc_ok:
        with pytest.raises(RuntimeError, match="bad source"):
            lib.build()
        assert not list((tmp_path / "pkg" / "build").iterdir())
        return
    first = lib.build()
    assert first.parent == tmp_path / "pkg" / "build" and first.is_file()
    assert "Used 3 registers" in lib.build_log
    assert lib.build() == first
    assert calls.read_text().count("x") == 1
    src.write_text("// v2\n")
    assert lib.library_path() != first
