"""The port's selective scan (B4) against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages, drawn as
``tests/test_kernels.py`` draws them, or at falcon-mamba's own range of A and
dt (``_model_inputs``).  The port's plain PyTorch version (what the op runs
for CPU tensors) is held to the JAX package's ``selective_scan`` through its
Pallas kernel in interpret mode and to its sequential ``selective_scan_ref``,
at ``tests/test_kernels.py``'s rtol/atol 1e-4.  So is ``_kernel_order_scan``,
a plain emulation of the CUDA kernel's arithmetic order at each layout.  The
CUDA kernel is held to the plain version on the card by ``chip_smoke.py``;
here only the layout choice, the wrapper's checks and the build, which need
no card, are tested.
"""
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import selective_scan as jscan
from repro.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.mamba_scan import mamba_scan as kernel
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card's cases; imports no torch or jax)
from repro_torch.serve.engine import _bucket  # noqa: E402
SHAPES = [  # tests/test_kernels.py's five
    (1, 32, 64, 8), (2, 64, 128, 16), (2, 128, 256, 16),
    (1, 96, 300, 8),     # non-aligned D
    (3, 100, 128, 4),    # non-aligned T
]


def _inputs(shape, seed=42, zero_h0=False):
    B, T, D, N = shape
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, T, D))
    dt = rng.uniform(0.01, 0.2, (B, T, D))
    Bm = rng.normal(size=(B, T, N))
    Cm = rng.normal(size=(B, T, N))
    A = -rng.uniform(0.5, 2.0, (D, N))
    h0 = np.zeros((B, D, N)) if zero_h0 else rng.normal(size=(B, D, N))
    return [a.astype(np.float32) for a in (u, dt, Bm, Cm, A, h0)]


def _model_inputs(shape, seed=43):
    """A and dt as falcon-mamba's Mamba1 layer makes them
    (``models/ssm.py``): A = -(1..N) for every channel, dt = softplus of a
    projection with a zero bias, here of a standard normal."""
    B, T, D, N = shape
    u, _, Bm, Cm, _, h0 = _inputs(shape, seed)
    rng = np.random.default_rng(seed + 1)
    dt = np.logaddexp(0.0, rng.normal(size=(B, T, D)))
    A = -np.tile(np.arange(1, N + 1, dtype=np.float64), (D, 1))
    return [u, dt.astype(np.float32), Bm, Cm, A.astype(np.float32), h0]


def _kernel_order_scan(u, dt, Bm, Cm, A, h0, layout):
    """The CUDA kernel's arithmetic, in plain float32 PyTorch: exp2 of
    dt * (A * log2 e), dt * u formed once a step, and y summed state by
    state over each of the channel's ``layout`` threads' N / layout states,
    then across the threads by xor-shuffle pairs ((0+1) + (2+3))."""
    B, T, D = u.shape
    N = A.shape[1]
    S = N // layout
    a2 = A * torch.tensor(1.4426950408889634, dtype=torch.float32)
    h = h0.clone()
    ys = []
    for t in range(T):
        dtv = dt[:, t, :, None]
        dtu = (dt[:, t] * u[:, t])[..., None]
        h = torch.exp2(dtv * a2) * h + dtu * Bm[:, t, None, :]
        prod = (h * Cm[:, t, None, :]).reshape(B, D, layout, S)
        part = prod[..., 0]
        for k in range(1, S):
            part = part + prod[..., k]
        while part.shape[-1] > 1:              # xor 1, then xor 2
            part = part[..., 0::2] + part[..., 1::2]
        ys.append(part[..., 0])
    return torch.stack(ys, dim=1), h


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("reference", ["pallas_interpret", "sequential_ref"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_reference(shape, reference):
    arrays = _inputs(shape)
    jin = [jnp.asarray(a) for a in arrays]
    if reference == "pallas_interpret":
        y_want, h_want = jscan(*jin, use_pallas=True)
    else:
        y_want, h_want = selective_scan_ref(*jin)
    y, hT = selective_scan(*(torch.from_numpy(a) for a in arrays))
    assert y.shape == shape[:3] and hT.shape == (shape[0], shape[2],
                                                 shape[3])
    _close(y, y_want)
    _close(hT, h_want)


def test_state_continuity():
    """Scanning [0:T] equals scanning [0:T/2] then [T/2:T] with carried h,
    in the port and against the JAX package's full scan."""
    u, dt, Bm, Cm, A, h0 = (torch.from_numpy(a) for a in
                            _inputs((1, 64, 128, 8), seed=7, zero_h0=True))
    y_full, h_full = selective_scan(u, dt, Bm, Cm, A, h0)
    h, ys = h0, []
    for sl in (slice(0, 32), slice(32, 64)):
        y, h = selective_scan(u[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], A, h)
        ys.append(y)
    _close(torch.cat(ys, 1), y_full)
    _close(h, h_full)
    y_want, h_want = jscan(*(jnp.asarray(x.numpy()) for x in
                             (u, dt, Bm, Cm, A, h0)))
    _close(torch.cat(ys, 1), y_want)
    _close(h, h_want)


def test_strided_views_scan_like_contiguous_copies():
    """B and C come to the op as slices of one projection (as in
    mamba1_block); the plain version reads them as they are."""
    u, dt, _, _, A, h0 = (torch.from_numpy(a) for a in
                          _inputs((2, 20, 64, 8), seed=5))
    proj = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 20, 3 + 16)).astype(np.float32))
    Bm, Cm = proj[..., 3:11], proj[..., 11:]
    a = selective_scan(u, dt, Bm, Cm, A, h0)
    b = selective_scan(u, dt, Bm.contiguous(), Cm.contiguous(), A, h0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_op_takes_the_plain_version():
    ins = [torch.from_numpy(a) for a in _inputs((1, 16, 32, 4), seed=8)]
    before = kernel.launches
    y, hT = selective_scan(*ins)
    assert kernel.launches == before
    y2, h2 = selective_scan_torch(*ins)
    assert torch.equal(y, y2) and torch.equal(hT, h2)


@pytest.mark.parametrize("case,error", [
    ("cpu_tensors", ValueError), ("float64", TypeError),
    ("state_3", ValueError), ("state_64", ValueError),
    ("dt_shape", ValueError), ("h0_strided", ValueError),
    ("u_strided", ValueError), ("requires_grad", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    B, T, D, N = 1, 8, 16, 4
    if case == "state_3":
        N = 3
    elif case == "state_64":
        N = 64
    u, dt, Bm, Cm, A, h0 = (torch.zeros(s) for s in (
        (B, T, D), (B, T, D), (B, T, N), (B, T, N), (D, N), (B, D, N)))
    if case == "float64":
        dt = dt.double()
    elif case == "dt_shape":
        dt = torch.zeros(B, T, D + 1)
    elif case == "h0_strided":
        h0 = torch.zeros(B, N, D).transpose(1, 2)
    elif case == "u_strided":
        u = torch.zeros(B, T, 2 * D)[..., ::2]
    elif case == "requires_grad":
        u.requires_grad_(True)
    before = kernel.launches
    with pytest.raises(error) as exc:
        kernel.selective_scan_cuda(u, dt, Bm, Cm, A, h0)
    if case == "cpu_tensors":
        assert "CUDA" in str(exc.value)
    assert kernel.launches == before


def test_build_command_targets_sm90a_from_the_repo_source():
    lib = kernel.LIBRARY
    assert lib.source == (REPO / "src/repro_torch/kernels/mamba_scan/csrc/"
                          "mamba_scan.cu")
    cmd = lib.nvcc_command("nvcc", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(lib.source) in cmd
    source = lib.source.read_text()
    # exp(x) as one ex2.approx of x * log2(e), with log2(e) folded into A
    assert "ex2.approx.ftz.f32" in source and "kLog2e" in source
    assert "__expf(" not in source


@pytest.mark.parametrize("layout", kernel.LAYOUTS)
@pytest.mark.parametrize("case", [
    ("long", (1, 4096, 16, 16), "test"),
    ("long_model_range", (1, 4096, 16, 16), "model"),
    ("serve_model_range", (2, 256, 64, 16), "model")], ids=lambda c: c[0])
def test_kernel_arithmetic_order_matches_reference(case, layout):
    """The reordered math (exp2 with log2 e folded into A, y summed per
    thread then across the channel's threads), not only the plain version,
    holds rtol/atol 1e-4 over 4096 steps and at the model's range, where
    |dt * A| reaches tens."""
    _, shape, kind = case
    arrays = (_model_inputs if kind == "model" else _inputs)(shape)
    y_want, h_want = selective_scan_ref(*(jnp.asarray(a) for a in arrays))
    y, hT = _kernel_order_scan(*(torch.from_numpy(a) for a in arrays),
                               layout)
    _close(y, y_want)
    _close(hT, h_want)


@pytest.mark.parametrize("reference", ["pallas_interpret", "sequential_ref"])
def test_plain_version_matches_reference_at_model_range(reference):
    arrays = _model_inputs((2, 256, 64, 16))
    jin = [jnp.asarray(a) for a in arrays]
    if reference == "pallas_interpret":
        y_want, h_want = jscan(*jin, use_pallas=True)
    else:
        y_want, h_want = selective_scan_ref(*jin)
    y, hT = selective_scan(*(torch.from_numpy(a) for a in arrays))
    _close(y, y_want)
    _close(hT, h_want)


# falcon-mamba-7b's prefill waves: chip_smoke.py's serving run (4 slots,
# prompts of up to a quarter of its 1024-token cache) and launch.serve's
# defaults (4 slots, a 256-token cache); d_inner 8192, N 16
SERVE_SCANS = [("chip_smoke_serve", 4, _bucket(chip_smoke.SERVE["max_seq"]
                                               // 4 - 1), 8192, 16),
               ("launch_serve_defaults", 4, _bucket(256 // 4 - 1), 8192,
                16)]
WANT_LAYOUT = {"main": 1, "ragged": 4, "long": 2, "model_range": 1,
               "example_serve_T32": 4, "example_serve_T16": 4,
               "chip_smoke_serve": 1, "launch_serve_defaults": 1}


@pytest.mark.parametrize("case", [c[:5] for c in chip_smoke.SCAN_CASES]
                         + SERVE_SCANS, ids=lambda c: c[0])
def test_layout_for_picks_a_valid_layout(case):
    label, B, T, D, N = case
    layout = kernel.layout_for(B, D, N)
    assert layout in kernel.LAYOUTS and N % layout == 0
    assert layout == WANT_LAYOUT[label]
    # the fewest threads a channel that reach WAVE_THREADS, else the most
    fewer = [x for x in kernel.LAYOUTS if x < layout]
    assert all(B * D * x < kernel.WAVE_THREADS for x in fewer)
    assert (B * D * layout >= kernel.WAVE_THREADS
            or layout == kernel.LAYOUTS[-1])


def test_library_layout_rule_matches_layout_for():
    """The C library picks its own layout in ``repro_selective_scan`` by the
    same threshold (phase 8 also compares the two picks on the card)."""
    source = kernel.LIBRARY.source.read_text()
    found = re.search(r"kWaveThreads = (\d+);", source)
    assert found and int(found.group(1)) == kernel.WAVE_THREADS
    assert "int repro_selective_scan_layout_for(" in source
    assert "int repro_selective_scan_layout(" in source


@pytest.mark.parametrize("layout", [0, 3, 8, "1"])
def test_wrapper_rejects_an_unknown_layout_before_any_build(layout,
                                                            monkeypatch):
    def no_build():
        raise AssertionError("the library was built")
    monkeypatch.setattr(kernel.LIBRARY, "build", no_build)
    ins = [torch.from_numpy(a) for a in _inputs((1, 8, 16, 4))]
    before = kernel.launches
    with pytest.raises(ValueError, match="layout"):
        kernel.selective_scan_cuda(*ins, layout=layout)
    assert kernel.launches == before
