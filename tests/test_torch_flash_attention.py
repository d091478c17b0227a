"""The port's flash attention (B3) against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages.  The
port's plain PyTorch version (what the op runs for CPU tensors) is held to
the JAX package's ``flash_attention`` through its Pallas kernel in interpret
mode and through its jnp oracle, at ``tests/test_kernels.py``'s tolerances
(2e-5 for f32; 2.5e-2 for bf16, where the two frameworks round the f32
result to bf16 from sums taken in another order).  The CUDA kernels are
held to the plain version on the card by ``chip_smoke.py``; here the
wrapper's checks and the build, which need no card, are tested, and the bf16
kernel's numerics are: a plain emulation of its tile algorithm (an online
softmax over key tiles, P rounded to bf16 before P V) is held to the JAX
package's reference with half the bf16 tolerance to spare.
"""
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_torch
from repro_torch.models import layers as L

REPO = Path(__file__).resolve().parents[1]
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

CASES = {  # tests/test_kernels.py's four, then a ragged T with GQA
    "f32_gqa": dict(B=2, T=128, H=4, Hkv=2, hd=64, window=None,
                    dtype=jnp.float32),
    "bf16_mqa": dict(B=1, T=256, H=4, Hkv=1, hd=64, window=None,
                     dtype=jnp.bfloat16),
    "f32_window": dict(B=2, T=256, H=8, Hkv=8, hd=32, window=64,
                       dtype=jnp.float32),
    "bf16_window_hd128": dict(B=1, T=384, H=2, Hkv=2, hd=128, window=128,
                              dtype=jnp.bfloat16),
    "f32_ragged48_gqa": dict(B=2, T=48, H=6, Hkv=2, hd=32, window=None,
                             dtype=jnp.float32),
    "bf16_ragged48_gqa": dict(B=1, T=48, H=6, Hkv=3, hd=64, window=16,
                              dtype=jnp.bfloat16),
}


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c["B"], c["T"], c["H"], c["hd"]))
    k = rng.normal(size=(c["B"], c["T"], c["Hkv"], c["hd"]))
    v = rng.normal(size=(c["B"], c["T"], c["Hkv"], c["hd"]))
    return [np.array(jnp.asarray(a, c["dtype"]), np.float32)
            for a in (q, k, v)]


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]


def _tile_emulation(q, k, v, window, tile):
    """What the bf16 tensor-core kernel computes, in plain PyTorch: S = Q K^T
    in f32 (bf16 products are exact there), an online softmax over tiles of
    ``tile`` keys with exp2 and scale * log2(e) folded in, the denominator
    from the f32 P, P rounded to bf16 before P V, and the final divide by
    max(l, 1e-30); the output in bf16."""
    B, T, H, hd = q.shape
    g = H // k.shape[2]
    qf = q.float().transpose(1, 2)                             # B, H, T, hd
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(g, dim=1)
              for x in (k, v))
    c = hd ** -0.5 * math.log2(math.e)
    m = torch.full((B, H, T), -math.inf)
    l = torch.zeros(B, H, T)
    acc = torch.zeros(B, H, T, hd)
    qpos = torch.arange(T)[:, None]
    for k0 in range(0, T, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        kpos = torch.arange(k0, min(k0 + tile, T))[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep &= qpos - kpos < window
        s = s.masked_fill(~keep, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        off = torch.where(m_new == -math.inf, 0.0, m_new * c)
        alpha = torch.exp2(m * c - off)
        p = torch.exp2(s * c - off[..., None])
        l = l * alpha + p.sum(-1)
        acc = (acc * alpha[..., None]
               + p.bfloat16().float() @ vf[:, :, k0:k0 + tile])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


# the bf16 cases, and a longer GQA sequence at hd 128 (the kernel's
# two-warpgroup, 128-key block)
EMULATED = dict({c: v for c, v in CASES.items() if v["dtype"] == jnp.bfloat16},
                bf16_T1024_hd128_gqa=dict(B=1, T=1024, H=4, Hkv=2, hd=128,
                                          window=None, dtype=jnp.bfloat16))


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("case", list(EMULATED))
def test_tile_algorithm_matches_reference_with_headroom(case, tile):
    """The bf16 kernel's algorithm, emulated at both of its key tiles, stays
    within half of 2.5e-2 of the JAX package's jnp oracle, so that the
    card's check at the full tolerance has room for the order of its
    sums."""
    c = EMULATED[case]
    arrays = _inputs(c, seed=5)
    want = np.asarray(jflash(*(jnp.asarray(a, c["dtype"]) for a in arrays),
                             window=c["window"], use_pallas=False),
                      np.float32)
    got = _tile_emulation(*_port(arrays, c["dtype"]), c["window"], tile)
    assert got.shape == (c["B"], c["T"], c["H"], c["hd"])
    err = np.abs(got.float().numpy() - want)
    tol = 2.5e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    assert (err / (tol + tol * np.abs(want))).max() <= 0.5


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "jnp_oracle"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_reference(case, use_pallas):
    c = CASES[case]
    arrays = _inputs(c)
    want = jflash(*(jnp.asarray(a, c["dtype"]) for a in arrays),
                  window=c["window"], use_pallas=use_pallas)
    got = flash_attention(*_port(arrays, c["dtype"]), window=c["window"])
    assert got.dtype == TORCH_DTYPES[c["dtype"]]
    assert got.shape == (c["B"], c["T"], c["H"], c["hd"])
    tol = 2.5e-2 if c["dtype"] == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_is_causal():
    """Future tokens must not influence earlier outputs."""
    rng = np.random.default_rng(1)
    B, T, H, hd = 1, 128, 2, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(
        np.float32)) for _ in range(3))
    o1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 10.0
    v2[:, -1] += 10.0
    o2 = flash_attention(q, k2, v2)
    np.testing.assert_allclose(o1[:, :-1].numpy(), o2[:, :-1].numpy(),
                               atol=1e-5)
    assert not np.allclose(o1[:, -1].numpy(), o2[:, -1].numpy(), atol=1e-5)


def test_window_hides_keys_outside_it():
    rng = np.random.default_rng(2)
    B, T, H, hd = 1, 64, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(
        np.float32)) for _ in range(3))
    o1 = attention_torch(q, k, v, window=8)
    k2 = k.clone()
    k2[:, 10] += 5.0
    o2 = attention_torch(q, k2, v, window=8)
    # key 10 is seen by queries 10..17 only
    np.testing.assert_allclose(o1[:, 18:].numpy(), o2[:, 18:].numpy(),
                               atol=1e-6)
    assert not np.allclose(o1[:, 10:18].numpy(), o2[:, 10:18].numpy(),
                           atol=1e-6)


def test_cpu_op_takes_the_plain_version():
    c = CASES["f32_gqa"]
    q, k, v = _port(_inputs(c, seed=3), c["dtype"])
    before = kernel.launches, dict(kernel.launches_by_path)
    got = flash_attention(q, k, v)
    assert (kernel.launches, kernel.launches_by_path) == before
    assert torch.equal(got, attention_torch(q, k, v))


def test_sdpa_prefix_equals_masked_attention():
    """The model's prefix path (the op) and its general masked path (the
    decode path's code) agree on a whole-sequence causal attention."""
    rng = np.random.default_rng(4)
    B, T, H, Hkv, hd = 2, 24, 4, 2, 32
    q = torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, T, Hkv, hd)).astype(
        np.float32)) for _ in range(2))
    pos = torch.arange(T)[None].expand(B, T)
    for window in (None, 5):
        a = L.sdpa(q, k, v, None, None, window, prefix=True)
        b = L.sdpa(q, k, v, pos, pos, window)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        L.sdpa(q, k, v, pos, pos, valid=torch.ones(B, T, dtype=torch.bool),
               prefix=True)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case,error", [
    ("cpu_tensors", ValueError), ("float64", TypeError),
    ("mixed_dtypes", TypeError), ("head_dim_48", ValueError),
    ("heads_not_multiple", ValueError), ("kv_shape", ValueError),
    ("requires_grad", ValueError), ("window_0", ValueError),
    ("strided_head_dim", ValueError), ("bf16_unaligned_start", ValueError),
    ("bf16_time_stride_not_8", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    q, k, v, window = _t(1, 8, 4, 32), _t(1, 8, 2, 32), _t(1, 8, 2, 32), None
    if case == "float64":
        q, k, v = (x.double() for x in (q, k, v))
    elif case == "mixed_dtypes":
        k = k.bfloat16()
    elif case == "head_dim_48":
        q, k, v = _t(1, 8, 4, 48), _t(1, 8, 2, 48), _t(1, 8, 2, 48)
    elif case == "heads_not_multiple":
        k, v = _t(1, 8, 3, 32), _t(1, 8, 3, 32)
    elif case == "kv_shape":
        k = _t(1, 7, 2, 32)
    elif case == "requires_grad":
        q.requires_grad_(True)
    elif case == "window_0":
        window = 0
    elif case == "strided_head_dim":
        q = _t(1, 8, 4, 64)[..., ::2]
    elif case == "bf16_unaligned_start":
        q, k, v = (x.bfloat16() for x in (q, k, v))
        q = _t(1, 8, 4, 33, dtype=torch.bfloat16)[..., 1:]
    elif case == "bf16_time_stride_not_8":
        q, k, v = (x.bfloat16() for x in (q, k, v))
        k = _t(1, 8, 2, 36, dtype=torch.bfloat16)[..., :32]
    before = kernel.launches, dict(kernel.launches_by_path)
    with pytest.raises(error) as exc:
        kernel.flash_attention_cuda(q, k, v, window)
    if case == "cpu_tensors":
        assert "CUDA" in str(exc.value)
    if case.startswith("bf16_"):
        assert "16-byte" in str(exc.value)
    assert (kernel.launches, kernel.launches_by_path) == before


@pytest.mark.parametrize("view", ["contiguous", "cache_slice", "f32_odd"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_wrapper_passes_what_the_kernels_take(hd, view):
    """bf16 at every head dim, contiguous or a slice of a longer KV cache,
    and f32 at any stride, pass every check but the device: on the CPU
    the wrapper then raises for the device alone and launches nothing."""
    B, T, H, Hkv = 2, 24, 4, 2
    dtype = torch.float32 if view == "f32_odd" else torch.bfloat16
    q = _t(B, T, H, hd, dtype=dtype)
    k, v = _t(B, T, Hkv, hd, dtype=dtype), _t(B, T, Hkv, hd, dtype=dtype)
    if view == "cache_slice":
        k, v = (_t(B, 4 * T, Hkv, hd, dtype=dtype)[:, :T] for _ in range(2))
    elif view == "f32_odd":
        q = _t(B, T, H, hd + 1, dtype=dtype)[..., 1:]
    before = kernel.launches, dict(kernel.launches_by_path)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.flash_attention_cuda(q, k, v, window=8)
    assert (kernel.launches, kernel.launches_by_path) == before


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_wrapper_takes_only_the_blocks_the_library_has(hd):
    """A forced block shape must be one the library compiled at this head
    dim, and only for bf16; every such shape passes to the device check."""
    q = _t(1, 8, 4, hd, dtype=torch.bfloat16)
    k = v = _t(1, 8, 2, hd, dtype=torch.bfloat16)
    assert set(kernel.blocks_for(hd)) < set(kernel.BLOCKS)
    for block in kernel.BLOCKS:
        match = ("needs CUDA tensors" if block in kernel.blocks_for(hd)
                 else "is not one of")
        with pytest.raises(ValueError, match=match):
            kernel.flash_attention_cuda(q, k, v, block=block)
    with pytest.raises(ValueError, match="is not one of"):
        kernel.flash_attention_cuda(q.float(), k.float(), v.float(),
                                    block=(1, 64))


def test_build_command_targets_sm90a_from_the_repo_source():
    lib = kernel.LIBRARY
    assert lib.source == (REPO / "src/repro_torch/kernels/flash_attention/"
                          "csrc/flash_attention.cu")
    cmd = lib.nvcc_command("nvcc", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(lib.source) in cmd


def test_no_library_attention_on_the_kernel_path():
    """No source of the kernel's package, Python or CUDA, calls a library's
    attention, a BLAS or the compiler of the plain version."""
    package = REPO / "src/repro_torch/kernels/flash_attention"
    files = sorted(f for f in package.rglob("*")
                   if f.suffix in (".py", ".cu", ".cuh", ".h", ".cpp")
                   and "build" not in f.relative_to(package).parts)
    assert package / "csrc/flash_attention.cu" in files
    for f in files:
        text = f.read_text()
        for banned in ("scaled_dot_product_attention", "cublas", "cudnn",
                       "torch.compile", "#include <torch"):
            assert banned not in text, (f, banned)
