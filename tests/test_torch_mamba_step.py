"""Mamba1's single decode step (``kernels/mamba_scan`` ``conv_step`` and
``state_step``): on the CPU the plain versions against the model's previous
T == 1 code, kept below as the yardstick, bit for bit; the CUDA wrappers'
refusals; meta tensors' shapes; and ``mamba1_block`` at T == 1.  On the card
(the ``card`` marker; skipped without CUDA) the two kernels against the
plain versions, in one CUDA graph and eagerly, and their launch counts:

    python -m pytest tests/test_torch_mamba_step.py -m card

Tolerances on the card, each with its reason:

* the new conv state and xc (f32 and in the activations' dtype) are the
  plain version's bit for bit: the kernel sums the taps in the eager order
  with no FMA, and its SiLU is PyTorch's formula with the same ``expf``.
* the new h: rtol/atol 1e-4, B4's (``chip_smoke.py`` phase 8).  dt is a
  256-term f32 dot product summed in another order than cuBLAS's, and
  exp(dt A) carries dt's relative error into h multiplied by |dt A|, up to
  tens at falcon-mamba's A = -(1..16).
* y in bf16: rtol 2^-7 (one bf16 step; two values within f32 rounding of
  each other may round to neighbouring bf16 numbers) and atol 1e-4; in f32
  rtol/atol 1e-4, as h.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import mamba_step as K
from repro_torch.kernels.mamba_scan import ops, ref
from repro_torch.models import ssm as SSM
from repro_torch.models.config import SSMNormConfig, option
from repro_torch.models.layers import rmsnorm
from repro_torch.models.model import count_mamba1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ARCH = "falcon-mamba-7b"


# ---------------------------------------------- the previous T == 1 code
def _old_causal_conv1d(x, w, bias, state):
    B, T, C = x.shape
    dk = w.shape[0]
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for i in range(dk):
        y = y + xp[:, i:i + T, :].float() * w[i].float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), xp[:, T:, :]


def _old_step(p, cfg, x, state):
    """``models/ssm.py mamba1_block`` before the step ops, at T == 1 with a
    state (its sharding constraints, no-ops here, left out)."""
    s = cfg.ssm
    B, T, d = x.shape
    dt_rank = max(1, d // 16)
    xz = x @ p["in_x"]
    z = x @ p["in_z"]
    xc, new_conv = _old_causal_conv1d(xz, p["conv_w"], p["conv_b"],
                                      state.conv)
    xc = F.silu(xc.float())
    proj = (xc.to(x.dtype) @ p["x_proj"]).float()
    dt, B_, C_ = torch.split(proj, [dt_rank, s.d_state, s.d_state], dim=-1)
    if option(s, "dt_bc_norm"):
        dt = rmsnorm(p["dt_norm"], dt, cfg.norm_eps)
        B_ = rmsnorm(p["b_norm"], B_, cfg.norm_eps)
        C_ = rmsnorm(p["c_norm"], C_, cfg.norm_eps)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = state.h
    a = torch.exp(dt[:, 0, :, None] * A)
    h = a * h0 + (dt[:, 0] * xc[:, 0])[..., None] * B_[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_[:, 0])[:, None]
    y = y + p["D"] * xc
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    return out, SSM.Mamba1State(new_conv, h), xc


# ------------------------------------------------------------------ inputs
def _cfg(norm: bool = False):
    cfg = get_config(ARCH).smoke()
    if norm:
        cfg = cfg.with_(ssm=SSMNormConfig(**dataclasses.asdict(cfg.ssm)))
    return cfg


def _layer(cfg, dtype, trained: bool = False, seed: int = 0,
           device="cpu", batch: int = 3, prefilled: bool = True):
    """(params, x (B, 1, d), state) of one Mamba1 layer: the init's
    weights, with dt_bias, D, conv_b and the norms' scales made non-trivial;
    ``trained`` casts dt_bias, A_log and D to bf16, as an optimizer step
    leaves them.  ``prefilled`` gives the conv state as prefill leaves it, a
    view of the last K-1 rows of a longer window."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = SSM.init_mamba1(gen, cfg, dtype)
    d_in = p["D"].shape[0]

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=device)).to(dt)
    p["dt_bias"] = rnd(d_in, scale=0.5)
    p["D"] = 1.0 + rnd(d_in, scale=0.1)
    p["conv_b"] = rnd(d_in, scale=0.1, dt=dtype)
    for key in ("dt_norm", "b_norm", "c_norm"):
        if key in p:
            n = p[key]["scale"].shape[0]
            p[key] = {"scale": 1.0 + rnd(n, scale=0.1, dt=dtype)}
    if trained:
        for key in ("dt_bias", "A_log", "D"):
            p[key] = p[key].to(torch.bfloat16)
    B, K = batch, cfg.ssm.d_conv
    x = rnd(B, 1, cfg.d_model, dt=dtype)
    window = rnd(B, K + 5, d_in, dt=torch.bfloat16 if dtype ==
                 torch.bfloat16 else dtype)
    conv = window[:, 6:] if prefilled else window[:, :K - 1].contiguous()
    h = rnd(B, d_in, cfg.ssm.d_state)
    return p, x, SSM.Mamba1State(conv, h)


CASES = [pytest.param(dt, norm, trained, id=f"{str(dt)[6:]}"
                      f"{'-norm' if norm else ''}"
                      f"{'-trained' if trained else ''}")
         for dt in (torch.float32, torch.bfloat16) for norm in (False, True)
         for trained in (False, True)]


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("dtype, norm, trained", CASES)
def test_block_step_is_the_previous_code_bit_for_bit(dtype, norm, trained):
    cfg = _cfg(norm)
    p, x, state = _layer(cfg, dtype, trained)
    want, want_state, _ = _old_step(p, cfg, x, state)
    got, got_state = SSM.mamba1_block(p, cfg, x, state)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert got_state.conv.dtype == want_state.conv.dtype
    assert torch.equal(got_state.conv, want_state.conv)
    assert torch.equal(got_state.h, want_state.h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_conv_step_is_the_previous_conv(dtype):
    cfg = _cfg()
    p, x, state = _layer(cfg, dtype)
    xz = x @ p["in_x"]
    xc, xc_act, new = ref.conv_step_torch(xz, state.conv, p["conv_w"],
                                          p["conv_b"])
    y, want_new = _old_causal_conv1d(xz, p["conv_w"], p["conv_b"],
                                     state.conv)
    want = F.silu(y.float())
    assert xc.dtype == torch.float32 and torch.equal(xc, want)
    assert xc_act.dtype == dtype and torch.equal(xc_act, want.to(dtype))
    assert torch.equal(new, want_new)
    # the ops take the plain versions for CPU tensors
    got = ops.conv_step(xz, state.conv, p["conv_w"], p["conv_b"])
    assert all(torch.equal(a, b) for a, b in zip(got, (xc, xc_act, new)))


def test_mamba1_block_prefill_then_steps_match_the_forward():
    """The step continues prefill's state: prefill of 9 tokens, then 3
    steps, equals the forward over 12 (f32, the scan's sum order apart)."""
    cfg = _cfg()
    p, _, _ = _layer(cfg, torch.float32)
    x = torch.randn(2, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    full, _ = SSM.mamba1_block(p, cfg, x)
    d_in = p["D"].shape[0]
    state = SSM.Mamba1State(
        torch.zeros(2, cfg.ssm.d_conv - 1, d_in, dtype=torch.bfloat16),
        torch.zeros(2, d_in, cfg.ssm.d_state))
    outs = []
    y, state = SSM.mamba1_block(p, cfg, x[:, :9], state, return_state=True)
    outs.append(y)
    for t in range(9, 12):
        y, state = SSM.mamba1_block(p, cfg, x[:, t:t + 1], state)
        outs.append(y)
    assert state.conv.dtype == torch.float32
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-5,
                               atol=1e-5)


def _state_args(cfg, p, x, state):
    xz, z = x @ p["in_x"], x @ p["in_z"]
    xc, xc_act, _ = ref.conv_step_torch(xz, state.conv, p["conv_w"],
                                        p["conv_b"])
    R, N = p["dt_proj"].shape[0], cfg.ssm.d_state
    dt, Bm, Cm = torch.split(xc_act @ p["x_proj"], [R, N, N], dim=-1)
    return (dt, Bm, Cm, p["dt_proj"], p["dt_bias"], p["A_log"], p["D"], xc,
            z, state.h)


def _conv_args(p, x, state):
    return (x @ p["in_x"], state.conv, p["conv_w"], p["conv_b"])


def _refused(fn, args, i, bad, err, match):
    args = list(args)
    args[i] = bad(args[i])
    with pytest.raises(err, match=match):
        fn(*args)


CONV_REFUSALS = [
    ("xz int", 0, lambda t: t.to(torch.int32), TypeError, "xz must be"),
    ("xz f16", 0, lambda t: t.half(), TypeError, "xz must be"),
    ("state dtype", 1, lambda t: t.float(), TypeError, "state is"),
    ("w dtype", 2, lambda t: t.float(), TypeError, "conv_w is"),
    ("two tokens", 0, lambda t: t.repeat(1, 2, 1), ValueError, r"\(B, 1, C\)"),
    ("state rows", 1, lambda t: t[:, 1:], ValueError, "state is"),
    ("bias width", 3, lambda t: t[1:], ValueError, "conv_b is"),
    ("too many taps", 2, lambda t: t.repeat(3, 1), ValueError, "taps"),
    ("strided channels", 1, lambda t: t.repeat(1, 1, 2)[..., ::2],
     ValueError, "last dim"),
    ("w strided", 2, lambda t: t.t().contiguous().t(), ValueError,
     "contiguous"),
    ("grad", 3, lambda t: t.clone().requires_grad_(), ValueError,
     "requires grad"),
    ("on the CPU", 0, lambda t: t, ValueError, "CUDA tensors"),
]

STATE_REFUSALS = [
    ("z int", 8, lambda t: t.to(torch.int32), TypeError, "z must be"),
    ("dt_proj dtype", 3, lambda t: t.half(), TypeError, "dt_proj is"),
    ("dt f16", 0, lambda t: t.half(), TypeError, "dt_low, Bm and Cm"),
    ("B alone f32", 1, lambda t: t.double(), TypeError, "dt_low, Bm and Cm"),
    ("A_log f16", 5, lambda t: t.half(), TypeError, "dt_bias, A_log and D"),
    ("D alone", 6, lambda t: t.double(), TypeError, "dt_bias, A_log and D"),
    ("xc bf16", 7, lambda t: t.bfloat16(), TypeError, "xc must be"),
    ("h f64", 9, lambda t: t.double(), TypeError, "h must be"),
    ("dt width", 0, lambda t: t[..., 1:], ValueError, "dt_low is"),
    ("h width", 9, lambda t: t[:, 1:], ValueError, "h is"),
    ("A_log vector", 5, lambda t: t[:, 0], ValueError, "A_log"),
    ("strided dt", 0, lambda t: t.repeat(1, 1, 2)[..., ::2], ValueError,
     "last dim"),
    ("h strided", 9, lambda t: t.transpose(1, 2).contiguous()
     .transpose(1, 2), ValueError, "contiguous"),
    ("grad", 4, lambda t: t.clone().requires_grad_(), ValueError,
     "requires grad"),
    ("on the CPU", 0, lambda t: t, ValueError, "CUDA tensors"),
]


@pytest.mark.parametrize("case", CONV_REFUSALS, ids=lambda c: c[0])
def test_conv_wrapper_refuses(case):
    _, i, bad, err, match = case
    cfg = _cfg()
    p, x, state = _layer(cfg, torch.bfloat16)
    _refused(K.conv_step_cuda, _conv_args(p, x, state), i, bad, err, match)


@pytest.mark.parametrize("case", STATE_REFUSALS, ids=lambda c: c[0])
def test_state_wrapper_refuses(case):
    _, i, bad, err, match = case
    cfg = _cfg()
    p, x, state = _layer(cfg, torch.bfloat16)
    _refused(K.state_step_cuda, _state_args(cfg, p, x, state), i, bad, err,
             match)


def test_state_wrapper_refuses_a_state_size_it_has_no_kernel_for():
    cfg = _cfg().with_(ssm=dataclasses.replace(_cfg().ssm, d_state=6))
    p, x, state = _layer(cfg, torch.bfloat16)
    with pytest.raises(ValueError, match="state size 6"):
        K.state_step_cuda(*_state_args(cfg, p, x, state))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_tensors_give_the_outputs_shapes(dtype):
    cfg = _cfg()
    p, x, state = _layer(cfg, dtype)
    meta = lambda t: t.to("meta")                          # noqa: E731
    conv = ops.conv_step(*map(meta, _conv_args(p, x, state)))
    step = ops.state_step(*map(meta, _state_args(cfg, p, x, state)))
    B, d_in, N = state.h.shape
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in conv] == [
        ((B, 1, d_in), torch.float32, "meta"), ((B, 1, d_in), dtype, "meta"),
        ((B, cfg.ssm.d_conv - 1, d_in), dtype, "meta")]
    assert [(tuple(t.shape), t.dtype) for t in step] == [
        ((B, 1, d_in), dtype), ((B, d_in, N), torch.float32)]


def test_the_cpu_launches_no_kernel():
    cfg = _cfg()
    p, x, state = _layer(cfg, torch.bfloat16)
    before = (K.launches, K.conv_launches)
    SSM.mamba1_block(p, cfg, x, state)
    assert (K.launches, K.conv_launches) == before


def test_mamba1_layers_are_counted_from_the_config():
    from perfbench.families import jamba
    assert count_mamba1(get_config(ARCH)) == 64
    assert count_mamba1(get_config("zamba2-1.2b")) == 0     # Mamba2
    assert count_mamba1(get_config("smollm-135m")) == 0
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "jamba2-mini.json")) as f:
        cfg = jamba.model_config(json.load(f))
    assert count_mamba1(cfg) == 14        # two periods of 7 and 1 attention


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_step(card, B: int, d_in: int, N: int, R: int, dtype,
                 io: Optional[torch.dtype] = None, seed: int = 0):
    """Inputs of both ops at the given widths, drawn as the model makes
    them: A = -(1..N), dt_low of a unit projection (softplus dt of ~1),
    dt_low, Bm, Cm views of one x_proj output (or f32 RMSNorm-like
    tensors where ``io`` is f32)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=card)).to(dt)
    K_ = 4
    conv_in = (rnd(B, 1, d_in, dt=dtype), rnd(B, K_ + 2, d_in,
                                               dt=dtype)[:, 3:],
               rnd(K_, d_in, scale=0.5, dt=dtype), rnd(d_in, scale=0.1,
                                                      dt=dtype))
    proj = rnd(B, 1, R + 2 * N, dt=io or dtype)
    dt, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=card))[None].repeat(d_in, 1)
    state_in = [dt, Bm, Cm, rnd(R, d_in, scale=R ** -0.5, dt=dtype),
                rnd(d_in, scale=0.5), A_log, 1.0 + rnd(d_in, scale=0.1),
                None, rnd(B, 1, d_in, dt=dtype), rnd(B, d_in, N)]
    return conv_in, state_in


SHAPES = [pytest.param(16, 8192, 16, 256, torch.bfloat16, None, id="serve"),
          pytest.param(4, 256, 8, 8, torch.bfloat16, None, id="smoke"),
          pytest.param(16, 8192, 16, 256, torch.float32, None, id="f32"),
          pytest.param(16, 8192, 16, 256, torch.bfloat16, torch.float32,
                       id="normed"),
          pytest.param(21, 200, 32, 20, torch.bfloat16, None, id="ragged")]


def _held(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.card
@pytest.mark.parametrize("B, d_in, N, R, dtype, io", SHAPES)
def test_kernels_equal_the_plain_versions(card, B, d_in, N, R, dtype, io):
    conv_in, state_in = _random_step(card, B, d_in, N, R, dtype, io)
    xc, xc_act, new = K.conv_step_cuda(*conv_in)
    want = ref.conv_step_torch(*conv_in)
    for got, w in zip((xc, xc_act, new), want):
        assert got.dtype == w.dtype and torch.equal(got, w)
    state_in[7] = xc
    y, h = K.state_step_cuda(*state_in)
    y_want, h_want = ref.state_step_torch(*state_in)
    torch.testing.assert_close(h, h_want, rtol=1e-4, atol=1e-4)
    _held(y, y_want, dtype)
    # the parameters in bf16, as an optimizer step leaves them
    state_in[4:7] = [t.to(torch.bfloat16) for t in state_in[4:7]]
    y, h = K.state_step_cuda(*state_in)
    y_want, h_want = ref.state_step_torch(*state_in)
    torch.testing.assert_close(h, h_want, rtol=1e-4, atol=1e-4)
    _held(y, y_want, dtype)


@pytest.mark.card
def test_a_captured_step_equals_the_eager_launch(card):
    conv_in, state_in = _random_step(card, 16, 8192, 16, 256,
                                     torch.bfloat16)

    def step():
        xc, _, new = K.conv_step_cuda(*conv_in)
        y, h = K.state_step_cuda(*state_in[:7], xc, *state_in[8:])
        return y, h, new
    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        graph.capture_begin()
        out = step()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.card
def test_launches_count_each_kernel(card):
    cfg = _cfg()
    p, x, state = _layer(cfg, torch.bfloat16, device=card)
    before = (K.launches, K.conv_launches)
    for _ in range(3):
        _, state = SSM.mamba1_block(p, cfg, x, state)
    torch.cuda.synchronize()
    assert (K.launches - before[0], K.conv_launches - before[1]) == (3, 3)


@pytest.mark.card
@pytest.mark.parametrize("dtype, norm, trained", CASES)
def test_block_step_on_the_card_is_the_plain_one(card, dtype, norm,
                                                 trained):
    cfg = _cfg(norm)
    p, x, state = _layer(cfg, dtype, trained, device=card)
    with torch.no_grad():
        got, got_state = SSM.mamba1_block(p, cfg, x, state)
        want, want_state, _ = _old_step(p, cfg, x, state)
    assert torch.equal(got_state.conv, want_state.conv)
    torch.testing.assert_close(got_state.h, want_state.h, rtol=1e-4,
                               atol=1e-4)
    # out_proj's sum carries y's one-step bf16 differences
    tol = dict(rtol=2 ** -6, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)
