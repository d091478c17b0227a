"""State-space blocks: Mamba1 (the S6 selective scan) and Mamba2 (SSD).

A port of the JAX package's ``models/ssm.py``.  For Mamba1 at T > 1
the scan goes to the selective-scan op (B4): the CUDA kernel for tensors on
the card, its plain version on the CPU; it replaces the reference's chunked
associative scan, which computes the same recurrence.  Its gradient on the
card is the op's eager backward (``kernels/mamba_scan/ops.py``).  Decode's
single step (T == 1, a state given) goes to the two step ops of the same
module around the GEMVs: ``conv_step`` (the conv's step and SiLU) and
``state_step`` (dt, the recurrence, the D skip and the SiLU gate), two
CUDA kernels on the card and the eager step's plain PyTorch on the CPU.
All scan math is f32; the projections run in the parameters' dtype.  While
a profiler runs, the f32 pointwise stages around the scan are fine spans
(``repro_torch.obs.spans``): ``mamba1.conv`` (the causal conv and SiLU) and
``mamba1.gate`` (``y + D xc`` and the SiLU gate).  Where the config's
``ssm.dt_bc_norm`` holds (Jamba's mixer), dt, B and C pass an RMSNorm each
after ``x_proj``, dt before ``dt_proj``; without it the block is as before,
op for op.

Mamba2 (zamba2) runs the reference's chunked SSD algorithm as eager
PyTorch: the reference has no kernel for it either, and its products are
``torch.einsum`` / matmul calls; while a profiler runs it is the fine span
``mamba2.ssd`` (attrs B, T, H, P, N, G).  Its x, B and C have depthwise
convs of their own weights, run as one conv over the concatenated
channels ``x|B|C`` (a depthwise conv treats each channel alone, so the
numbers are the three convs'), and a decode state keeps their trailing
inputs concatenated so, as the reference's does.  Where the config's SSM
is a ``Mamba2HeadsConfig`` the inner width is its ``mamba_heads`` times
``headdim``, not ``expand`` times d, and the gated RMSNorm after the SSD
runs over each of the ``n_groups`` groups of channels on its own; without
it the block is zamba2's, whole-width norm and all.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import (conv_step, selective_scan,
                                                state_step)
from repro_torch.models.axes import constrain
from repro_torch.models.config import ModelConfig, mamba2_heads, option
from repro_torch.models.layers import (Params, _dense_init, init_rmsnorm,
                                       rmsnorm)
from repro_torch.obs import spans


# ------------------------------------------------------------------ conv1d
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, T, C); w: (d_conv, C).

    state: (B, d_conv-1, C) trailing inputs from the previous call (decode).
    Returns (y (B, T, C) in x's dtype, new_state (B, d_conv-1, C)); the new
    state has the dtype the concatenation of state and x promotes to, as in
    the reference.  After more than one token it is a copy: a view would
    keep the whole (B, T + d_conv - 1, C) concatenation alive as long as
    the cache holds the state.
    """
    B, T, C = x.shape
    dk = w.shape[0]
    if state is None:
        state = torch.zeros((B, dk - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                      # (B, T+dk-1, C)
    y = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for i in range(dk):                                    # dk is 4: unrolled
        y = y + xp[:, i:i + T, :].float() * w[i].float()
    if bias is not None:
        y = y + bias.float()
    tail = xp[:, T:, :]
    return y.to(x.dtype), tail.clone() if T > 1 else tail


# ================================================================== Mamba1
class Mamba1State(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_in)
    h: torch.Tensor      # (B, d_in, d_state) f32


def init_mamba1(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = max(1, d // 16)
    dev = gen.device
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev)[None].repeat(d_in, 1)
    norms = {"dt_norm": init_rmsnorm(dt_rank, dtype, dev),
             "b_norm": init_rmsnorm(s.d_state, dtype, dev),
             "c_norm": init_rmsnorm(s.d_state, dtype, dev)} \
        if option(s, "dt_bc_norm") else {}
    return {
        "in_x": _dense_init(gen, (d, d_in), dtype),
        "in_z": _dense_init(gen, (d, d_in), dtype),
        "conv_w": _dense_init(gen, (s.d_conv, d_in), dtype, scale=0.5),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": _dense_init(gen, (d_in, dt_rank + 2 * s.d_state), dtype),
        "dt_proj": _dense_init(gen, (dt_rank, d_in), dtype),
        "dt_bias": torch.zeros((d_in,), dtype=torch.float32, device=dev),
        "A_log": torch.log(A),                             # (d_in, d_state)
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(gen, (d_in, d), dtype),
        **norms,
    }


def mamba1_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Mamba1State] = None,
                 return_state: bool = False,
                 ) -> Tuple[torch.Tensor, Optional[Mamba1State]]:
    """x: (B, T, d).  Forward: state=None.  Prefill: return_state=True.
    Decode: state given (T may be 1)."""
    s = cfg.ssm
    B, T, d = x.shape
    d_in = s.expand * d
    dt_rank = max(1, d // 16)

    # under sharding rules the expanded channels (d_in) stay split over
    # "model" through the conv and the scan; B and C are read by every
    # channel, so they are replicated there
    xz = constrain(x @ p["in_x"], ("batch", "seq", "ssm_ch"))  # (B,T,d_in)
    z = constrain(x @ p["in_z"], ("batch", "seq", "ssm_ch"))
    if T == 1 and state is not None:
        return _mamba1_step(p, cfg, xz, z, state)
    conv_state = state.conv if state is not None else None
    with spans.fine("mamba1.conv"):
        xc, new_conv = causal_conv1d(xz, p["conv_w"], p["conv_b"],
                                     conv_state)
        xc = F.silu(xc.float())

    proj = (xc.to(x.dtype) @ p["x_proj"]).float()
    dt, B_, C_ = torch.split(proj, [dt_rank, s.d_state, s.d_state], dim=-1)
    if option(s, "dt_bc_norm"):
        dt = rmsnorm(p["dt_norm"], dt, cfg.norm_eps)
        B_ = rmsnorm(p["b_norm"], B_, cfg.norm_eps)
        C_ = rmsnorm(p["c_norm"], C_, cfg.norm_eps)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"])
    dt = constrain(dt, ("batch", "seq", "ssm_ch"))
    B_ = constrain(B_, ("batch", "seq", None))
    C_ = constrain(C_, ("batch", "seq", None))
    A = -torch.exp(p["A_log"])                            # (d_in, n)

    h0 = constrain(state.h if state is not None else xc.new_zeros(
        (B, d_in, s.d_state), dtype=torch.float32), ("batch", "ssm_ch",
                                                      None))
    # A is bf16 once an optimizer step has cast A_log (as the reference's
    # does); the scan takes it in f32, where the reference's dt * A
    # promotes it
    y, hT = selective_scan(xc, dt, B_, C_, A.float(), h0)
    with spans.fine("mamba1.gate"):
        y = y + p["D"] * xc
        y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    new_state = (Mamba1State(new_conv, hT)
                 if (return_state or state is not None) else None)
    return out, new_state


def _mamba1_step(p: Params, cfg: ModelConfig, xz: torch.Tensor,
                 z: torch.Tensor, state: Mamba1State
                 ) -> Tuple[torch.Tensor, Mamba1State]:
    """Decode's recurrent single step from ``state``: xz and z (B, 1, d_in)
    are the input's two projections.  The conv step, ``x_proj`` and the
    selective-state step; under sharding rules every per-channel operand
    splits with the channels, and dt, B and C are replicated over them."""
    s = cfg.ssm
    dt_rank = p["dt_proj"].shape[0]
    ch = ("ssm_ch",)
    xc, xc_act, new_conv = conv_step(
        xz, state.conv, constrain(p["conv_w"], (None, *ch)),
        constrain(p["conv_b"], ch))
    proj = xc_act @ p["x_proj"]
    if option(s, "dt_bc_norm"):
        dt, B_, C_ = torch.split(proj.float(),
                                 [dt_rank, s.d_state, s.d_state], dim=-1)
        dt = rmsnorm(p["dt_norm"], dt, cfg.norm_eps)
        B_ = rmsnorm(p["b_norm"], B_, cfg.norm_eps)
        C_ = rmsnorm(p["c_norm"], C_, cfg.norm_eps)
    else:
        # read as they lie, in the activations' dtype: the step widens them
        dt, B_, C_ = torch.split(proj, [dt_rank, s.d_state, s.d_state],
                                 dim=-1)
    dt, B_, C_ = (constrain(v, ("batch", "seq", None)) for v in (dt, B_, C_))
    y, h = state_step(
        dt, B_, C_, constrain(p["dt_proj"], (None, *ch)),
        constrain(p["dt_bias"], ch), constrain(p["A_log"], (*ch, None)),
        constrain(p["D"], ch), xc, z,
        constrain(state.h, ("batch", "ssm_ch", None)))
    return y @ p["out_proj"], Mamba1State(new_conv, h)


# ================================================================== Mamba2
class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim): x|B|C
    h: torch.Tensor      # (B, nheads, headdim, d_state) f32


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, nheads = mamba2_heads(cfg)
    GN = s.n_groups * s.d_state
    dev = gen.device

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=dev)
    return {
        "in_z": _dense_init(gen, (d, d_in), dtype),
        "in_x": _dense_init(gen, (d, d_in), dtype),
        "in_B": _dense_init(gen, (d, GN), dtype),
        "in_C": _dense_init(gen, (d, GN), dtype),
        "in_dt": _dense_init(gen, (d, nheads), dtype),
        "conv_x_w": _dense_init(gen, (s.d_conv, d_in), dtype, scale=0.5),
        "conv_x_b": zeros(d_in),
        "conv_B_w": _dense_init(gen, (s.d_conv, GN), dtype, scale=0.5),
        "conv_B_b": zeros(GN),
        "conv_C_w": _dense_init(gen, (s.d_conv, GN), dtype, scale=0.5),
        "conv_C_b": zeros(GN),
        "dt_bias": zeros(nheads, torch.float32),
        "A_log": zeros(nheads, torch.float32),             # A = -1
        "D": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(d_in, dtype, dev),
        "out_proj": _dense_init(gen, (d_in, d), dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) lower-triangular cumulative sums,
    segsum[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j), -inf above the
    diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full((), -torch.inf,
                                              device=x.device))


def _ssd_chunked(xh, dt, B_, C_, A, h0, chunk: int):
    """The chunked SSD algorithm.  xh: (B, T, H, P) f32; dt: (B, T, H) f32
    (after softplus); B_, C_: (B, T, G, N) f32; A: (H,) f32 (negative);
    h0: (B, H, P, N) f32.  Returns (y (B, T, H, P), hT).  Chunk by chunk
    in order, as the reference's scan: within a chunk the diagonal block
    from the decay matrix, the carried state's contribution, and the next
    state.  Where ``chunk`` does not divide T the last chunk is shorter
    (the reference takes only whole chunks)."""
    Bsz, T, H, P = xh.shape
    G = B_.shape[2]
    Lc = min(chunk, T)
    rep = H // G
    h = h0
    ys = []
    for c0 in range(0, T, Lc):
        x_, dt_ = xh[:, c0:c0 + Lc], dt[:, c0:c0 + Lc]
        bg = torch.repeat_interleave(B_[:, c0:c0 + Lc], rep, dim=2)
        cg = torch.repeat_interleave(C_[:, c0:c0 + Lc], rep, dim=2)
        da = dt_ * A                                       # (B, Lc, H)
        L = torch.exp(_segsum(da.transpose(1, 2)))         # (B, H, Lc, Lc)
        scores = torch.einsum("blhn,bshn->bhls", cg, bg)
        y_diag = torch.einsum("bhls,bsh,bshp->blhp", scores * L, dt_, x_)
        cum = torch.cumsum(da, dim=1)                      # (B, Lc, H)
        y_off = torch.einsum("blhn,bhpn->blhp", cg, h) * torch.exp(
            cum)[..., None]
        a_tail = torch.exp(cum[:, -1:, :] - cum)           # prod a_{s+1..Lc}
        S = torch.einsum("bshn,bsh,bshp->bhpn", bg * a_tail[..., None], dt_,
                         x_)
        h = h * torch.exp(torch.sum(da, dim=1))[..., None, None] + S
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), h


def mamba2_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Mamba2State] = None,
                 return_state: bool = False,
                 ) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
    """x: (B, T, d).  Forward: state=None.  Prefill: return_state=True.
    Decode: state given; one token (T == 1) takes the recurrent step, more
    run the chunked SSD from the state."""
    s = cfg.ssm
    B, T, d = x.shape
    d_in, H = mamba2_heads(cfg)
    P, G, N = s.headdim, s.n_groups, s.d_state

    z = x @ p["in_z"]
    xBC = torch.cat([x @ p["in_x"], x @ p["in_B"], x @ p["in_C"]], dim=-1)
    dt_raw = (x @ p["in_dt"]).float()
    xBC, new_conv = causal_conv1d(
        xBC, torch.cat([p["conv_x_w"], p["conv_B_w"], p["conv_C_w"]], 1),
        torch.cat([p["conv_x_b"], p["conv_B_b"], p["conv_C_b"]]),
        state.conv if state is not None else None)
    x_c, B_c, C_c = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xh = F.silu(x_c.float()).reshape(B, T, H, P)
    B_ = F.silu(B_c.float()).reshape(B, T, G, N)
    C_ = F.silu(C_c.float()).reshape(B, T, G, N)
    dt = F.softplus(dt_raw + p["dt_bias"])                 # (B, T, H)
    # bf16 once an optimizer step has cast A_log, as in the reference,
    # where dt * A then promotes it
    A = -torch.exp(p["A_log"])                             # (H,)

    h0 = state.h if state is not None else torch.zeros(
        (B, H, P, N), dtype=torch.float32, device=x.device)
    if T == 1 and state is not None:
        a = torch.exp(dt[:, 0] * A)                        # (B, H)
        rep = H // G
        bg = torch.repeat_interleave(B_[:, 0], rep, dim=1)  # (B, H, N)
        cg = torch.repeat_interleave(C_[:, 0], rep, dim=1)
        dbx = torch.einsum("bh,bhp,bhn->bhpn", dt[:, 0], xh[:, 0], bg)
        h = a[..., None, None] * h0 + dbx
        y = torch.einsum("bhpn,bhn->bhp", h, cg)[:, None]  # (B, 1, H, P)
        hT = h
    else:
        with spans.fine("mamba2.ssd", B=B, T=T, H=H, P=P, N=N, G=G):
            y, hT = _ssd_chunked(xh, dt, B_, C_, A, h0, s.chunk)
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, T, d_in)
    y = y * F.silu(z.float())
    y = _group_rmsnorm(p["norm"], y.to(x.dtype),
                       G if option(s, "group_norm") else 1, cfg.norm_eps)
    out = y @ p["out_proj"]
    new_state = (Mamba2State(new_conv, hT)
                 if (return_state or state is not None) else None)
    return out, new_state


def _group_rmsnorm(p: Params, x: torch.Tensor, groups: int,
                   eps: float) -> torch.Tensor:
    """``rmsnorm`` over each of ``groups`` equal groups of x's last axis on
    its own (one group: ``rmsnorm``'s numbers), times the scale of the
    whole width; f32 inside, x's dtype out."""
    xf = x.float().unflatten(-1, (groups, -1))
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y.flatten(-2) * p["scale"].float()).to(x.dtype)


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    return (init_mamba1 if cfg.ssm.version == 1 else init_mamba2)(
        gen, cfg, dtype)


def ssm_block(p: Params, cfg: ModelConfig, x: torch.Tensor, state=None,
              return_state: bool = False):
    fn = mamba1_block if cfg.ssm.version == 1 else mamba2_block
    return fn(p, cfg, x, state, return_state)
