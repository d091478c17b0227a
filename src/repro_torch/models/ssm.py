"""State-space blocks: Mamba1 (the S6 selective scan) and Mamba2 (SSD).

A port of the JAX package's ``models/ssm.py``.  For Mamba1 at T > 1
the scan goes to the selective-scan op (B4): the CUDA kernel for tensors on
the card, its plain version on the CPU; it replaces the reference's chunked
associative scan, which computes the same recurrence.  Its gradient on the
card is the op's eager backward (``kernels/mamba_scan/ops.py``).  The single-step
recurrence of decode stays plain PyTorch.  All scan math is f32; the
projections run in the parameters' dtype.  While a profiler runs, the f32
pointwise stages around the scan are fine spans (``repro_torch.obs.spans``):
``mamba1.conv`` (the causal conv and SiLU) and ``mamba1.gate`` (``y + D xc``
and the SiLU gate).

Mamba2 (zamba2) runs the reference's chunked SSD algorithm as eager
PyTorch: the reference has no kernel for it either, and its products are
``torch.einsum`` / matmul calls.  Its x, B and C have depthwise convs of
their own, while a decode state keeps their trailing inputs concatenated
as ``x|B|C``, as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.models.axes import constrain
from repro_torch.models.config import ModelConfig
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
    the reference.
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
    return y.to(x.dtype), xp[:, T:, :]


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
    conv_state = state.conv if state is not None else None
    with spans.fine("mamba1.conv"):
        xc, new_conv = causal_conv1d(xz, p["conv_w"], p["conv_b"],
                                     conv_state)
        xc = F.silu(xc.float())

    proj = (xc.to(x.dtype) @ p["x_proj"]).float()
    dt, B_, C_ = torch.split(proj, [dt_rank, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"])
    dt = constrain(dt, ("batch", "seq", "ssm_ch"))
    B_ = constrain(B_, ("batch", "seq", None))
    C_ = constrain(C_, ("batch", "seq", None))
    A = -torch.exp(p["A_log"])                            # (d_in, n)

    h0 = constrain(state.h if state is not None else xc.new_zeros(
        (B, d_in, s.d_state), dtype=torch.float32), ("batch", "ssm_ch",
                                                      None))
    if T == 1 and state is not None:
        # recurrent single step
        a = torch.exp(dt[:, 0, :, None] * A)              # (B, d_in, n)
        h = a * h0 + (dt[:, 0] * xc[:, 0])[..., None] * B_[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, C_[:, 0])[:, None]
        hT = h
    else:
        # A is bf16 once an optimizer step has cast A_log (as the
        # reference's does); the scan takes it in f32, where the reference's
        # dt * A promotes it
        y, hT = selective_scan(xc, dt, B_, C_, A.float(), h0)
    with spans.fine("mamba1.gate"):
        y = y + p["D"] * xc
        y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    new_state = (Mamba1State(new_conv, hT)
                 if (return_state or state is not None) else None)
    return out, new_state


# ================================================================== Mamba2
class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim): x|B|C
    h: torch.Tensor      # (B, nheads, headdim, d_state) f32


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nheads = d_in // s.headdim
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
    state."""
    Bsz, T, H, P = xh.shape
    G = B_.shape[2]
    Lc = min(chunk, T)
    assert T % Lc == 0, (T, Lc)
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
    d_in = s.expand * d
    H = d_in // s.headdim
    P, G, N = s.headdim, s.n_groups, s.d_state

    z = x @ p["in_z"]
    xx = x @ p["in_x"]
    xB = x @ p["in_B"]
    xC = x @ p["in_C"]
    dt_raw = (x @ p["in_dt"]).float()
    cs = state.conv if state is not None else None
    cs_x = cs[..., :d_in] if cs is not None else None
    cs_B = cs[..., d_in:d_in + G * N] if cs is not None else None
    cs_C = cs[..., d_in + G * N:] if cs is not None else None
    x_c, ncv_x = causal_conv1d(xx, p["conv_x_w"], p["conv_x_b"], cs_x)
    B_c, ncv_B = causal_conv1d(xB, p["conv_B_w"], p["conv_B_b"], cs_B)
    C_c, ncv_C = causal_conv1d(xC, p["conv_C_w"], p["conv_C_b"], cs_C)
    new_conv = torch.cat([ncv_x, ncv_B, ncv_C], dim=-1)
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
        y, hT = _ssd_chunked(xh, dt, B_, C_, A, h0, s.chunk)
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, T, d_in)
    y = y * F.silu(z.float())
    y = rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    out = y @ p["out_proj"]
    new_state = (Mamba2State(new_conv, hT)
                 if (return_state or state is not None) else None)
    return out, new_state


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    return (init_mamba1 if cfg.ssm.version == 1 else init_mamba2)(
        gen, cfg, dtype)


def ssm_block(p: Params, cfg: ModelConfig, x: torch.Tensor, state=None,
              return_state: bool = False):
    fn = mamba1_block if cfg.ssm.version == 1 else mamba2_block
    return fn(p, cfg, x, state, return_state)
