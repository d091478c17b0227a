"""State-space blocks: Mamba1 (the S6 selective scan).

A port of the Mamba1 half of the JAX package's ``models/ssm.py``.  For T > 1
the scan goes to the selective-scan op (B4): the CUDA kernel for tensors on
the card, its plain version on the CPU; it replaces the reference's chunked
associative scan, which computes the same recurrence.  Its gradient on the
card is the op's eager backward (``kernels/mamba_scan/ops.py``).  The single-step
recurrence of decode stays plain PyTorch.  All scan math is f32; the
projections run in the parameters' dtype.  Mamba2 (SSD) is not ported yet
(ROADMAP Queue A, step 7: hybrid).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dense_init


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

    xz = x @ p["in_x"]                                    # (B, T, d_in)
    z = x @ p["in_z"]
    conv_state = state.conv if state is not None else None
    xc, new_conv = causal_conv1d(xz, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc.float())

    proj = (xc.to(x.dtype) @ p["x_proj"]).float()
    dt, B_, C_ = torch.split(proj, [dt_rank, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                            # (d_in, n)

    h0 = state.h if state is not None else torch.zeros(
        (B, d_in, s.d_state), dtype=torch.float32, device=x.device)
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
    y = y + p["D"] * xc
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    new_state = (Mamba1State(new_conv, hT)
                 if (return_state or state is not None) else None)
    return out, new_state
