"""Public op: the selective scan on the tensors' device.

``selective_scan`` dispatches on the device its tensors lie on: CUDA tensors
go to the kernel (``mamba_scan.selective_scan_cuda``) or raise, CPU tensors
to the plain PyTorch version (``ref.selective_scan_torch``), which autograd
differentiates natively.  Nothing falls back from one to the other; meta
tensors (the dry run's shapes) get outputs of the right shapes, with no
work counted: the plain version's walk over T would take the dry run
minutes, and its products are elementwise, which ``FlopCounterMode`` does
not count anyway.  DTensors
run this op on their local shards (``_sharded``, through
``kernels/local.py``), or raise where their placements do not split the
scan into whole ones.  The
kernel masks the ragged T and D itself, so the JAX wrapper's padding to
(128, 256) blocks has no counterpart here.

The kernel is forward-only and its launch is invisible to autograd, so on
the card an input that requires grad (training) goes through
``SelectiveScan``, an ``autograd.Function``: its forward launches the kernel
on detached inputs; its backward recomputes the recurrence eagerly
(``scan_recurrence``) and returns ``torch.autograd.grad`` of that for u,
dt, Bm, Cm, A and h0.  The JAX package has no backward kernel either: its
gradient is ``jax.grad`` of its jnp scan.

Decode's single step (T == 1, a state given) has two ops of its own,
``conv_step`` and ``state_step``, which dispatch alike: CUDA tensors to the
kernels of ``mamba_step.py`` or raise, CPU tensors to the plain versions
(``ref.conv_step_torch``, ``ref.state_step_torch``: the model's eager step,
op for op), meta tensors to the plain versions too (their products are
counted as the eager step's were), DTensors to their local shards (the step
is per channel and per row; Bm and Cm are read by every channel).  They are
forward-only: decode runs under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import local
from repro_torch.kernels.mamba_scan.mamba_scan import selective_scan_cuda
from repro_torch.kernels.mamba_scan.mamba_step import (conv_step_cuda,
                                                       state_step_cuda)
from repro_torch.kernels.mamba_scan.ref import (conv_step_torch,
                                                selective_scan_torch,
                                                state_step_torch)


def scan_recurrence(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of ``ref.selective_scan_torch`` with the decays and
    inputs of every step formed at once, (B, T, D, N) each, so the walk
    over T is one multiply-add a step: the eager form the backward
    differentiates.  The steps are taken by ``unbind``, whose backward
    stacks their gradients once (a slice's would fill a whole (B, T, D, N)
    gradient a step)."""
    a = torch.exp(dt[..., None] * A).unbind(1)             # T x (B, D, N)
    bu = ((dt * u)[..., None] * Bm[:, :, None, :]).unbind(1)
    h = h0
    hs = []
    for a_t, bu_t in zip(a, bu):
        h = torch.addcmul(bu_t, a_t, h)
        hs.append(h)
    if not hs:
        return u.new_zeros(u.shape), h
    y = torch.einsum("btdn,btn->btd", torch.stack(hs, dim=1), Cm)
    return y, h


class SelectiveScan(torch.autograd.Function):
    """The kernel's forward, the eager recurrence's gradient."""

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, A, h0):
        ctx.save_for_backward(u, dt, Bm, Cm, A, h0)
        return selective_scan_cuda(*(x.detach() for x in
                                     (u, dt, Bm, Cm, A, h0)))

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        needed = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(need)
                   for x, need in zip(ctx.saved_tensors, needed)]
            y, hT = scan_recurrence(*ins)
            got = iter(torch.autograd.grad(
                (y, hT), [x for x in ins if x.requires_grad],
                (grad_y, grad_h)))
        return tuple(next(got) if need else None for need in needed)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, T, D); Bm, Cm: (B, T, N); A: (D, N); h0: (B, D, N); all
    f32.  Returns (y (B, T, D), hT (B, D, N))."""
    ins = (u, dt, Bm, Cm, A, h0)
    if local.is_dtensor(u):
        return _sharded(*ins)
    if u.device.type == "cuda":
        if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
            return SelectiveScan.apply(*ins)
        return selective_scan_cuda(*ins)
    if u.device.type == "meta":
        return torch.empty_like(u), torch.empty_like(h0)
    if u.device.type != "cpu":
        raise ValueError(f"no selective scan for {u.device}")
    return selective_scan_torch(*ins)


# on one mesh dim, the placements of (u, dt, Bm, Cm, A, h0) that split the
# scan into whole ones: batch rows, or channels (the recurrence is
# independent per channel; B and C are read by every channel)
_SCAN_SPLITS = (("R",) * 6,
                ("S0", "S0", "S0", "S0", "R", "S0"),
                ("S2", "S2", "R", "R", "S0", "S1"))


def _sharded(*ins):
    """DTensor inputs: this op on every rank's shard, or ``ValueError``
    where a mesh dim splits them otherwise than ``_SCAN_SPLITS``."""
    local.check("selective_scan", ins, _SCAN_SPLITS,
                "batch- or channel-sharded")
    return local.run_local(selective_scan, ins, (ins[0], ins[5]))


# ------------------------------------------------- Mamba1's single decode step
def conv_step(xz: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One causal conv step and its SiLU: xz (B, 1, C), the conv state
    (B, K-1, C), conv_w (K, C), conv_b (C,).  Returns (xc (B, 1, C) f32, xc
    in xz's dtype, the new state), as ``ref.conv_step_torch``.  On the card a
    state in a narrower dtype than xz's (an f32 model's fresh bf16 cache) is
    widened first, as the eager concatenation promotes it."""
    ins = (xz, state, w, b)
    if local.is_dtensor(xz):
        local.check("conv_step", ins, _CONV_SPLITS,
                    "batch- or channel-sharded")
        return local.run_local(conv_step, ins, (xz, xz, state))
    if xz.device.type == "cuda":
        if state.dtype != xz.dtype \
                and torch.promote_types(state.dtype, xz.dtype) == xz.dtype:
            state = state.to(xz.dtype)
        return conv_step_cuda(xz, state, w, b)
    if xz.device.type not in ("cpu", "meta"):
        raise ValueError(f"no conv step for {xz.device}")
    return conv_step_torch(*ins)


def state_step(dt_low: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               dt_proj: torch.Tensor, dt_bias: torch.Tensor,
               A_log: torch.Tensor, D: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One selective-state step: dt_low (B, 1, R), Bm, Cm (B, 1, N),
    dt_proj (R, C), dt_bias (C,), A_log (C, N), D (C,), xc (B, 1, C) f32, z
    (B, 1, C), h (B, C, N) f32.  Returns (y (B, 1, C) in z's dtype, the new
    h), as ``ref.state_step_torch``."""
    ins = (dt_low, Bm, Cm, dt_proj, dt_bias, A_log, D, xc, z, h)
    if local.is_dtensor(z):
        local.check("state_step", ins, _STATE_SPLITS,
                    "batch- or channel-sharded")
        return local.run_local(state_step, ins, (z, h))
    if z.device.type == "cuda":
        return state_step_cuda(*ins)
    if z.device.type not in ("cpu", "meta"):
        raise ValueError(f"no state step for {z.device}")
    return state_step_torch(*ins)


# on one mesh dim, the placements that split a step into whole ones: batch
# rows, or channels (conv_w, conv_b, dt_proj, dt_bias, A_log and D split with
# them; dt_low, Bm and Cm are read by every channel); of (xz, state, conv_w,
# conv_b), then of (dt_low, Bm, Cm, dt_proj, dt_bias, A_log, D, xc, z, h)
_CONV_SPLITS = (("R",) * 4,
                ("S0", "S0", "R", "R"),
                ("S2", "S2", "S1", "S0"))
_STATE_SPLITS = (("R",) * 10,
                 ("S0", "S0", "S0", "R", "R", "R", "R", "S0", "S0", "S0"),
                 ("R", "R", "R", "S1", "S0", "S0", "S0", "S2", "S2", "S1"))
