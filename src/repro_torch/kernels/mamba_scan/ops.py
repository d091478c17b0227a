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
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import local
from repro_torch.kernels.mamba_scan.mamba_scan import selective_scan_cuda
from repro_torch.kernels.mamba_scan.ref import selective_scan_torch


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
        with torch.enable_grad(), torch.profiler.record_function(
                "selective_scan_eager_backward"):
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
