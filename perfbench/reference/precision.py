"""The references' matrix products: float32 with TF32 off, or the control's
fp8.

``Precision("f32")`` multiplies in float32 and ``exact()`` turns TF32 off
for the duration (on the H100 a float32 product may otherwise run in TF32).
``Precision("fp8")`` is the control, the step below the bfloat16 the
configurations state: each operand of every product is rounded to
float8_e4m3 with a per-tensor scale (its largest magnitude onto 448), and
the product of the rounded values is taken in float32.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact():
    """Float32 products in full float32 (no TF32) inside the block."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3 under a per-tensor scale, back in
    float32.  The rounding is a straight-through step under autograd."""
    xf = x.float()
    with torch.no_grad():
        scale = xf.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (xf.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return xf + (q - xf).detach()


class Precision:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this precision (float32 out)."""
        return fp8_round(x) if self.kind == "fp8" else x.float()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.op(x) @ self.op(w)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.op(a), self.op(b))
