"""LR schedules (pure functions of the integer step tensor), as the JAX
package's: f32 arithmetic on the step, one 0-d f32 tensor out."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = peak_lr * torch.clamp(s / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, peak_lr * cos)


def constant(step: torch.Tensor, lr: float) -> torch.Tensor:
    return torch.full_like(step, lr, dtype=torch.float32)
