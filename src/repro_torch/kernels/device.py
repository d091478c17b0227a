"""The ``device`` argument of the port's entry points.

Every entry point that runs a kernel takes ``device`` (default ``"cuda"``).
A CUDA device without CUDA raises here instead of quietly running on the
CPU; ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def require_device(device: Device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch version")
    return dev
