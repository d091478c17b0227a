"""Load the JAX package's parameters into the port's ``LM``.

The JAX package draws its weights with ``jax.random``, which the port cannot
reproduce, so the port is held to it by loading the very same parameters.
``params_from_jax`` takes its parameter pytree as nested dicts of numpy
arrays, with the per-layer banks stacked on axis 0 (``LM.init``,
``models/model.py``), and builds the port's ``LM`` from it.  bfloat16 leaves
must be handed over as float32 arrays (``torch.from_numpy`` does not take
``ml_dtypes.bfloat16``); bf16 -> f32 -> bf16 is exact.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.kernels.device import Device, require_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, check_ported

# leaves the reference keeps in f32 whatever the parameters' dtype
F32_LEAVES = ("dt_bias", "A_log", "D")


def _tree(node: Mapping[str, Any], dtype, device) -> dict:
    out = {}
    for name, value in node.items():
        if isinstance(value, Mapping):
            out[name] = _tree(value, dtype, device)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value))
            out[name] = t.to(device=device, dtype=torch.float32
                             if name in F32_LEAVES else dtype)
    return out


def _layer(node: Mapping[str, Any], i: int) -> dict:
    return {name: _layer(value, i) if isinstance(value, Mapping)
            else value[i] for name, value in node.items()}


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: Device = "cuda", dtype=torch.bfloat16) -> LM:
    """The port's ``LM`` on ``device`` with the JAX package's parameters
    ``tree`` (numpy leaves, layer banks stacked on axis 0)."""
    check_ported(cfg)
    dev = require_device(device)
    blocks = tree["blocks"]
    n = len(next(iter(_leaves(blocks))))
    if n != cfg.n_layers:
        raise ValueError(f"the banks hold {n} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    params = _tree({k: v for k, v in tree.items() if k != "blocks"}, dtype,
                   dev)
    params["blocks"] = [_tree(_layer(blocks, i), dtype, dev)
                        for i in range(n)]
    return LM(cfg, dtype=dtype, device=dev, params=params)


def _leaves(node: Mapping[str, Any]):
    for value in node.values():
        if isinstance(value, Mapping):
            yield from _leaves(value)
        else:
            yield value
