"""Load the JAX package's parameters into the port's ``LM``.

The JAX package draws its weights with ``jax.random``, which the port cannot
reproduce, so the port is held to it by loading the very same parameters.
``params_from_jax`` takes its parameter pytree as nested dicts of numpy
arrays, laid out as the reference's ``LM.init`` (``models/model.py``) lays
it out, and builds the port's ``LM`` from it:

* ``blocks``: a bank, every leaf stacked on axis 0 (one row a layer);
* ``lead``: an MoE model's lead blocks, a plain list;
* ``groups``: a local_global model's ``{"local": (G, R, ...) bank,
  "global": (G, ...) bank}``, or a hybrid model's (G, R, ...) bank of SSM
  layers;
* ``shared``: a hybrid model's one attention block, unstacked;
* ``tail``: a bank, or None where the pattern has no tail;
* the embedding (K, V, d) and head (K, d, V) of K codebooks as they are.

bfloat16 leaves must be handed over as float32 arrays (``torch.from_numpy``
does not take ``ml_dtypes.bfloat16``); bf16 -> f32 -> bf16 is exact.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.kernels.device import Device, require_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LAYER_KEYS, LM

# leaves the reference draws in f32 whatever the parameters' dtype (Mamba1's
# and Mamba2's, and the MoE router, ``models/moe.py``)
F32_LEAVES = ("dt_bias", "A_log", "D", "router")


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


def _rows(bank: Optional[Mapping[str, Any]]) -> list:
    """A bank cut into its rows (none for a missing bank)."""
    if bank is None:
        return []
    return [_layer(bank, i) for i in range(len(next(_leaves(bank))))]


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: Device = "cuda", dtype=torch.bfloat16) -> LM:
    """The port's ``LM`` on ``device`` with the JAX package's parameters
    ``tree`` (numpy leaves, laid out as above); ``ValueError`` where the
    tree does not hold the config's layers."""
    dev = require_device(device)

    def conv(node):
        return _tree(node, dtype, dev)

    params = conv({k: v for k, v in tree.items() if k not in LAYER_KEYS})
    if tree.get("lead"):
        params["lead"] = [conv(b) for b in tree["lead"]]
    if "blocks" in tree:
        params["blocks"] = [conv(b) for b in _rows(tree["blocks"])]
    groups = tree.get("groups")
    if groups is not None and "local" in groups:          # local_global
        params["groups"] = [
            {"local": [conv(b) for b in _rows(g["local"])],
             "global": conv(g["global"])} for g in _rows(groups)]
    elif groups is not None:                              # hybrid
        params["groups"] = [[conv(b) for b in _rows(g)]
                            for g in _rows(groups)]
    if "shared" in tree:
        params["shared"] = conv(tree["shared"])
    if "tail" in tree:
        params["tail"] = [conv(b) for b in _rows(tree["tail"])] or None
    return LM(cfg, dtype=dtype, device=dev, params=params)


def _leaves(node: Mapping[str, Any]):
    for value in node.values():
        if isinstance(value, Mapping):
            yield from _leaves(value)
        else:
            yield value
