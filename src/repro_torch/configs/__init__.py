"""Architecture config registry.

``get_config(arch_id)`` returns the exact assigned configuration;
``get_config(arch_id).smoke()`` the reduced same-family config for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "smollm-135m": "smollm_135m",
    "starcoder2-15b": "starcoder2_15b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-14b": "qwen3_14b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


# ---------------------------------------------------------------- input shapes
SHAPES: Dict[str, dict] = {
    "train_4k":    dict(seq_len=4096,   global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768,  global_batch=32,  mode="prefill"),
    "decode_32k":  dict(seq_len=32768,  global_batch=128, mode="decode"),
    "long_500k":   dict(seq_len=524288, global_batch=1,   mode="decode"),
}


def shape_applicable(arch: str, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (see DESIGN.md §5)."""
    if shape != "long_500k":
        return True
    return get_config(arch).subquadratic
