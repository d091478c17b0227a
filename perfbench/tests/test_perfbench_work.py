"""The benchmark's model-FLOP counts held to ``FlopCounterMode`` over the
port's own forward, on the CPU at a tiny size of each family (the plain
versions of the kernels run there, so every product is counted)."""
from __future__ import annotations

import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import weights  # noqa: E402
from perfbench.work import bounds, flops, peaks  # noqa: E402


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_mamba1_forward_and_prefill_flops():
    from repro_torch.models.model import LM
    cfg = tiny.cell("serve-falcon-mamba-7b-prompts").config
    s = weights.sizes(cfg)
    model = LM(weights.family(cfg).model_config(cfg), device="cpu",
               params=weights.tree(cfg, 1, "cpu"))
    tokens = torch.randint(0, s.vocab, (3, 20))
    assert _counted(lambda: model(tokens)) == flops.mamba1_forward(s, 60, 60)
    cache = model.init_cache(3, 24)
    assert _counted(lambda: model.prefill(tokens, cache)) == \
        flops.mamba1_forward(s, 60, 3)


def test_mla_moe_forward_flops():
    from repro_torch.models.model import LM
    from repro_torch.models.moe import moe_capacity
    cfg = tiny.cell("train-deepseek-v2-lite-16b").config
    s = weights.sizes(cfg)
    mcfg = weights.family(cfg).model_config(cfg)
    model = LM(mcfg, device="cpu", params=weights.tree(cfg, 1, "cpu"))
    B, T = 2, 24
    tokens = torch.randint(0, s.vocab, (B, T))
    rows = s.experts * moe_capacity(mcfg.moe, B * T)   # what the port computes
    # the port's eager MLA scores the whole T x T square, masked after
    assert _counted(lambda: model(tokens)) == flops.mla_moe_forward(
        s, B, T, expert_rows=rows, pairs=T * T)
    assert flops.mla_moe_forward(s, B, T) - flops.mla_moe_forward(
        s, B, T, pairs=T * T) == -s.n_layers * 2 * B * s.heads * (
        T * (T - 1) // 2) * (s.nope + s.rope + s.vd)
    assert flops.mla_moe_train_step(s, B, T) == 3 * flops.mla_moe_forward(
        s, B, T)


def test_bounds():
    # B1 at 4 MiB is bound by its bytes: 0.00125 ms (PERF.md's table)
    assert abs(bounds.checksum_s(4 << 20) * 1e3 - 0.00125) < 1e-5
    # B4 at falcon-mamba's serve shape [4, 256, 8192, 16]: 0.0321 ms of exps
    assert abs(bounds.scan_s(4, 256, 8192, 16) * 1e3 - 0.0321) < 1e-4
    assert bounds.scan_s(1, 1, 8192, 16) == (
        4 * (3 * 8192 + 32 + 8192 * 16 + 2 * 8192 * 16) / peaks.HBM_BYTES)
