"""Tiny versions of the benchmark's cells, for the tests on the CPU: the
cells' own files with the sizes cut, the keys and the code unchanged.

``HELD`` holds the entries of cells whose files are here but which
``BENCHMARK.json`` leaves out until they can be measured (PERF.md, Open
questions); their drivers are tested all the same."""
from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

CELLS = ("audit-esgf-cmip6", "serve-falcon-mamba-7b-prompts",
         "train-deepseek-v2-lite-16b", "serve-falcon-mamba-7b-chat")
HELD = {"audit-esgf-cmip6": {"name": "audit-esgf-cmip6",
                             "config": "esgf-cmip6-replica",
                             "traffic": "replica-audit", "chips": 1}}

MAMBA = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             state_size=8, time_step_rank=4, vocab_size=256)
MLA_MOE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
               moe_intermediate_size=32, intermediate_size=96,
               num_hidden_layers=3, vocab_size=256)
TRAFFIC = {
    "replica-audit": dict(file_size={"dist": "lognormal", "median": 65536,
                                     "sigma": 1.0, "min": 1024,
                                     "max": 262144}, corrupt_every=4),
    "long-prompts": dict(slots=4, max_seq=40, check_requests=24,
                         prompt_len={"dist": "lognormal", "median": 12,
                                     "sigma": 0.6, "min": 4, "max": 30},
                         new_tokens={"dist": "fixed", "value": 4}),
    "chat": dict(slots=4, max_seq=32, check_requests=16,
                 prompt_len={"dist": "lognormal", "median": 8, "sigma": 0.6,
                             "min": 4, "max": 16},
                 new_tokens={"dist": "lognormal", "median": 6, "sigma": 0.5,
                             "min": 3, "max": 10}),
    "pretrain-4x2048": dict(batch=2, seq=16, check_steps=3),
}


def cell(name: str) -> harness.Cell:
    c = harness.cell_of(HELD[name]) if name in HELD else \
        copy.deepcopy(harness.find_cell(name))
    fam = c.config["family"]
    if fam == "mamba1":
        c.config.update(MAMBA)
    elif fam == "mla_moe":
        c.config.update(MLA_MOE)
    c.traffic.update(TRAFFIC[c.entry["traffic"]])
    return c


def run(name: str, seed: int = 7, seconds: float = 0.5, trace=False,
        control=False, c=None) -> dict:
    """One run of the tiny cell on the CPU, past the look for a chip."""
    c = c or cell(name)
    return harness.run_cell(c, seed, seconds, trace, "cpu", 0.0,
                            harness.benchmark(), control=control)
