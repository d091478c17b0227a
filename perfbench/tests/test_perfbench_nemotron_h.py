"""The nemotron-3-nano-30b-a3b configuration and its cell, on the CPU at a
tiny size: the family's weight layout against the port's tree, the FLOP
count held to ``FlopCounterMode`` over the port's decode step and summed
into a prompt's, the cell's two readers (``ssd_share.prefill``,
``prefill_mfu.serve``) on hand-built span logs, the cell's files found by
name, and tiny runs of the cell, plain and traced, judged by the cell's own
limit."""
from __future__ import annotations

import os
import sys
from collections import deque
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import harness, program, weights  # noqa: E402
from perfbench.reference import nemotron_h_lm  # noqa: E402
from perfbench.tracing import DeviceOp, TraceData  # noqa: E402
from perfbench.work import nemotron_h, peaks  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

CELL = "serve-nemotron-3-nano-30b-a3b-prompts"
NEMOTRON = dict(hidden_size=64, hybrid_override_pattern="MEM*EMEM*E",
                num_hidden_layers=10, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, mamba_num_heads=4,
                mamba_head_dim=16, n_groups=2, ssm_state_size=8,
                chunk_size=8, n_routed_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=32,
                moe_shared_expert_intermediate_size=48, vocab_size=256)
READERS = ("ssd_share.prefill", "prefill_mfu.serve")
MS = 1_000_000                      # ns
W0, W1 = 100 * MS, 200 * MS         # the traced window


def published() -> harness.Cell:
    """The cell at its published sizes, its files found by name."""
    return harness.find_cell(CELL)


def cell() -> harness.Cell:
    c = published()
    c.config.update(NEMOTRON)
    c.traffic.update(tiny.TRAFFIC["long-prompts"])
    return c


def run(c, seed=7, seconds=0.5, trace=False, control=False) -> dict:
    return harness.run_cell(c, seed, seconds, trace, "cpu", 0.0,
                            harness.benchmark(), control=control)


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "t_nemotron_" + name.replace(".", "_")).read


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def span(name, start, end, **attrs):
    s = spans.Span(name, attrs)
    s.start, s.end = start, end
    return s


def op(launch, start, dur, name="kernel"):
    return DeviceOp(name, start, start + dur, launch)


def run_of(ops=(), counters=None, c=None):
    trace = TraceData((W0, W1), sorted(ops, key=lambda o: o.start))
    return harness.TracedRun(trace, counters or {}, c or cell())


def test_weight_tree_is_the_ports_layout():
    from repro_torch.models.model import LM
    cfg = cell().config
    mine = weights.tree(cfg, 3, "cpu")
    theirs = LM(weights.family(cfg).model_config(cfg),
                device="meta").params()
    got = {p: (tuple(x.shape), x.dtype) for p, x in weights.walk(mine)}
    want = {p: (tuple(x.shape), x.dtype) for p, x in weights.walk(theirs)}
    assert got == want
    assert got["blocks.1.moe.router"] == ((64, 8), torch.float32)
    assert got["blocks.1.moe.score_bias"] == ((8,), torch.float32)
    assert "blocks.1.moe.w_gate" not in got
    assert got["blocks.0.ssm.norm.scale"] == ((64,), torch.bfloat16)
    again = weights.tree(cfg, 3, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(weights.walk(mine), weights.walk(again)))
    # A_log is log(1..heads), dt the config's log-uniform range
    ssm = mine["blocks"][0]["ssm"]
    assert torch.equal(ssm["A_log"], torch.log(torch.arange(1., 5.)))
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert float(dt.min()) >= 1e-3 and float(dt.max()) <= 0.1


def test_decode_flops_are_the_ports_products():
    from repro_torch.models.model import LM
    cfg = cell().config
    s = weights.sizes(cfg)
    model = LM(weights.family(cfg).model_config(cfg), device="cpu",
               params=weights.tree(cfg, 1, "cpu"))
    B, S, P = 3, 24, 9
    cache = model.init_cache(B, S)
    _, cache = model.prefill(torch.randint(0, s.vocab, (B, P)), cache)
    token = torch.randint(0, s.vocab, (B, 1))
    with FlopCounterMode(display=False) as counter:
        model.decode_step(cache, token, P)
    # the port's decode attends over every slot of the cache, masked
    assert counter.get_total_flops() == B * nemotron_h.token_flops(s, S)


@pytest.mark.parametrize("lens", [[1], [9], [5, 17, 2]])
def test_a_prompt_is_its_tokens_each_at_its_keys(lens):
    s = weights.sizes(cell().config)
    head = 2 * s.d * s.vocab
    assert nemotron_h.prompt_flops(s, lens) == sum(
        sum(nemotron_h.token_flops(s, t + 1) for t in range(n))
        - (n - 1) * head for n in lens)


def test_the_published_token_is_mostly_experts_then_mamba2():
    s = weights.sizes(published().config)
    assert s.plan.count("mamba2") == s.plan.count("moe") == 23
    assert s.plan.count("attn") == 6
    body = nemotron_h.token_flops(s, 0) - 2 * s.d * s.vocab
    assert 0.63 < 23 * nemotron_h.moe_token(s) / body < 0.65
    assert 0.30 < 23 * nemotron_h.mamba2_token(s) / body < 0.32


def _prefill_log(log, ssd=True, attrs=True):
    """Two waves' prefills in the window, each holding two SSD calls, and
    one wave before it."""
    for a, b in ((90, 95), (110, 130), (140, 160)):
        log.append(span("engine.prefill", a * MS, b * MS,
                        **(dict(wave=1, B=4, T=32) if attrs else {})))
        if ssd:
            for c0 in (a + 2, a + 8):
                log.append(span("mamba2.ssd", c0 * MS, (c0 + 2) * MS,
                                B=4, T=32, H=4, P=16, N=8, G=2))
    log.append(span("mamba2.ssd", 170 * MS, 172 * MS))   # outside a wave


# launches in the waves at 111, 121 and 145 ms, in their SSD calls at 113,
# 119 and 149 ms, and in the call outside a wave at 171 ms
OPS = [op(111 * MS, 300 * MS, 5_000), op(113 * MS, 301 * MS, 15_000),
       op(119 * MS, 302 * MS, 25_000, "Memcpy DtoD (Device -> Device)"),
       op(121 * MS, 303 * MS, 40_000), op(145 * MS, 304 * MS, 20_000),
       op(149 * MS, 305 * MS, 10_000), op(171 * MS, 306 * MS, 99_000)]


def test_ssd_share_is_of_the_prefills_device_time(log):
    _prefill_log(log)
    got = reader("ssd_share.prefill")(run_of(OPS))
    part = 15_000 + 25_000 + 10_000
    assert got == pytest.approx(100 * part / (part + 5_000 + 40_000
                                              + 20_000))


def test_prefill_mfu_is_the_prompts_flops_over_the_engines_seconds():
    c = cell()
    s = weights.sizes(c.config)
    waves = [dict(width=32, prompt_lens=[5, 17, 30, 2], prefill_s=0.5),
             dict(width=32, prompt_lens=[9, 9, 9, 9], prefill_s=0.25)]
    got = reader("prefill_mfu.serve")(run_of(counters={"waves": waves},
                                             c=c))
    want = 100 * (nemotron_h.prompt_flops(s, [5, 17, 30, 2])
                  + nemotron_h.prompt_flops(s, [9] * 4)) \
        / (0.75 * peaks.BF16_FLOPS)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_is_silent_without_its_spans(name, log, monkeypatch):
    waves = {"waves": [dict(width=32, prompt_lens=[5], prefill_s=0.5)]}
    if name == "prefill_mfu.serve":
        # a family whose work module gives no prompt_flops, one with none
        for other in ("serve-jamba2-mini-chat",
                      "serve-falcon-mamba-7b-prompts"):
            c = harness.find_cell(other)
            assert reader(name)(run_of(counters=waves, c=c)) is None
        assert reader(name)(run_of()) is None            # no wave
        return
    assert reader(name)(run_of(OPS, waves)) is None
    assert reader(name)(harness.TracedRun(None, waves, cell())) is None
    # the parent's program: prefills without SSD spans
    _prefill_log(log, ssd=False, attrs=False)
    assert reader(name)(run_of(OPS, waves)) is None
    # a program without the log
    log.clear()
    _prefill_log(log)
    import repro_torch.obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr(repro_torch.obs, "spans")
    assert program.in_window(run_of(OPS), "engine.prefill") == []
    assert reader(name)(run_of(OPS, waves)) is None


def test_the_held_cells_files_are_found_by_name():
    """The cell's files, found by name, and its entries in
    ``BENCHMARK.json``."""
    b = harness.benchmark()
    c = published()
    root = harness.BENCH_DIR
    assert (root / "drivers" / f"{c.driver}.py").is_file()
    assert c.config["reduced"] == {} and c.config["family"] == "nemotron_h"
    assert (root / "reference" / "nemotron_h_lm.py").is_file()
    assert (root / "work" / "nemotron_h.py").is_file()
    assert set(c.limits) == {"logit_gap"}
    assert {m["name"] for m in harness.per_layer_of(CELL, b)} == {
        *READERS, "pad_share.prefill", "device_idle.serve"}
    assert {m["name"] for m in harness.end_to_end_of(CELL, b)} == {
        "setup_s", "ttft_p95_ms", "serve_tokens_per_s"}
    for m in READERS:
        assert callable(reader(m))
    assert c.traffic == harness.find_cell("serve-falcon-mamba-7b-prompts",
                                          b).traffic


def test_the_file_holds_the_catalogs_numbers():
    """Every published number the port reads, as the config states it."""
    cfg = published().config
    assert cfg["hybrid_override_pattern"] == \
        "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
    s = weights.sizes(cfg)
    assert (s.d, s.n_layers, s.heads, s.kv_heads, s.hd) == \
        (2688, 52, 32, 2, 128)
    assert (s.mamba_heads, s.mamba_hd, s.d_in, s.groups, s.n, s.chunk) == \
        (64, 64, 4096, 8, 128, 128)
    assert (s.experts, s.top_k, s.ff, s.ff_shared, s.shared, s.scale) == \
        (128, 6, 1856, 3712, 1, 2.5)
    assert s.vocab == 131072 and s.norm_topk


def test_tiny_cell_is_correct_and_the_control_reads_a_wider_gap():
    r = run(cell(), seed=2 ** 31 + 11, control=True)
    out = r["_outcome"]
    assert r["correct"] and out.failed == 0 and out.attempted > 0
    assert set(r["metrics"]) == {"setup_s", "ttft_p95_ms",
                                 "serve_tokens_per_s"}
    assert out.control["logit_gap"] > r["checks"]["logit_gap"]["value"]


# the tiny cell's widest sound logit gap over six seeds (0.007-0.045)
SOUND_GAP = 0.045


@pytest.mark.parametrize("fault", [{"scale": 1.0}, {"top_k": 1},
                                   {"norm_topk": False}],
                         ids=["unscaled", "one_fewer", "unnormalised"])
def test_a_routing_fault_reads_far_above_a_sound_run(fault):
    """The routed experts' ``w_down`` drawn small (``routed_down_scale``)
    still carry the routing: a routing fault in the reference moves the
    served token's gap over four times a sound run's widest."""
    c = cell()
    s = weights.sizes(c.config)
    tree = weights.tree(c.config, 7, "cpu")
    toks = torch.randint(1, s.vocab, (4, 30),
                         generator=torch.Generator().manual_seed(7))
    pos = [range(14, 30)] * 4
    want = nemotron_h_lm.logits_at(tree, s, toks, pos)
    got = nemotron_h_lm.logits_at(tree, SimpleNamespace(**{**vars(s),
                                                           **fault}),
                                  toks, pos)
    gap = max(float((w.max(-1).values
                     - w.gather(1, g.argmax(-1)[:, None])[:, 0]).max())
              for w, g in zip(want, got))
    assert gap > 4 * SOUND_GAP


def test_tiny_traced_cell_reads_its_prefill_metrics():
    c = cell()
    c.traffic.update(trace_lead_seconds=0.3, trace_seconds=0.3)
    r = run(c, seconds=3, trace=True)
    assert r["correct"]
    mfu = r["metrics"]["prefill_mfu.serve"]
    assert mfu["unit"] == "%" and 0 < mfu["value"] < 100
    assert 0 < r["metrics"]["pad_share.prefill"]["value"] < 100
