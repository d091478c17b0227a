"""The jamba2-mini configuration and its cell, on the CPU at a tiny size:
the family's weight layout against the port's tree, the FLOP count held to
``FlopCounterMode`` over the port's decode step, the experts' bytes held to
the experts the routing touches, the cell's three readers
(``expert_roofline.serve``, ``expert_share.serve``, ``decode_mfu.serve``)
on hand-built span logs, the cell's files found by name, and tiny runs of
the cell, plain and traced."""
from __future__ import annotations

import copy
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
from perfbench.tracing import DeviceOp, TraceData  # noqa: E402
from perfbench.work import experts, jamba, peaks  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

CELL = "serve-jamba2-mini-chat"
JAMBA = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=8, mamba_d_state=8, mamba_dt_rank=4,
             num_experts=4, intermediate_size=64, vocab_size=256)
READERS = ("expert_roofline.serve", "expert_share.serve", "decode_mfu.serve")
# metrics of other cells too, whose readers are family-blind
JOINS = ("serve_tokens_per_s", "decode_ms.serve", "device_idle.serve",
         "decode_launches.serve", "decode_host_share.serve",
         "decode_graph_share.serve")
MS = 1_000_000                      # ns
W0, W1 = 100 * MS, 200 * MS         # the traced window


def cell() -> harness.Cell:
    c = copy.deepcopy(harness.find_cell(CELL))
    c.config.update(JAMBA)
    c.traffic.update(tiny.TRAFFIC["chat"])
    return c


def run(c, seed=7, seconds=0.5, trace=False, control=False) -> dict:
    return harness.run_cell(c, seed, seconds, trace, "cpu", 0.0,
                            harness.benchmark(), control=control)


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "t_jamba_" + name.replace(".", "_")).read


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def span(name, start, end, **attrs):
    s = spans.Span(name, attrs)
    s.start, s.end = start, end
    return s


def count(name, at, value):
    c = spans.Count(name, value, {})
    c.at = at
    return c


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
    assert any(p.endswith("ssm.dt_norm.scale") for p in got)
    assert got["blocks.1.moe.router"] == ((64, 4), torch.float32)


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
    assert counter.get_total_flops() == B * jamba.token_flops(s, S)
    assert jamba.token_flops(s, S) - jamba.token_flops(s, P + 1) == \
        4 * s.heads * s.hd * (S - P - 1)


def test_the_published_token_is_twice_its_active_matrices():
    s = weights.sizes(harness.find_cell(CELL).config)
    d, ff, V = 4096, 14336, 65536
    mats = (14 * (d * 2 * d * 2 + 2 * d * (256 + 2 * 16) + 256 * 2 * d
                  + 2 * d * d + 2 * d * 16)
            + 2 * d * 128 * (2 * 32 + 2 * 8) + 8 * 3 * d * ff
            + 8 * (d * 16 + 2 * 3 * d * ff) + d * V)
    assert jamba.token_flops(s, 0) == 2 * mats
    # the experts' bytes a step: ~14 of 16 experts a layer at 16 tokens
    assert experts.expert_bytes(s, [2] * 14 + [0, 0]) == \
        14 * 3 * d * ff * 2 + 14 * 4 * d


def test_expert_bytes_follow_the_touched_experts(log):
    from repro_torch.models import moe
    s = weights.sizes(cell().config)
    g = torch.Generator().manual_seed(5)
    N, E = 6, s.experts
    xf = torch.randn(N, s.d, generator=g)
    p = {"router": torch.randn(s.d, E, generator=g),
         **{k: torch.randn(E, *shape, generator=g) for k, shape in
            (("w_gate", (s.d, s.ff)), ("w_up", (s.d, s.ff)),
             ("w_down", (s.ff, s.d)))}}
    m = SimpleNamespace(n_routed=E, top_k=s.top_k, router_norm_topk=False)
    top_w, top_i, _ = moe._routing(p, m, xf)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        moe._dropless_ffn_combine(xf, top_w, top_i, p["w_gate"], p["w_up"],
                                  p["w_down"])
    (load,) = [r.value for r in log if r.name == "moe.load"]
    touched = len(set(top_i.reshape(-1).tolist()))
    assert experts.expert_bytes(s, load) == \
        touched * 3 * s.d * s.ff * 2 + N * 4 * s.d


def _decode_log(log, experts=True, attrs=True):
    """Two decode steps in the window, each holding two expert calls with
    their loads, and one step before it."""
    for a, b in ((90, 95), (110, 120), (130, 140)):
        log.append(span("engine.decode", a * MS, b * MS,
                        **(dict(live=3, t=40) if attrs else {})))
        if experts:
            for c0 in (a + 2, a + 6):
                log.append(span("moe.experts", c0 * MS, (c0 + 2) * MS))
                log.append(count("moe.load", (c0 + 1) * MS, [2, 0, 3, 1]))
    log.append(span("moe.experts", 150 * MS, 152 * MS))   # outside a step


# launches in the steps at 111, 115 and 119 ms, in their expert calls at
# 113, 117, 133 and 137 ms, and in the call outside a step at 151 ms
OPS = [op(111 * MS, 300 * MS, 5_000), op(113 * MS, 301 * MS, 15_000),
       op(115 * MS, 302 * MS, 40_000),
       op(117 * MS, 303 * MS, 20_000, "Memcpy DtoD (Device -> Device)"),
       op(119 * MS, 304 * MS, 20_000), op(133 * MS, 305 * MS, 30_000),
       op(137 * MS, 306 * MS, 10_000), op(151 * MS, 307 * MS, 99_000)]


def test_expert_share_is_of_the_decode_steps_device_time(log):
    _decode_log(log)
    got = reader("expert_share.serve")(run_of(OPS))
    part = 15_000 + 20_000 + 30_000 + 10_000
    assert got == pytest.approx(100 * part / (part + 5_000 + 40_000
                                              + 20_000))


@pytest.mark.parametrize("which", ["jamba", "another MoE family"])
def test_expert_roofline_is_the_touched_experts_bytes_over_the_time(
        log, which):
    _decode_log(log)
    # the reader takes any family whose sizes give d, ff and top_k
    c = cell() if which == "jamba" else \
        tiny.cell("train-deepseek-v2-lite-16b")
    s = weights.sizes(c.config)
    got = reader("expert_roofline.serve")(run_of(OPS, c=c))
    touched = 3 * 3 * s.d * s.ff * 2               # 3 experts in the load
    rows = 6 // s.top_k * 4 * s.d                  # 6 routings
    device = (15_000 + 20_000 + 30_000 + 10_000) / 1e9
    assert got == pytest.approx(100 * 4 * (touched + rows)
                                / peaks.HBM_BYTES / device)


def test_decode_mfu_is_the_live_tokens_flops_over_the_steps(log):
    _decode_log(log)
    c = cell()
    s = weights.sizes(c.config)
    # the lead: the step before the window, timed by the engine as 5 ms
    got = reader("decode_mfu.serve")(run_of(counters={"decode_s": [0.005]},
                                            c=c))
    want = 100 * 3 * jamba.token_flops(s, 41) / (0.005 * peaks.BF16_FLOPS)
    assert got == pytest.approx(want)
    # a step the engine timed otherwise than its span: no reading
    assert reader("decode_mfu.serve")(run_of(
        counters={"decode_s": [0.006]}, c=c)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_is_silent_without_its_spans(name, log, monkeypatch):
    counters = {"decode_s": [0.005]}
    assert reader(name)(run_of(OPS, counters)) is None
    assert reader(name)(harness.TracedRun(None, counters, cell())) is None
    # the parent's program: steps without the attrs, no expert spans
    _decode_log(log, experts=False, attrs=False)
    assert reader(name)(run_of(OPS, counters)) is None
    # another family's cell
    log.clear()
    _decode_log(log)
    if name != "expert_share.serve":
        falcon = tiny.cell("serve-falcon-mamba-7b-chat")
        assert reader(name)(run_of(OPS, counters, c=falcon)) is None
    # a program without the log
    import repro_torch.obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr(repro_torch.obs, "spans")
    assert program.in_window(run_of(OPS), "engine.decode") == []
    assert reader(name)(run_of(OPS, counters)) is None


def test_cell_files_found_by_name():
    b = harness.benchmark()
    c = harness.find_cell(CELL, b)
    config, = [x for x in b["configs"] if x["name"] == c.entry["config"]]
    root = harness.BENCH_DIR
    assert (root / "drivers" / f"{c.driver}.py").is_file()
    assert (harness.ROOT / config["file"]).is_file()
    assert config["reduced"] == sorted(c.config["reduced"]) == \
        ["num_hidden_layers"]
    assert (root / "reference" / "jamba_lm.py").is_file()
    names = {m["name"] for m in harness.per_layer_of(CELL, b)}
    assert set(READERS) | set(JOINS) - {"serve_tokens_per_s"} == names
    for m in names:
        assert callable(reader(m))
    assert set(c.limits) == {"logit_gap"}
    assert c.traffic == harness.find_cell("serve-falcon-mamba-7b-chat",
                                          b).traffic


def test_tiny_cell_is_correct_and_the_control_reads_a_wider_gap():
    r = run(cell(), seed=2 ** 31 + 11, control=True)
    out = r["_outcome"]
    assert r["correct"] and out.failed == 0 and out.attempted > 0
    assert set(r["metrics"]) == {"setup_s", "serve_tokens_per_s"}
    assert out.control["logit_gap"] > r["checks"]["logit_gap"]["value"]


def test_tiny_traced_cell_reads_the_decode_mfu():
    c = cell()
    c.traffic.update(trace_lead_seconds=0.3, trace_seconds=0.3)
    r = run(c, seconds=3, trace=True)
    assert r["correct"]
    mfu = r["metrics"]["decode_mfu.serve"]
    assert mfu["unit"] == "%" and 0 < mfu["value"] < 100
    assert 0 < r["metrics"]["decode_host_share.serve"]["value"] <= 100
    # the mixed pattern decodes eagerly: no step replays a graph
    assert r["metrics"]["decode_graph_share.serve"]["value"] == 0
