"""The readers of the program's span log (``perfbench/program.py`` and the
five metrics that use it): each on a hand-built trace and log against the
value worked out by hand, each silent where its spans are missing or the
program has no log, and the readers that need no device in tiny traced
runs on the CPU."""
from __future__ import annotations

import os
import sys
from collections import deque

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import harness, program  # noqa: E402
from perfbench.tracing import DeviceOp, TraceData  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

MS = 1_000_000                      # ns
W0, W1 = 100 * MS, 200 * MS         # the traced window
READERS = ("decode_host_share.serve", "decode_launches.serve",
           "mixer_pointwise_share.prefill", "adamw_roofline.train",
           "moe_slot_fill.train")


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "t_prog_" + name.replace(".", "_")).read


def span(name, start, end, **attrs):
    s = spans.Span(name, attrs)
    s.start, s.end = start, end
    return s


def count(name, at, value, **attrs):
    c = spans.Count(name, value, attrs)
    c.at = at
    return c


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def run_of(ops=(), counters=None):
    trace = TraceData((W0, W1), sorted(ops, key=lambda op: op.start))
    return harness.TracedRun(trace, counters or {}, None)


def op(launch, start, dur, name="kernel"):
    return DeviceOp(name, start, start + dur, launch)


def test_decode_host_share_reads_the_untraced_lead(log):
    # an older step, then the lead's three steps, then one in the window
    steps = [(10, 30, 12, 20), (40, 52, 41, 46), (60, 75, 61, 70),
             (80, 90, 81, 84), (120, 130, 121, 125)]
    for a, b, c, d in steps:
        log.append(span("engine.decode", a * MS, b * MS))
        log.append(span("lm.decode_step", c * MS, d * MS))
    lead = steps[1:4]
    counters = {"decode_s": [(b - a) / 1e3 for a, b, _, _ in lead]}
    got = reader("decode_host_share.serve")(run_of(counters=counters))
    want = 100 * (5 + 9 + 3) / (12 + 15 + 10)
    assert got == pytest.approx(want)
    # a step the engine timed otherwise than its span: no reading
    bad = dict(counters, decode_s=[counters["decode_s"][0] * 1.02]
               + counters["decode_s"][1:])
    assert reader("decode_host_share.serve")(run_of(counters=bad)) is None
    # more steps asked for than the log holds before the window
    more = {"decode_s": [0.01] * 6}
    assert reader("decode_host_share.serve")(run_of(counters=more)) is None


def test_decode_launches_counts_distinct_launches_a_step(log):
    log.append(span("engine.decode", 110 * MS, 120 * MS))
    log.append(span("engine.decode", 130 * MS, 140 * MS))
    log.append(span("engine.decode", 195 * MS, 205 * MS))   # past the end
    ops = [op(111 * MS, 150 * MS, 10), op(111 * MS, 150 * MS + 10, 10),
           op(112 * MS, 151 * MS, 10, "Memcpy HtoD"),
           op(113 * MS, 152 * MS, 10), op(None, 115 * MS, 10),
           op(131 * MS, 160 * MS, 10), op(139 * MS, 161 * MS, 10),
           op(125 * MS, 126 * MS, 10), op(196 * MS, 197 * MS, 10)]
    got = reader("decode_launches.serve")(run_of(ops))
    assert got == (3 + 2) / 2


def test_mixer_pointwise_share_is_of_prefills_device_time(log):
    log.append(span("engine.prefill", 110 * MS, 130 * MS))
    log.append(span("mamba1.conv", 111 * MS, 112 * MS))
    log.append(span("mamba1.gate", 120 * MS, 121 * MS))
    log.append(span("mamba1.conv", 150 * MS, 151 * MS))     # a decode step
    ops = [op(111 * MS, 300 * MS, 40), op(111 * MS + 5, 301 * MS, 20),
           op(115 * MS, 302 * MS, 200), op(120 * MS, 303 * MS, 60),
           op(125 * MS, 304 * MS, 80, "Memcpy DtoD (Device -> Device)"),
           op(150 * MS, 305 * MS, 1000)]
    got = reader("mixer_pointwise_share.prefill")(run_of(ops))
    assert got == pytest.approx(100 * (40 + 20 + 60) / (40 + 20 + 200 + 60
                                                        + 80))


def test_adamw_roofline_is_its_bytes_over_its_device_time(log):
    attrs = dict(numel=10, grad_bytes=2_000_000, state_bytes=12_000_000,
                 out_bytes=2_000_000)
    log.append(span("adamw.update", 110 * MS, 120 * MS, **attrs))
    log.append(span("adamw.update", 140 * MS, 150 * MS, **attrs))
    log.append(span("adamw.update", 90 * MS, 95 * MS, **attrs))  # before
    ops = [op(111 * MS, 115 * MS, 9_000),
           op(112 * MS, 116 * MS, 3_000, "Memcpy DtoD (Device -> Device)"),
           op(141 * MS, 160 * MS, 12_000), op(130 * MS, 131 * MS, 50_000),
           op(91 * MS, 96 * MS, 50_000)]
    got = reader("adamw_roofline.train")(run_of(ops))
    moved = 2 * (2e6 + 2 * 12e6 + 2e6)
    assert got == pytest.approx(100 * moved / 3.35e12 / 24e-6)


def test_moe_slot_fill_is_the_kept_rows_share(log):
    log.append(count("moe.dispatch", 110 * MS, torch.tensor([5, 0, 9, 3]),
                     C=4, Eb=4))
    log.append(count("moe.dispatch", 120 * MS, torch.tensor([1, 8]),
                     C=4, Eb=2))
    log.append(count("moe.dispatch", 90 * MS, torch.tensor([0, 0]),
                     C=4, Eb=2))                            # before
    got = reader("moe_slot_fill.train")(run_of())
    assert got == pytest.approx(100 * (4 + 0 + 4 + 3 + 1 + 4) / (16 + 8))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_is_silent_without_its_spans(name, log, monkeypatch):
    ops = [op(111 * MS, 150 * MS, 10)]
    counters = {"decode_s": [0.01, 0.02]}
    assert reader(name)(run_of(ops, counters)) is None
    assert reader(name)(harness.TracedRun(None, counters, None)) is None
    # a program without the log (an older tree)
    log.append(span("engine.decode", 110 * MS, 120 * MS))
    import repro_torch.obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr(repro_torch.obs, "spans")
    assert program.in_window(run_of(ops), "engine.decode") == []
    assert reader(name)(run_of(ops, counters)) is None


def test_launches_are_found_by_launch_not_by_device_start():
    late = op(101 * MS, 190 * MS, 10)         # the device ran it 89 ms on
    trace = TraceData((W0, W1), [late])
    sp = span("x", 100 * MS, 102 * MS)
    assert program.launched(trace, sp) == [late]
    assert program.launches(trace, sp) == 1
    assert program.device_seconds(trace, [sp]) == 10 / 1e9


def test_traced_serving_run_reads_the_decode_host_share():
    c = tiny.cell("serve-falcon-mamba-7b-chat")
    c.traffic.update(trace_lead_seconds=0.3, trace_seconds=0.3)
    r = tiny.run(c.name, seconds=3, trace=True, c=c)
    share = r["metrics"]["decode_host_share.serve"]
    assert share["unit"] == "%" and 0 < share["value"] <= 100


def test_traced_training_run_reads_the_moe_slot_fill():
    c = tiny.cell("train-deepseek-v2-lite-16b")
    c.traffic.update(trace_seconds=0.3)
    r = tiny.run(c.name, seconds=0.3, trace=True, c=c)
    fill = r["metrics"]["moe_slot_fill.train"]
    # 2 x 16 tokens, top 2 of 8 experts: 64 routings in 8 x 16 rows
    assert fill["unit"] == "%" and 0 < fill["value"] <= 50
