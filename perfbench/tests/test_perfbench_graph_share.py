"""``decode_graph_share.serve``, the reader of the decode step's path
(``LM.decode_step``'s ``graph`` attr on the program's ``lm.decode_step``
spans): on a hand-built log against the share worked out by hand, silent
where the attr, the spans or the log are missing, and in a tiny traced
run on the CPU, where every step is eager."""
from __future__ import annotations

import os
import sys
from collections import deque

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.tracing import TraceData  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

MS = 1_000_000                      # ns
W0, W1 = 100 * MS, 200 * MS         # the traced window
NAME = "decode_graph_share.serve"


def read(run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py",
                               "t_graph_share").read(run)


def span(start, end, **attrs):
    s = spans.Span("lm.decode_step", attrs)
    s.start, s.end = start * MS, end * MS
    return s


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def run_of(counters):
    return harness.TracedRun(TraceData((W0, W1), []), counters, None)


def test_share_of_the_leads_steps_that_replayed(log):
    # a capture before the lead, then the lead's five steps, then one in
    # the window
    paths = ["capture", "replay", "eager", "replay", "capture", "replay",
             "replay"]
    for i, path in enumerate(paths):
        at = 10 + 10 * i if i < 6 else 150
        log.append(span(at, at + 5, graph=path))
    got = read(run_of({"decode_s": [0.005] * 5}))
    assert got == pytest.approx(100 * 3 / 5)
    # the last two: a capture and a replay
    assert read(run_of({"decode_s": [0.005] * 2})) == 50.0
    assert read(run_of({"decode_s": [0.005]})) == 100.0


def test_silent_without_the_graph_attr_or_the_spans(log, monkeypatch):
    counters = {"decode_s": [0.005] * 2}
    assert read(run_of(counters)) is None                  # no spans
    log.append(span(10, 15))                                # the parent's
    log.append(span(20, 25))
    assert read(run_of(counters)) is None
    log.append(span(30, 35, graph="replay"))
    assert read(run_of(counters)) is None                  # one of two
    assert read(run_of({"decode_s": [0.005] * 3})) is None
    assert read(run_of({})) is None
    assert read(harness.TracedRun(None, counters, None)) is None
    import repro_torch.obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr(repro_torch.obs, "spans")
    assert read(run_of(counters)) is None


def test_traced_serving_run_reads_no_replay_on_the_cpu():
    c = tiny.cell("serve-falcon-mamba-7b-chat")
    c.traffic.update(trace_lead_seconds=0.3, trace_seconds=0.3)
    r = tiny.run(c.name, seconds=3, trace=True, c=c)
    share = r["metrics"][NAME]
    assert share == {"value": 0.0, "unit": "%"}
