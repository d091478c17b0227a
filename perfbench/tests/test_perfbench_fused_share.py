"""``mamba_step_fused_share.serve``, the reader of the share of Mamba1
layer-steps that ran on the fused selective-state kernel (the device ops
named ``mamba_state_step_kernel`` launched in the window's
``lm.decode_step`` spans over their ``mamba1_layers`` attrs): on a
hand-built trace and log, a graph launch whose kernel nodes all carry the
launch's stamp and an eager step, against the share worked out by hand;
silent without the attr (an older program), without Mamba1 mixers, spans,
device ops or the log; and in a tiny traced chat run on the CPU, whose
steps carry the attr and whose trace holds no device op."""
from __future__ import annotations

import os
import sys
from collections import deque

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.tracing import DeviceOp, TraceData  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

MS = 1_000_000                      # ns
W0, W1 = 100 * MS, 200 * MS         # the traced window
NAME = "mamba_step_fused_share.serve"
STATE = ("void (anonymous namespace)::mamba_state_step_kernel"
         "<__nv_bfloat16, 16>(...)")
CONV = ("void (anonymous namespace)::mamba_conv_step_kernel<__nv_bfloat16>"
        "(...)")
GEMV = "nvjet_tst_64x16_64x16_2x1_v_bz_NNT"


def read(run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py",
                               "t_fused_share").read(run)


def step(start, end, **attrs):
    s = spans.Span("lm.decode_step", attrs)
    s.start, s.end = start * MS, end * MS
    return s


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def run_of(ops):
    return harness.TracedRun(TraceData((W0, W1), sorted(
        ops, key=lambda op: op.start)), {}, None)


def graph(launch, start, layers, fused=True):
    """One replay of a step of ``layers`` Mamba1 layers: every node carries
    the graph launch's stamp."""
    names = [GEMV, CONV, GEMV, STATE if fused else "elementwise", GEMV]
    return [DeviceOp(n, start + 10 * i, start + 10 * i + 5, launch)
            for i, n in enumerate(names * layers)]


def eager(launch, start, layers):
    return [DeviceOp(n, start + 10 * i, start + 10 * i + 5, launch + i)
            for i, n in enumerate([CONV, STATE] * layers)]


def test_share_of_the_windows_layer_steps_on_the_kernel(log):
    log.append(step(110, 112, mamba1_layers=3, graph="replay"))
    log.append(step(120, 125, mamba1_layers=3, graph="eager"))
    log.append(step(90, 95, mamba1_layers=3))                # before
    ops = (graph(111 * MS, 150 * MS, 3) + eager(121 * MS, 160 * MS, 3)
           + graph(91 * MS, 96 * MS, 3))
    assert read(run_of(ops)) == 100.0
    # one layer of the replay off the kernel
    ops = (graph(111 * MS, 150 * MS, 2)
           + graph(111 * MS, 150 * MS + 100, 1, fused=False)
           + eager(121 * MS, 160 * MS, 3))
    assert read(run_of(ops)) == pytest.approx(100 * 5 / 6)
    # a step that captures: the warm-up's launches, the capture's none
    log.append(step(130, 135, mamba1_layers=3, graph="capture"))
    ops += eager(131 * MS, 170 * MS, 3)
    assert read(run_of(ops)) == pytest.approx(100 * 8 / 9)


def test_silent_without_the_attr_mixers_ops_or_log(log, monkeypatch):
    ops = graph(111 * MS, 150 * MS, 3)
    assert read(run_of(ops)) is None                       # no spans
    log.append(step(110, 112, graph="replay"))             # the parent's
    assert read(run_of(ops)) is None
    log.clear()
    log.append(step(110, 112, mamba1_layers=0, graph="eager"))
    assert read(run_of(ops)) is None                       # no Mamba1
    log.clear()
    log.append(step(110, 112, mamba1_layers=3, graph="replay"))
    assert read(run_of([])) is None                        # no device op
    assert read(harness.TracedRun(None, {}, None)) is None
    assert read(run_of(ops)) == 100.0
    import repro_torch.obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr(repro_torch.obs, "spans")
    assert read(run_of(ops)) is None


def test_traced_chat_run_marks_the_mamba1_layers_on_the_cpu():
    c = tiny.cell("serve-falcon-mamba-7b-chat")
    c.traffic.update(trace_lead_seconds=0.3, trace_seconds=0.3)
    first = spans.LOG[-1].index + 1 if spans.LOG else 0
    r = tiny.run(c.name, seconds=3, trace=True, c=c)
    steps = [s for s in spans.LOG
             if s.index >= first and s.name == "lm.decode_step"]
    assert steps and all(s.attrs["mamba1_layers"]
                         == tiny.MAMBA["num_hidden_layers"] for s in steps)
    # no kernel runs on the CPU: no reading
    assert NAME not in r["metrics"]
