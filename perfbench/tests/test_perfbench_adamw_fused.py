"""``adamw_fused_share.train``, the reader of the share of AdamW's leaf
updates that ran on the fused update kernel (the device ops named
``adamw_update_kernel`` launched in the window's ``adamw.update`` spans
over their ``leaves`` attrs): on a hand-built trace and log against the
share worked out by hand; silent without the attr (an older program),
without leaves, spans, device ops or the log; and in a tiny traced
training run on the CPU, whose spans carry the attr and whose trace holds
no device op."""
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
NAME = "adamw_fused_share.train"
CELL = "train-deepseek-v2-lite-16b"
UPDATE = ("void (anonymous namespace)::adamw_update_kernel<__nv_bfloat16>"
          "(...)")
NORM = ("void (anonymous namespace)::sum_squares_kernel<__nv_bfloat16>"
        "(...)")
FINISH = "void (anonymous namespace)::sum_finish_kernel(...)"
EAGER = "void at::native::vectorized_elementwise_kernel<4, ...>(...)"


def read(run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py",
                               "t_adamw_fused").read(run)


def update(start, end, **attrs):
    s = spans.Span("adamw.update", attrs)
    s.start, s.end = start * MS, end * MS
    return s


def attrs(numel, leaves=None):
    out = dict(numel=numel, grad_bytes=2 * numel, state_bytes=12 * numel,
               out_bytes=2 * numel)
    return out if leaves is None else dict(out, leaves=leaves)


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def run_of(ops):
    return harness.TracedRun(TraceData((W0, W1), sorted(
        ops, key=lambda op: op.start)), {}, None)


def step(launch, start, leaves, fused=True):
    """One update's device ops: the norm's pass a leaf and its finish, then
    each leaf's update (on the kernel, or in eager passes), each launched
    a microsecond after the last from ``launch``."""
    names = [NORM] * leaves + [FINISH] + (
        [UPDATE] * leaves if fused else [EAGER] * (3 * leaves))
    return [DeviceOp(n, start + 10 * i, start + 10 * i + 5, launch + 1000 * i)
            for i, n in enumerate(names)]


def test_share_of_the_windows_leaf_updates_on_the_kernel(log):
    log.append(update(110, 120, **attrs(1000, leaves=4)))
    log.append(update(140, 150, **attrs(1000, leaves=4)))
    log.append(update(90, 95, **attrs(1000, leaves=4)))      # before
    log.append(update(195, 205, **attrs(1000, leaves=4)))    # past the end
    ops = (step(111 * MS, 150 * MS, 4) + step(141 * MS, 160 * MS, 4)
           + step(91 * MS, 96 * MS, 4) + step(196 * MS, 199 * MS, 4))
    assert read(run_of(ops)) == 100.0
    # an update whose leaves took eager passes
    log.append(update(160, 170, **attrs(1000, leaves=4)))
    ops += step(161 * MS, 170 * MS, 4, fused=False)
    assert read(run_of(ops)) == pytest.approx(100 * 8 / 12)


def test_silent_without_the_attr_leaves_ops_or_log(log, monkeypatch):
    ops = step(111 * MS, 150 * MS, 4)
    assert read(run_of(ops)) is None                         # no spans
    log.append(update(110, 120, **attrs(1000)))              # the parent's
    assert read(run_of(ops)) is None
    log.append(update(130, 140, **attrs(1000, leaves=4)))
    assert read(run_of(ops)) is None                         # one without
    log.clear()
    log.append(update(110, 120, **attrs(0, leaves=0)))
    assert read(run_of(ops)) is None                         # no leaves
    log.clear()
    log.append(update(110, 120, **attrs(1000, leaves=4)))
    assert read(run_of([])) is None                          # no device op
    assert read(harness.TracedRun(None, {}, None)) is None   # untraced
    assert read(run_of(ops)) == 100.0
    import repro_torch.obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    monkeypatch.delattr(repro_torch.obs, "spans")
    assert read(run_of(ops)) is None


def test_traced_training_run_marks_the_leaves_on_the_cpu():
    c = tiny.cell(CELL)
    c.traffic.update(trace_seconds=0.3)
    first = spans.LOG[-1].index + 1 if spans.LOG else 0
    r = tiny.run(c.name, seconds=0.3, trace=True, c=c)
    ups = [s for s in spans.LOG
           if s.index >= first and s.name == "adamw.update"]
    assert ups and all(0 < s.attrs["leaves"] <= s.attrs["numel"]
                       for s in ups)
    # no kernel runs on the CPU: no reading
    assert NAME not in r["metrics"]


def test_the_metric_is_the_cells_alone():
    b = harness.benchmark()
    entry = next(m for m in b["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "train_tokens_per_s"
    assert entry["layer"] == next(m["layer"] for m in b["per_layer"]
                                  if m["name"] == "adamw_roofline.train")
    assert NAME in {m["name"] for m in harness.per_layer_of(CELL, b)}
