"""The hot path's span log (``repro_torch.obs.spans``): its records, its
bound, its two grades, its clock against the torch profiler's, and the
spans and counts the engine, the Mamba1 mixer, AdamW and the MoE dispatch
record."""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.obs import spans
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine


@pytest.fixture
def log(monkeypatch):
    """A fresh log of the default capacity for the test."""
    fresh = deque(maxlen=spans.CAPACITY)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


@pytest.fixture
def profiling():
    """A CPU torch profiler running around the test."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        yield prof


def _names(log):
    return [r.name for r in log]


def test_spans_nest_with_parent_indices(log):
    with spans.span("outer", k=1) as a:
        with spans.span("inner") as b:
            pass
        with spans.span("second") as c:
            with spans.span("deep") as d:
                pass
    with spans.span("after") as e:
        pass
    assert _names(log) == ["outer", "inner", "second", "deep", "after"]
    assert [r.parent for r in log] == [None, a.index, a.index, c.index, None]
    assert a.index < b.index < c.index < d.index < e.index
    assert a.attrs == {"k": 1} and b.attrs == {}
    for r in log:
        assert 0 < r.start <= r.end
    assert a.start <= b.start <= b.end <= c.start <= d.end <= c.end <= a.end
    assert a.seconds == (a.end - a.start) / 1e9


def test_the_log_is_bounded_and_evicts_the_oldest(monkeypatch):
    small = deque(maxlen=4)
    monkeypatch.setattr(spans, "LOG", small)
    made = []
    for i in range(10):
        with spans.span(f"s{i}") as sp:
            made.append(sp)
    assert len(small) == 4
    assert list(small) == made[-4:]
    assert spans.LOG.maxlen == 4
    assert spans.CAPACITY >= 1 << 14


def test_fine_spans_and_counts_record_nothing_without_a_profiler(
        log, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    stamps = []
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: stamps.append(1) or real())
    with spans.fine("f", a=1) as f:
        spans.count("c", torch.ones(3), C=2)
    assert f is None and not log and not stamps
    # a coarse span is recorded all the same
    with spans.span("coarse"):
        pass
    assert _names(log) == ["coarse"] and len(stamps) == 2


def test_fine_spans_and_counts_record_under_a_profiler(log, profiling):
    value = torch.arange(4)
    with spans.span("coarse") as a:
        with spans.fine("f", a=1) as f:
            spans.count("c", value, C=2)
    assert _names(log) == ["coarse", "f", "c"]
    c = log[2]
    assert f.parent == a.index and c.parent == f.index
    assert c.value is value and c.attrs == {"C": 2}
    assert f.start <= c.at <= f.end


def test_spans_share_the_profiler_clock(log):
    """A span opened around a ``record_function`` brackets the profiler's
    event within 1 ms at both ends: the log and the trace share a clock."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with spans.span("around") as sp:
                with torch.profiler.record_function("inside"):
                    torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inside"]
    around = [r for r in log if r.name == "around"]
    assert len(events) == len(around) == 3
    for e, sp in zip(sorted(events, key=lambda e: e.start_ns()), around):
        assert sp.start <= e.start_ns() + 1_000_000
        assert e.start_ns() - sp.start <= 1_000_000
        assert e.end_ns() <= sp.end + 1_000_000
        assert sp.end - e.end_ns() <= 1_000_000


def test_engine_spans_are_its_stats(log):
    cfg = get_config("falcon-mamba-7b").smoke()
    eng = Engine(cfg, model=LM(cfg, device="cpu", seed=0), max_batch=2,
                 max_seq=40, device="cpu")
    rng = np.random.default_rng(0)
    for n, new in ((5, 4), (9, 3), (12, 5)):
        eng.submit(rng.integers(0, cfg.vocab_size, n), new)
    eng.run_to_completion()
    assert eng.waves == 2
    pre = [r for r in log if r.name == "engine.prefill"]
    dec = [r for r in log if r.name == "engine.decode"]
    step = [r for r in log if r.name == "lm.decode_step"]
    assert len(pre) == eng.waves
    assert [p.attrs for p in pre] == [
        dict(wave=1, B=2, T=16, prompt_tokens=14),
        dict(wave=2, B=2, T=16, prompt_tokens=12)]
    assert len(dec) == len(step) == len(eng.stats["decode_s"]) > 0
    for d, s in zip(dec, step):
        assert s.parent == d.index and d.parent is None
        assert d.start <= s.start <= s.end <= d.end
        # the path the model took (the CPU decodes eagerly) and the
        # model's Mamba1 mixers, each of which the step runs once
        assert s.attrs == {"graph": "eager", "mamba1_layers": cfg.n_layers}
    assert eng.stats["prefill_s"] == [p.seconds for p in pre]
    assert eng.stats["decode_s"] == [d.seconds for d in dec]
    # no profiler: the mixer's fine spans took no record
    assert not [r for r in log if r.name.startswith("mamba1.")]


def test_mamba1_mixer_fine_spans_under_a_profiler(log, profiling):
    cfg = get_config("falcon-mamba-7b").smoke()
    lm = LM(cfg, device="cpu", seed=0)
    with torch.no_grad():
        lm.forward(torch.zeros((1, 8), dtype=torch.long))
    conv = [r for r in log if r.name == "mamba1.conv"]
    gate = [r for r in log if r.name == "mamba1.gate"]
    assert len(conv) == len(gate) == cfg.n_layers
    for c, g in zip(conv, gate):
        assert c.end <= g.start


def _tree(dtype):
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(6, 5, generator=g).to(dtype),
            "blocks": [{"a": torch.randn(7, generator=g)},
                       {"a": torch.randn(7, generator=g)}],
            "b": torch.randn(3, generator=g).to(dtype)}


def _own_bytes(params, grads, state):
    from repro_torch import tree as T
    leaves = T.leaves(params)
    n = sum(p.numel() for p in leaves)
    return {"numel": n,
            "grad_bytes": sum(g.numel() * g.element_size()
                              for g in T.leaves(grads)),
            "state_bytes": sum(x.numel() * x.element_size()
                               for t in (state.master, state.m, state.v)
                               for x in T.leaves(t)),
            "out_bytes": 2 * n,
            "leaves": sum(1 for p in leaves if p.numel())}


def test_adamw_span_carries_the_trees_own_bytes(log):
    from repro_torch import tree as T
    params = _tree(torch.bfloat16)
    grads = T.tree_map(lambda p: torch.ones_like(p), params)
    state = adamw.init(params)
    want = _own_bytes(params, grads, state)
    lr = torch.tensor(1e-3)
    _, state, _ = adamw.update(grads, state, lr)
    _, state, _ = adamw.update(grads, state, lr)
    ups = [r for r in log if r.name == "adamw.update"]
    assert len(ups) == 2 and ups[0].attrs == want
    assert ups[1].attrs is ups[0].attrs          # cached for the tree
    assert want["state_bytes"] == 12 * want["numel"]
    assert want["grad_bytes"] == 2 * (30 + 3) + 4 * 14
    assert want["leaves"] == 4
    # another tree, other gradients' dtype: counted anew
    other = T.tree_map(lambda p: p.float(), params)
    grads32 = T.tree_map(lambda p: torch.ones_like(p), other)
    state32 = adamw.init(other)
    adamw.update(grads32, state32, lr)
    assert log[-1].attrs == _own_bytes(other, grads32, state32)
    assert log[-1].attrs["grad_bytes"] == 4 * want["numel"]


@pytest.mark.parametrize("e0,Eb", [(0, 0), (0, 4), (4, 4), (2, 3)])
def test_moe_dispatch_count_gives_the_kept_rows(log, profiling, e0, Eb):
    E, C = 8, 5
    g = torch.Generator().manual_seed(3)
    top_i = torch.randint(0, E, (40, 2), generator=g)
    _, keep = moe._dispatch(top_i, C, E, e0, Eb)
    (c,) = [r for r in log if r.name == "moe.dispatch"]
    assert c.attrs == {"C": C, "Eb": Eb or E}
    assert c.value.shape == (Eb or E,)
    assert int(torch.clamp(c.value, max=C).sum()) == int(keep.sum())


def test_moe_holds_no_count_without_a_profiler(log):
    cfg = get_config("deepseek-v2-lite-16b").smoke()
    lm = LM(cfg, device="cpu", seed=0)
    with torch.no_grad():
        lm.forward(torch.zeros((1, 8), dtype=torch.long))
    assert not [r for r in log if r.name == "moe.dispatch"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            lm.forward(torch.zeros((1, 8), dtype=torch.long))
    counts = [r for r in log if r.name == "moe.dispatch"]
    assert counts and all(isinstance(c.value, torch.Tensor) for c in counts)
