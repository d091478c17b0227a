"""Serving driver: closed-loop clients against the port's ``Engine``.

Set-up makes the weights on the device from the seed, builds the model and
the engine (``slots`` sequences, a cache of ``max_seq`` positions), and
serves one warm-up wave of the traffic's prompt lengths (its own ids) for
``warm_new_tokens`` tokens: the prefill bucket and the decode step the
window uses.

The window: ``slots`` closed-loop clients, each sending its next request
when its last one returns; the engine admits them as one wave, so every
wave holds one request of each client.  A wave's prompt lengths and output lengths
are the traffic's distributions at ``slots`` stratified quantiles, paired
and ordered by the seed; the ids are uniform from the seed.  The window
runs whole waves until ``--seconds`` have passed.  Time to first token is
taken on the host from a request's ``submit`` to the engine's first
greedy pick of its wave (a wrapper on the engine's ``_greedy``), not from
the engine's own ``prefill_s``.

Judged after the window, with the program's state freed: ``check_requests``
finished requests drawn from the seed, the one with most served tokens
among them, are run through the plain reference over the prompt as the
engine served it (left-padded with id 0 to its wave's bucket) followed by
its served tokens; ``logit_gap`` is the widest gap by which a served
token's reference logit lies below the reference's best at its position.
The control reads the same gap for the token the fp8 reference puts first.
"""
from __future__ import annotations

import importlib
import time
from typing import List

import numpy as np
import torch

from perfbench import gen, weights
from perfbench.harness import Context, Outcome, free_device, log
from perfbench.reference.precision import Precision


def wave(tr: dict, vocab: int, seed: int, index: int):
    """Wave ``index``'s requests: [(prompt ids, new tokens)]."""
    n = tr["slots"]
    lens = gen.stratified(tr["prompt_len"], n)
    news = gen.stratified(tr["new_tokens"], n)
    lp = gen.permutation(seed, n, 20, index)
    ln = gen.permutation(seed, n, 21, index)
    r = gen.rng(seed, 22, index)
    return [(r.integers(0, vocab, lens[i]).astype(np.int32), news[j])
            for i, j in zip(lp, ln)]


def run(ctx: Context) -> Outcome:
    dev, tr, cfg = ctx.device, ctx.cell.traffic, ctx.cell.config
    s = weights.sizes(cfg)
    wseed = gen.torch_seed(ctx.seed, 10)
    served, counters, peak = _serve(ctx, s, wseed)
    free_device(dev)
    span = ctx.window_end - ctx.window_start
    sample = _sample(served, tr["check_requests"], ctx.seed)
    ref_tree = weights.tree(cfg, wseed, dev)
    readings, control = _judge(ref_tree, s, sample, dev, ctx.control)
    del ref_tree
    free_device(dev)
    tokens = sum(len(r["out"]) for r in served)
    ttft = np.array([r["ttft"] for r in served])
    return Outcome(
        metrics={"serve_tokens_per_s": tokens / span,
                 "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3},
        attempted=len(served),
        failed=sum(len(r["out"]) != r["new"] for r in served),
        readings=readings, memory_peak=peak, counters=counters,
        control=control)


def _serve(ctx: Context, s, wseed: int):
    """Set-up and the window; the program's state goes out of scope on
    return.  (served requests, trace counters, peak device memory)."""
    from repro_torch.models import ssm
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Engine
    dev, tr, cfg = ctx.device, ctx.cell.traffic, ctx.cell.config
    mcfg = weights.family(cfg).model_config(cfg)
    model = LM(mcfg, dtype=torch.bfloat16, device=dev,
               params=weights.tree(cfg, wseed, dev))
    engine = Engine(mcfg, model=model, max_batch=tr["slots"],
                    max_seq=tr["max_seq"], device=dev)
    tracer = ctx.tracer
    first = {}
    widths: List[int] = []
    greedy, prefill, decode = engine._greedy, model.prefill, model.decode_step
    scan = ssm.selective_scan

    def timed_greedy(logits):
        out = greedy(logits)
        first.setdefault("t", time.perf_counter())
        tracer.tick(whole=False)
        return out

    def traced_prefill(inputs, cache):
        widths.append(inputs.shape[1])
        with tracer.span("serve.prefill"):
            return prefill(inputs, cache)

    def traced_decode(cache, token, t):
        with tracer.span("serve.decode"):
            return decode(cache, token, t)

    def traced_scan(u, dt, Bm, Cm, A, h0):
        B, T, D = u.shape
        with tracer.span("prefill.scan", sync=True, B=B, T=T, D=D,
                         N=Bm.shape[-1]):
            return scan(u, dt, Bm, Cm, A, h0)
    engine._greedy = timed_greedy
    model.prefill = traced_prefill
    model.decode_step = traced_decode
    marks = {}

    def mark(key):
        marks[key] = (len(engine.stats["prefill_s"]),
                      len(engine.stats["decode_s"]))
    tracer.on_start.append(lambda: mark("traced"))
    tracer.on_stop.append(lambda: mark("stop"))
    if tracer.on:
        ssm.selective_scan = traced_scan
    try:
        for prompt, _ in wave(tr, s.vocab, ctx.seed, -1):
            engine.submit(prompt, tr["warm_new_tokens"])
        engine.run_to_completion()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        n_warm = len(widths)
        mark("start")
        served = []
        ctx.start_window()
        i = 0
        while True:
            reqs = wave(tr, s.vocab, ctx.seed, i)
            first.clear()
            sent = {}
            for prompt, new in reqs:
                sent[engine.submit(prompt, new)] = time.perf_counter()
            for r in engine.run_to_completion():
                served.append(dict(rid=r.rid, wave=i, prompt=r.prompt,
                                   out=list(r.out_tokens),
                                   new=r.max_new_tokens,
                                   ttft=first["t"] - sent[r.rid],
                                   width=widths[n_warm + i]))
            i += 1
            tracer.tick()
            if ctx.done():
                break
        ctx.end_window()
    finally:
        ssm.selective_scan = scan
        tracer.on_start.clear()
        tracer.on_stop.clear()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return served, _counters(engine, marks, widths, n_warm, served,
                             tr["slots"]), peak


def _counters(engine, marks, widths, n_warm, served, slots) -> dict:
    """The waves and decode steps of the traced run's untraced lead, as the
    engine timed them: those whose entries fell between the window's start
    and the profiler's."""
    if "stop" not in marks:
        return {}
    (p0, d0), (p1, d1) = marks["start"], marks["traced"]
    steps, end = engine.stats["decode_s"], marks["stop"][1]
    if end > d1 > d0:
        log(f"decode step median {1e3 * np.median(steps[d0:d1]):.2f} ms "
            f"untraced ({d1 - d0} steps), "
            f"{1e3 * np.median(steps[d1:end]):.2f} ms traced ({end - d1})")
    lens = {}
    for r in served:
        lens.setdefault(r["wave"], []).append(len(r["prompt"]))
    waves = [dict(width=widths[k], prompt_lens=lens[k - n_warm],
                  prefill_s=engine.stats["prefill_s"][k])
             for k in range(p0, p1) if k - n_warm in lens]
    return {"slots": slots, "waves": waves,
            "decode_s": steps[d0:d1]}


def _sample(served, n: int, seed: int):
    longest = max(range(len(served)), key=lambda i: len(served[i]["out"]))
    rest = [i for i in range(len(served)) if i != longest]
    r = gen.rng(seed, 30)
    pick = r.choice(len(rest), min(n - 1, len(rest)), replace=False)
    return [served[longest]] + [served[rest[i]] for i in sorted(pick)]


def _judge(tree, s, sample, dev, control: bool):
    """``logit_gap`` of the served tokens, and the control's."""
    ref = importlib.import_module(f"perfbench.reference.{s.family}_lm")
    rows, positions = [], []
    for r in sample:
        pad = r["width"] - len(r["prompt"])
        seq = [0] * pad + [int(t) for t in r["prompt"]] + r["out"][:-1]
        rows.append(seq)
        positions.append(range(r["width"] - 1, len(seq)))
    L = max(len(x) for x in rows)
    tokens = torch.tensor([x + [0] * (L - len(x)) for x in rows],
                          dtype=torch.long, device=dev)
    want = ref.logits_at(tree, s, tokens, positions)
    served = [torch.tensor(r["out"], device=dev) for r in sample]
    gap = max(float((w.max(-1).values - w.gather(1, t[:, None])[:, 0])
                    .max()) for w, t in zip(want, served))
    readings = {"logit_gap": gap}
    out = {}
    if control:
        low = ref.logits_at(tree, s, tokens, positions, Precision("fp8"))
        out["logit_gap"] = max(
            float((w.max(-1).values
                   - w.gather(1, c.argmax(-1)[:, None])[:, 0]).max())
            for w, c in zip(want, low))
    return readings, out
