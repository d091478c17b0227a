"""Training driver: the port's train step (``train.loop.make_train_step``)
on fixed-size batches of uniform token ids.

Set-up makes the weights on the device from the seed, builds one model
(``remat`` as the traffic says), its AdamW state and the step, and drives
that step through its first ``check_steps`` steps on the window's own feed:
batch ``k`` is ``batch`` rows of ``seq + 1`` ids drawn from the seed, every
row its own.  Those steps are the warm-up and what the reference follows:
each step's loss, every leaf's first gradient as AdamW took it (its first
moment over 1 - b1, clipping included), and every leaf's change after the
last of them (the f32 master against the initial weights), all read before
the next step runs.  The window then runs whole steps on the following
batches until ``--seconds`` have passed, reading each loss as the port's
own loop does; ``train_tokens_per_s`` is its tokens over its span.

Judged after the window, with the program's state freed: the plain
reference runs the same steps from the regenerated weights in float32.
``loss_gap`` is the worst step's |loss - reference| over the reference's;
``grad_gap`` and ``change_gap`` the worst leaf's gap of norms, over the
larger of the reference leaf's norm and the median leaf's.  A leaf whose
reference gradient is under a thousandth of the median leaf's is left out
of ``change_gap``: AdamW moves it by round-off alone.  The control is the
reference in fp8, read the same way against the float32 reference.
"""
from __future__ import annotations

import importlib
import statistics
import time
from typing import Dict

import torch

from perfbench import gen, weights
from perfbench.harness import Context, Outcome, free_device, log
from perfbench.reference.precision import Precision
PROGRAM_AUX_WEIGHT = 0.01          # the port's loss_fn default
QUIET = 1e-3


def batch(tr: dict, vocab: int, seed: int, k: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(gen.torch_seed(seed, 40, k))
    ids = torch.randint(0, vocab, (tr["batch"], tr["seq"] + 1),
                        generator=g, device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _norms(tree) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(x.float()))
            for p, x in weights.walk(tree)}


def run(ctx: Context) -> Outcome:
    dev, tr, cfg = ctx.device, ctx.cell.traffic, ctx.cell.config
    s = weights.sizes(cfg)
    if s.aux_weight != PROGRAM_AUX_WEIGHT:
        raise ValueError(f"the port's loss weighs aux by "
                         f"{PROGRAM_AUX_WEIGHT}, not {s.aux_weight}")
    wseed = gen.torch_seed(ctx.seed, 10)
    prog, steps, peak = _train(ctx, s, wseed)
    free_device(dev)
    span = ctx.window_end - ctx.window_start
    ref = _reference(ctx, s, wseed, Precision("f32"))
    readings = _gaps(prog, ref)
    control = {}
    if ctx.control:
        control = _gaps(_reference(ctx, s, wseed, Precision("fp8")), ref)
    free_device(dev)
    return Outcome(
        metrics={"train_tokens_per_s":
                 steps * tr["batch"] * tr["seq"] / span},
        attempted=steps, failed=0, readings=readings, memory_peak=peak,
        control=control)


def _train(ctx: Context, s, wseed: int):
    """Set-up, the checked steps and the window; the program's state goes
    out of scope on return.  ({"loss", "grad", "change"}, window steps,
    peak device memory)."""
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, make_train_step
    dev, tr, cfg = ctx.device, ctx.cell.traffic, ctx.cell.config
    tracer = ctx.tracer
    init = weights.tree(cfg, wseed, dev)
    model = LM(weights.family(cfg).model_config(cfg), dtype=torch.bfloat16,
               device=dev, params=init, remat=tr["remat"])
    model.requires_grad_(True)
    opt_state = adamw.init(model.params())
    opt = adamw.AdamWConfig(**tr["adamw"])
    step_fn = make_train_step(model, opt, TrainConfig(
        steps=tr["schedule_steps"], batch_size=tr["batch"],
        seq_len=tr["seq"], peak_lr=tr["peak_lr"], warmup=tr["warmup"],
        remat=tr["remat"], device=dev))
    update = adamw.update

    def traced_update(*args, **kw):
        with tracer.span("train.adamw", sync=True):
            return update(*args, **kw)
    out: dict = {"loss": []}
    for k in range(tr["check_steps"]):
        _, opt_state, loss, _ = step_fn(opt_state, batch(tr, s.vocab,
                                                         ctx.seed, k, dev))
        out["loss"].append(float(loss))
        if k == 0:
            out["grad"] = {p: n / (1 - opt.b1)
                           for p, n in _norms(opt_state.m).items()}
    start = dict(weights.walk(init))
    out["change"] = {p: float(torch.linalg.vector_norm(
        x - start[p].float())) for p, x in weights.walk(opt_state.master)}
    del init, start
    if tracer.on:
        adamw.update = traced_update
    try:
        ctx.start_window()
        k = tr["check_steps"]
        while True:
            with tracer.span("train.fwd_bwd"):
                _, opt_state, loss, _ = step_fn(
                    opt_state, batch(tr, s.vocab, ctx.seed, k, dev))
                float(loss)
            k += 1
            tracer.tick()
            if ctx.done():
                break
        ctx.end_window()
    finally:
        adamw.update = update
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return out, k - tr["check_steps"], peak


def _reference(ctx: Context, s, wseed: int, prec: Precision) -> dict:
    tr, dev = ctx.cell.traffic, ctx.device
    tree = weights.tree(ctx.cell.config, wseed, dev)
    batches = [(b["tokens"], b["labels"]) for b in
               (batch(tr, s.vocab, ctx.seed, k, dev)
                for k in range(tr["check_steps"]))]
    ref = importlib.import_module(f"perfbench.reference.{s.family}_lm")

    def lr(step):
        return ref.warmup_cosine(step, tr["peak_lr"], tr["warmup"],
                                 tr["schedule_steps"])
    out = ref.train(tree, s, batches, tr["adamw"], lr, prec)
    del tree
    free_device(dev)
    return out


def _worst(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    floor = statistics.median(want.values())
    return max(abs(got[p] - want[p]) / max(want[p], floor) for p in leaves)


def _gaps(got: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of ``got`` against the float32 reference."""
    quiet = QUIET * statistics.median(ref["raw_grad"].values())
    moved = [p for p, g in ref["raw_grad"].items() if g >= quiet]
    if len(moved) < len(ref["raw_grad"]):
        quiet_leaves = sorted(set(ref["raw_grad"]) - set(moved))
        log(f"left out of change_gap: {quiet_leaves}")
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got["loss"], ref["loss"])),
            "grad_gap": _worst(got["grad"], ref["grad"], ref["grad"]),
            "change_gap": _worst(got["change"], ref["change"], moved)}
