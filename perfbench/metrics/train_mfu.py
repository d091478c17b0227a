"""The training step's share of the card's bf16 peak: the model FLOPs of
a step (``work.flops.mla_moe_train_step``: three forwards, no
recomputation) times the traced steps, over the host time of those steps
(the ``train.fwd_bwd`` spans, each ending when its loss reached the host),
times 989e12."""
from perfbench import weights
from perfbench.work import flops, peaks


def read(run):
    spans = run.trace.spans.get("train.fwd_bwd", []) if run.trace else []
    s = weights.sizes(run.cell.config)
    if not spans or s.family != "mla_moe":
        return None
    tr = run.cell.traffic
    work = len(spans) * flops.mla_moe_train_step(s, tr["batch"], tr["seq"])
    secs = sum(sp.end - sp.start for sp in spans) / 1e9
    return 100.0 * work / (secs * peaks.BF16_FLOPS)
