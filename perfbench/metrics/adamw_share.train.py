"""AdamW's share of the training step: the device time of the kernels
``optim.adamw.update`` launched (its ``train.adamw`` spans, synchronised
at both ends) over the host time of the traced steps."""


def read(run):
    if run.trace is None:
        return None
    steps = run.trace.spans.get("train.fwd_bwd", [])
    upd = run.trace.spans.get("train.adamw", [])
    secs = sum(sp.end - sp.start for sp in steps) / 1e9
    if not steps or not upd or secs <= 0:
        return None
    return 100.0 * sum(run.trace.in_span(s) for s in upd) / secs
