"""The dropless experts' share of their roofline in decode: over the
program's ``moe.experts`` spans that lie inside an ``engine.decode`` span
of the traced window, the least time of each (``work.experts.expert_bytes``
of the ``moe.load`` count it holds, the routings per expert, over
3.35e12 B/s), summed, over the device seconds of the ops launched in
those spans.  Silent without those spans and counts, or where the cell's
sizes lack what the bytes are made of."""
from perfbench import program, weights
from perfbench.work import experts as work, peaks


def read(run):
    steps = program.in_window(run, "engine.decode")
    calls = [s for s in program.in_window(run, "moe.experts")
             if any(p.start <= s.start and s.end <= p.end for p in steps)]
    loads = program.in_window(run, "moe.load")
    s = weights.sizes(run.cell.config)
    if not calls or not loads or not all(hasattr(s, k) for k in work.NEEDS):
        return None
    moved = 0
    for sp in calls:
        held = [c for c in loads if sp.start <= c.start <= sp.end]
        if len(held) != 1:
            return None
        moved += work.expert_bytes(s, held[0].attrs["value"])
    device = program.device_seconds(run.trace, calls)
    return 100.0 * moved / peaks.HBM_BYTES / device if device > 0 else None
