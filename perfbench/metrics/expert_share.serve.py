"""The dropless experts' share of the decode step's device time: the
device seconds of the ops launched inside the program's ``moe.experts``
spans that lie inside an ``engine.decode`` span, over the device seconds
of the ops launched inside those ``engine.decode`` spans, in the traced
window."""
from perfbench import program


def read(run):
    steps = program.in_window(run, "engine.decode")
    experts = [s for s in program.in_window(run, "moe.experts")
               if any(p.start <= s.start and s.end <= p.end for p in steps)]
    if not experts:
        return None
    whole = program.device_seconds(run.trace, steps)
    part = program.device_seconds(run.trace, experts)
    return 100.0 * part / whole if whole > 0 and part > 0 else None
