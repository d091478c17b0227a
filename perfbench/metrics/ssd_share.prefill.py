"""Mamba2's chunked SSD's share of prefill's device time: the device
seconds launched inside the program's ``mamba2.ssd`` spans that lie inside
an ``engine.prefill`` span, over the device seconds launched inside those
``engine.prefill`` spans, in the traced window."""
from perfbench import program


def read(run):
    pre = program.in_window(run, "engine.prefill")
    ssd = [s for s in program.in_window(run, "mamba2.ssd")
           if any(p.start <= s.start and s.end <= p.end for p in pre)]
    if not ssd:
        return None
    whole = program.device_seconds(run.trace, pre)
    part = program.device_seconds(run.trace, ssd)
    return 100.0 * part / whole if whole > 0 and part > 0 else None
