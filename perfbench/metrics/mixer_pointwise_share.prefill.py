"""The Mamba1 mixer's f32 pointwise stages' share of prefill's device time:
the device seconds launched inside the program's ``mamba1.conv`` (the
causal conv and SiLU) and ``mamba1.gate`` (``y + D xc``, the SiLU gate)
spans that lie inside an ``engine.prefill`` span, over the device seconds
launched inside those ``engine.prefill`` spans, in the traced window."""
from perfbench import program


def read(run):
    pre = program.in_window(run, "engine.prefill")
    mix = [s for name in ("mamba1.conv", "mamba1.gate")
           for s in program.in_window(run, name)
           if any(p.start <= s.start and s.end <= p.end for p in pre)]
    if not mix:
        return None
    whole = program.device_seconds(run.trace, pre)
    part = program.device_seconds(run.trace, mix)
    return 100.0 * part / whole if whole > 0 and part > 0 else None
