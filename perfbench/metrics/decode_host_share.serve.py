"""The host's share of a decode step, untraced: the time the engine spends
inside ``LM.decode_step`` (the program's ``lm.decode_step`` spans: the
call returns once the step's work is enqueued) over the whole step
(``engine.decode``: until the step's tokens reach the host), summed over
the decode steps of the traced run's untraced lead.  Those are the last
``len(counters["decode_s"])`` ``engine.decode`` spans that ended before
the profiler's window; the reading stands only where there are that many,
each lies within 1% of its ``decode_s`` entry, and each holds its
``lm.decode_step``."""
from perfbench import program


def read(run):
    steps = run.counters.get("decode_s") or []
    outer = program.before_window(run, "engine.decode", len(steps))
    inner = program.before_window(run, "lm.decode_step", len(steps))
    if not steps or len(outer) != len(steps) or len(inner) != len(steps):
        return None
    for o, i, s in zip(outer, inner, steps):
        if abs((o.end - o.start) / 1e9 - s) > 0.01 * s \
                or not o.start <= i.start <= i.end <= o.end:
            return None
    return 100.0 * sum(i.end - i.start for i in inner) \
        / sum(o.end - o.start for o in outer)
