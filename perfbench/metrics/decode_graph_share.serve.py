"""The share of the decode steps that replayed a CUDA graph: the
``lm.decode_step`` spans of the traced run's untraced lead (the last
``len(counters["decode_s"])`` that ended before the profiler's window, as
``decode_host_share.serve`` picks them) whose ``graph`` attr is
"replay", over those steps.  A program that does not mark the path
(no ``graph`` attr) gives no reading."""
from perfbench import program


def read(run):
    steps = run.counters.get("decode_s") or []
    inner = program.before_window(run, "lm.decode_step", len(steps))
    if not steps or len(inner) != len(steps) \
            or any("graph" not in s.attrs for s in inner):
        return None
    return 100.0 * sum(s.attrs["graph"] == "replay" for s in inner) \
        / len(inner)
