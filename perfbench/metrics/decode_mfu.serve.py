"""The decode step's share of the card's bf16 peak: the model FLOPs of the
tokens the steps decoded (the ``token_flops`` of the family's module in
``work/``: each step's ``live`` sequences, each reading the t + 1
positions up to its own, ``t`` the step's position) over the steps'
seconds (``Engine.stats["decode_s"]``) times 989e12.  The steps are the
traced run's untraced lead, picked as ``decode_host_share.serve`` picks
them: the last ``len(counters["decode_s"])`` ``engine.decode`` spans that
ended before the profiler's window, each within 1% of its ``decode_s``
entry and carrying ``live`` and ``t``.  Silent for a family without
``token_flops``."""
import importlib

from perfbench import program, weights
from perfbench.work import peaks


def _token_flops(family: str):
    try:
        mod = importlib.import_module(f"perfbench.work.{family}")
    except ModuleNotFoundError:
        return None
    return getattr(mod, "token_flops", None)


def read(run):
    steps = run.counters.get("decode_s") or []
    outer = program.before_window(run, "engine.decode", len(steps))
    s = weights.sizes(run.cell.config)
    flops = _token_flops(s.family)
    if not steps or len(outer) != len(steps) or flops is None:
        return None
    for o, sec in zip(outer, steps):
        if abs((o.end - o.start) / 1e9 - sec) > 0.01 * sec \
                or "live" not in o.attrs or "t" not in o.attrs:
            return None
    work = sum(o.attrs["live"] * flops(s, o.attrs["t"] + 1) for o in outer)
    return 100.0 * work / (sum(steps) * peaks.BF16_FLOPS)
