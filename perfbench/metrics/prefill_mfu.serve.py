"""Prefill's share of the card's bf16 peak, for any family whose
``work/<family>.py`` gives ``prompt_flops``: the model FLOPs of the prompt
tokens asked (pads excluded; logits at each request's last position) over
the engine's prefill seconds (``Engine.stats["prefill_s"]``) of the waves
of the traced run's untraced lead, times 989e12.  Silent for a family
without it."""
import importlib

from perfbench import weights
from perfbench.work import peaks


def read(run):
    waves = run.counters.get("waves") or []
    s = weights.sizes(run.cell.config)
    try:
        work = importlib.import_module(f"perfbench.work.{s.family}")
    except ModuleNotFoundError:
        return None
    flops = getattr(work, "prompt_flops", None)
    secs = sum(w["prefill_s"] for w in waves)
    if flops is None or not waves or secs <= 0:
        return None
    done = sum(flops(s, w["prompt_lens"]) for w in waves)
    return 100.0 * done / (secs * peaks.BF16_FLOPS)
