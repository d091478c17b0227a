"""Prefill's share of the card's bf16 peak: the model FLOPs of the prompt
tokens asked (pads excluded; logits at each request's last position) over
the engine's prefill seconds (``Engine.stats["prefill_s"]``) of the waves
of the traced run's untraced lead, times 989e12."""
from perfbench import weights
from perfbench.work import flops, peaks


def read(run):
    waves = run.counters.get("waves") or []
    s = weights.sizes(run.cell.config)
    if not waves or s.family != "mamba1":
        return None
    work = sum(flops.mamba1_forward(s, sum(w["prompt_lens"]),
                                    len(w["prompt_lens"])) for w in waves)
    secs = sum(w["prefill_s"] for w in waves)
    return 100.0 * work / (secs * peaks.BF16_FLOPS) if secs > 0 else None
