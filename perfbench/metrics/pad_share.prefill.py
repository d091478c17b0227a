"""Left-pad tokens over all tokens prefilled, over the waves of the traced
run's untraced lead: each wave prefills slots x its bucket, of which the
prompts are the real tokens."""


def read(run):
    waves = run.counters.get("waves") or []
    slots = run.counters.get("slots")
    total = sum(slots * w["width"] for w in waves) if slots else 0
    if not total:
        return None
    real = sum(sum(w["prompt_lens"]) for w in waves)
    return 100.0 * (total - real) / total
