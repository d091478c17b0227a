"""Median decode step of the traced run's untraced lead, in ms, as the
engine times it (``Engine.stats["decode_s"]``: a step until its tokens
reach the host); the profiler is off, so the step is as it runs."""
import statistics


def read(run):
    steps = run.counters.get("decode_s") or []
    return 1e3 * statistics.median(steps) if steps else None
