"""What several per-layer readers share."""


def idle_share(run):
    """Share of the traced window with no device activity, in %."""
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
