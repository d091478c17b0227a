"""Share of the traced window in which host-to-device copies ran: the
chunks ``StreamingChecksum`` sends to the card before each fold."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    h2d = run.trace.op_seconds(lambda n: n.startswith("Memcpy HtoD"))
    return 100.0 * h2d / run.trace.window_s if h2d > 0 else None
