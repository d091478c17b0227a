"""The whole audit's share of the card's peak: the least time of every
byte hashed in the traced window (``work.bounds.checksum_s``, bound by HBM
bandwidth) over the window's length.  It bounds what any change to the
hash's kernels can gain end to end."""
from perfbench.work import bounds


def read(run):
    spans = run.trace.spans.get("audit.fold", []) if run.trace else []
    if not spans or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(bounds.checksum_s(s.attrs["bytes"])
                       for s in spans) / run.trace.window_s
