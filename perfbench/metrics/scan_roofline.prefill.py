"""B4's share of its roofline in prefill: the least time of each scan
call from its shapes (``work.bounds.scan_s``) over the device time of the
kernels that call launched (the ``prefill.scan`` spans, synchronised at
both ends)."""
from perfbench.work import bounds


def read(run):
    spans = run.trace.spans.get("prefill.scan", []) if run.trace else []
    device = sum(run.trace.in_span(s) for s in spans)
    if not spans or device <= 0:
        return None
    return 100.0 * sum(bounds.scan_s(s.attrs["B"], s.attrs["T"],
                                     s.attrs["D"], s.attrs["N"])
                       for s in spans) / device
