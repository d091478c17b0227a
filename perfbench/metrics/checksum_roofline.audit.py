"""B1's share of its roofline in the audit: the least time of the bytes
each hash call folded (``work.bounds.checksum_s``) over the device time of
the kernels that call launched (the ``audit.fold`` spans, synchronised at
both ends, so whatever kernels implement the hash are counted)."""
from perfbench.work import bounds


def read(run):
    spans = run.trace.spans.get("audit.fold", []) if run.trace else []
    device = sum(run.trace.in_span(s) for s in spans)
    if not spans or device <= 0:
        return None
    return 100.0 * sum(bounds.checksum_s(s.attrs["bytes"])
                       for s in spans) / device
