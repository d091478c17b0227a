"""The share of AdamW's leaf updates that ran on the fused update kernel:
the device ops whose name holds ``adamw_update_kernel`` launched inside the
traced window's ``adamw.update`` spans, over the sum of those spans'
``leaves`` attr, the leaves whose local shard holds an element (one launch
each).  A program that does not mark the count (no ``leaves`` attr), a
window without updates, or a trace with no device op gives no reading."""
from perfbench import program

KERNEL = "adamw_update_kernel"


def read(run):
    ups = program.in_window(run, "adamw.update")
    if not ups or not run.trace.ops \
            or any("leaves" not in s.attrs for s in ups):
        return None
    leaves = sum(s.attrs["leaves"] for s in ups)
    if not leaves:
        return None
    fused = sum(KERNEL in op.name for s in ups
                for op in program.launched(run.trace, s))
    return 100.0 * fused / leaves
