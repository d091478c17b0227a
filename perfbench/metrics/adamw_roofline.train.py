"""AdamW's share of its roofline: the least time of the bytes an update
must move, over the device seconds of the kernels and copies launched
inside the program's ``adamw.update`` spans in the traced window.  The
bytes are the span's attrs: every gradient, master, m and v read once, and
master, m, v and the bf16 params written once (grad_bytes + 2 x
state_bytes + out_bytes); the global norm's second read of the gradients
is not counted, so no AdamW can read over 100%."""
from perfbench import program
from perfbench.work import peaks


def read(run):
    ups = program.in_window(run, "adamw.update")
    if not ups or not run.trace.ops:
        return None
    device = program.device_seconds(run.trace, ups)
    moved = sum(s.attrs["grad_bytes"] + 2 * s.attrs["state_bytes"]
                + s.attrs["out_bytes"] for s in ups)
    return 100.0 * moved / peaks.HBM_BYTES / device if device > 0 else None
