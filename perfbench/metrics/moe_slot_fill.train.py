"""The share of the MoE dispatch's expert rows that hold a kept routing:
over the program's ``moe.dispatch`` counts in the traced window (each the
routings of an expert block before capacity, with its capacity C and its
Eb experts), the sum of min(count, C) over the sum of Eb x C.  A forward
recomputed under remat counts again, which leaves the share as it is."""
import torch

from perfbench import program


def read(run):
    counts = program.in_window(run, "moe.dispatch")
    if not counts:
        return None
    kept = sum(int(torch.clamp(c.attrs["value"], max=c.attrs["C"]).sum())
               for c in counts)
    rows = sum(c.attrs["Eb"] * c.attrs["C"] for c in counts)
    return 100.0 * kept / rows
