"""The share of the decode steps' Mamba1 layer-steps that ran on the fused
selective-state kernel: the device ops whose name holds
``mamba_state_step_kernel`` launched inside the traced window's
``lm.decode_step`` spans (a replayed CUDA graph's kernels carry its
launch's correlation id, so they count in the span that launched the
graph), over the sum of those spans' ``mamba1_layers`` attr, the model's
count of Mamba1 mixers.  A program that does not mark the count (no
``mamba1_layers`` attr), a model without Mamba1 mixers, or a trace with no
device op gives no reading.  A step that captures a graph runs its body
twice (a warm-up and the capture) and reads 200% alone."""
from perfbench import program

KERNEL = "mamba_state_step_kernel"


def read(run):
    steps = program.in_window(run, "lm.decode_step")
    if not steps or not run.trace.ops \
            or any("mamba1_layers" not in s.attrs for s in steps):
        return None
    layers = sum(s.attrs["mamba1_layers"] for s in steps)
    if not layers:
        return None
    fused = sum(KERNEL in op.name for s in steps
                for op in program.launched(run.trace, s))
    return 100.0 * fused / layers
