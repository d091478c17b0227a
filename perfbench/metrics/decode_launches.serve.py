"""Host launches a decode step: the distinct launch stamps of the kernels,
copies and fills launched inside the traced window's ``engine.decode``
spans (the program's), over their number."""
from perfbench import program


def read(run):
    steps = program.in_window(run, "engine.decode")
    if not steps or not run.trace.ops:
        return None
    n = sum(program.launches(run.trace, s) for s in steps)
    return n / len(steps) if n else None
