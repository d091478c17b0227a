"""Readings for setting a cell's correctness limits: the program's numbers
over many seeds and the control's, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds <s> [--fault NAME] [--out FILE]

Each seed is one run of the cell (set-up, window, judgement) as
``run.py`` makes it, on the card; a seed in ``--control-seeds`` also reads
the control (the reference in the precision below the configuration's, or
for the audit a verification by size alone).  ``--fault`` plants one of
``faults.py``'s faults under every run, to read what it does to the
compared numbers.  Prints one JSON line a run
and writes them all to ``--out``.  The benchmark's own runs never read the
control.
"""
import json
import time

import run as _run  # the command's environment and import paths


def main(argv=None) -> int:
    import argparse
    import sys
    _run._environment()
    from perfbench import harness
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    bench = harness.benchmark()
    cell = harness.find_cell(args.workload, bench)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    from perfbench import faults
    patches = faults.Patches()
    if args.fault:
        getattr(faults, args.fault)(patches.setattr)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                               bench, control=seed in controls)
        out = res.pop("_outcome")
        row = {"seed": seed, "fault": args.fault, "correct": res["correct"],
               "readings": out.readings, "control": out.control,
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "attempted": out.attempted,
               "memory_peak_bytes": out.memory_peak,
               "wall_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        harness.free_device(torch.device("cuda"))
    patches.undo()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if not harness.forbidden_modules() else 3


if __name__ == "__main__":
    raise SystemExit(main())
