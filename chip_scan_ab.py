#!/usr/bin/env python3
"""Time this tree's selective-scan kernel against another tree's, on one card.

Run from the repository root:

    python3 chip_scan_ab.py --other DIR [--rounds 2]

DIR is the root of another checkout of this repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Each tree's ``src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu`` is
built into its own library (``kernels.nvcc.CudaLibrary``) and called through
``repro_selective_scan``, whose C signature both share (each library picks
its own layout).  At every case of ``chip_smoke.SCAN_CASES`` both kernels
are held to the plain PyTorch version (rtol/atol 1e-4) and timed by
``chip_smoke.device_ms_per_call`` (the profiler's device time per call), in
turns: other, this, this, other, for ``--rounds`` rounds.  Prints the card
and one JSON line per case, then a summary line.  It needs a CUDA card and
``nvcc``, and imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = Path("src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu")


def bind(lib: ctypes.CDLL) -> None:
    lib.repro_selective_scan.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 8
        + [ctypes.c_void_p])
    lib.repro_selective_scan.restype = ctypes.c_int


def launcher(torch, lib):
    """The scan through ``lib``'s C interface, on the current stream; new
    (y, hT) outputs."""
    def run(u, dt, Bm, Cm, A, h0):
        B, T, D = u.shape
        y = torch.empty_like(u)
        hT = torch.empty_like(h0)
        strides = [s for x in (u, dt, Bm, Cm) for s in x.stride()[:2]]
        err = lib.repro_selective_scan(
            *(x.data_ptr() for x in (u, dt, Bm, Cm, A, h0, y, hT)),
            B, T, D, A.shape[1], *strides,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return y, hT
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    import chip_smoke as smoke
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs a "
                   "CUDA GPU")
    from repro_torch.kernels.mamba_scan.ref import selective_scan_torch
    from repro_torch.kernels.nvcc import CudaLibrary

    libs = {}
    for label, root in (("other", args.other.resolve()), ("this", ROOT)):
        source = root / SOURCE
        smoke.check(source.is_file(), f"no {source}")
        lib = CudaLibrary(source, f"mamba_scan_ab_{label}", bind)
        libs[label] = launcher(torch, lib.load())
        smoke.log(f"{label}: {source} built; ptxas: "
                  f"{smoke.ptxas_kernels(lib.build_log)}")
    card = smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    smoke.log(card.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 4)
    summary = {}
    for label, B, T, D, N, kind in smoke.SCAN_CASES:
        ins = smoke.scan_inputs(torch, gen, B, T, D, N, model=kind == "model")
        plain = selective_scan_torch(*ins)
        it = 10 if T >= 4096 else 20
        times = {"other": [], "this": []}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                run = libs[who]
                got = run(*ins)
                smoke.check(all(torch.allclose(g, w, **smoke.SCAN_TOL)
                                for g, w in zip(got, plain)),
                            f"{who} differs from the plain version at "
                            f"{label}")
                ms, _ = smoke.device_ms_per_call(
                    torch, lambda: run(*ins), it)  # noqa: B023
                times[who].append(ms)
        row = {"case": label, "shape": [B, T, D, N], "inputs": kind,
               "other_ms": times["other"], "this_ms": times["this"]}
        if all(times[w] and None not in times[w] for w in times):
            row["other_over_this"] = (min(times["other"])
                                      / min(times["this"]))
            summary[label] = row["other_over_this"]
        smoke.log(json.dumps(row))
        del ins, plain
    smoke.log(json.dumps({"card": card.strip(),
                          "other_over_this": summary}))


if __name__ == "__main__":
    main()
