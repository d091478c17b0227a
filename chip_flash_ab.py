#!/usr/bin/env python3
"""Time this tree's flash-attention kernel against another tree's, on one card.

Run from the repository root:

    python3 chip_flash_ab.py --other DIR [--rounds 2]

DIR is the root of another checkout of this repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Each tree's ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
is built into its own library (``kernels.nvcc.CudaLibrary``) and called
through ``repro_flash_attention_fwd``, whose C signature both share.  At
every case of ``chip_smoke.FLASH_CASES`` both kernels are held to the plain
PyTorch version and timed by ``chip_smoke.device_ms_per_call`` (the
profiler's device time per call), in turns: other, this, this, other, for
``--rounds`` rounds.  Prints the card and one JSON line per case, then a
summary line.  It needs a CUDA card and ``nvcc``, and imports neither JAX
nor the JAX package.
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

SOURCE = (Path("src/repro_torch/kernels/flash_attention/csrc")
          / "flash_attention.cu")


def bind(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.repro_flash_attention_fwd.restype = ctypes.c_int


def launcher(torch, lib):
    """The forward pass through ``lib``'s C interface, on the current
    stream; a new (B, T, H, hd) output."""
    def run(q, k, v, window):
        B, T, H, hd = q.shape
        out = torch.empty_like(q)
        strides = [s for x in (q, k, v) for s in x.stride()[:3]]
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, B, T, H, k.shape[2], hd,
            *strides, window or 0, hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
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
    from repro_torch.kernels.flash_attention.ref import attention_torch
    from repro_torch.kernels.nvcc import CudaLibrary

    libs = {}
    for label, root in (("other", args.other.resolve()), ("this", ROOT)):
        source = root / SOURCE
        smoke.check(source.is_file(), f"no {source}")
        lib = CudaLibrary(source, f"flash_attention_ab_{label}", bind)
        libs[label] = launcher(torch, lib.load())
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln]
        smoke.log(f"{label}: {source} built; ptxas: {regs}")
    card = smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    smoke.log(card.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    summary = {}
    for label, B, T, H, Hkv, hd, window, dname in smoke.FLASH_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, T, Hkv, hd, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        plain = attention_torch(q, k, v, window).float()
        tol = smoke.ATTN_TOL[dname]
        it = 20 if T >= 4096 else 50
        times = {"other": [], "this": []}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                run = libs[who]
                got = run(q, k, v, window).float()
                smoke.check(torch.allclose(got, plain, atol=tol, rtol=tol),
                            f"{who} differs from the plain version at "
                            f"{label}")
                ms, _ = smoke.device_ms_per_call(
                    torch, lambda: run(q, k, v, window), it)  # noqa: B023
                times[who].append(ms)
        row = {"case": label, "shape": [B, T, H, Hkv, hd], "window": window,
               "dtype": dname, "other_ms": times["other"],
               "this_ms": times["this"]}
        if all(times[w] and None not in times[w] for w in times):
            row["this_over_other"] = (min(times["this"])
                                      / min(times["other"]))
            summary[label] = row["this_over_other"]
        smoke.log(json.dumps(row))
    smoke.log(json.dumps({"card": card.strip(),
                          "this_over_other": summary}))


if __name__ == "__main__":
    main()
