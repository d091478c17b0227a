#!/usr/bin/env python3
"""Time this tree's integrity-hash kernel against another tree's, on one card.

Run from the repository root:

    python3 chip_checksum_ab.py --other DIR [--rounds 2] [--floor]

DIR is the root of another checkout of this repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Each tree's ``src/repro_torch/kernels/checksum/csrc/checksum.cu`` is built
into its own library (``kernels.nvcc.CudaLibrary``) and called through
``repro_fold_words``, whose C signature both share (each library picks its
own plan).  Both kernels are held to the plain PyTorch version and the
numpy reference, bit for bit, and timed in turns (other, this, this, other,
for ``--rounds`` rounds) at three cases: a cold 4 MiB chunk (32 rotating
chunks, together beyond the 50 MB L2), a 4 MiB chunk just copied to the
card from the host (``warm_after_copy``, what the main path hands the
kernel; the kernel's time alone, without the copy's) and a 256 MiB buffer.
Device times are the profiler's per call (``chip_smoke.device_ms_by_name``);
each case's ratio other / this is given of the fastest turns and of the
medians.
Beside them, the host time of one call of the C entry on an L2-resident
chunk (``chip_smoke.host_ms``), which is the launch path each library takes.

``--floor`` also builds ``csrc/floor.cu`` and times its probes on the
cold 4 MiB chunks: an empty kernel and a load-only kernel (every word read
once and XORed raw, one word stored a block) on the grid this tree's hash
launches (``checksum.plan``), and the load-only kernel on the grid of the
kernel's first version; with each kernel's time over the floor of its
grid.

Prints the card and one JSON line per case and probe, then a summary line.
It needs a CUDA card and ``nvcc``, and imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = Path("src/repro_torch/kernels/checksum/csrc/checksum.cu")
FLOOR_SOURCE = Path("src/repro_torch/kernels/checksum/csrc/floor.cu")
MiB = 1 << 20


def bind(lib: ctypes.CDLL) -> None:
    lib.repro_fold_words.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.repro_fold_words.restype = ctypes.c_int


def bind_floor(lib: ctypes.CDLL) -> None:
    lib.repro_floor.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_floor.restype = ctypes.c_int


def launcher(torch, lib):
    """The fold through ``lib``'s C interface, on the current stream: XOR
    the fold of ``words`` at ``start`` into ``acc``."""
    def run(words, start, acc):
        err = lib.repro_fold_words(words.data_ptr(), words.numel(),
                                   start & 0xFFFFFFFF, acc.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return acc
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--floor", action="store_true",
                    help="also time the floor probes of csrc/floor.cu")
    args = ap.parse_args()

    import torch
    import chip_smoke as smoke
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this script needs a "
                   "CUDA GPU")
    import numpy as np
    from repro_torch.kernels.checksum import ops, ref
    from repro_torch.kernels.nvcc import CudaLibrary

    libs = {}
    for label, root in (("other", args.other.resolve()), ("this", ROOT)):
        source = root / SOURCE
        smoke.check(source.is_file(), f"no {source}")
        lib = CudaLibrary(source, f"checksum_ab_{label}", bind)
        libs[label] = launcher(torch, lib.load())
        smoke.log(f"{label}: {source} built; ptxas: "
                  f"{smoke.ptxas_kernels(lib.build_log)}")
    card = smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    smoke.log(card.strip())

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED + 7)
    chunk_data = [rng.bytes(4 * MiB) for _ in range(32)]
    chunks = [ops.words_tensor(d, MiB, dev) for d in chunk_data]
    big_data = rng.bytes(256 * MiB)
    big = ops.words_tensor(big_data, 64 * MiB, dev)
    acc = ops.new_accumulator(dev)

    # both kernels bit-equal to the plain version and numpy, aligned and not
    for words, w_np in ((chunks[0], np.frombuffer(chunk_data[0], "<u4")),
                        (big, np.frombuffer(big_data, "<u4"))):
        for view in (slice(None), slice(1, None), slice(3, -2)):
            for start in (0, 12345, 2 ** 32 - 3):
                plain = int(ref.fold_words_torch(words[view], start))
                want = ref.fold_words_np(w_np[view], start)
                for who, run in libs.items():
                    got = ops.accumulator_value(
                        run(words[view], start, ops.new_accumulator(dev)))
                    smoke.check(got == plain == want,
                                f"{who}: fold mismatch at {words.numel()} "
                                f"words, view {view}, start {start}")
    smoke.log("both kernels == plain PyTorch == numpy (aligned and "
              "unaligned views, starts 0, 12345, 2**32 - 3)")

    turn = [0]

    def cold(run):
        def fn():
            turn[0] = (turn[0] + 1) % len(chunks)
            run(chunks[turn[0]], 0, acc)
        return fn

    cases = [
        ("4MiB_cold", MiB, cold, 200),
        ("warm_after_copy", MiB, lambda run: lambda: run(
            ops.words_tensor(chunk_data[0], MiB, dev), 0, acc), 100),
        ("256MiB", 64 * MiB, lambda run: lambda: run(big, 0, acc), 20)]
    summary = {}
    for label, n_words, make, it in cases:
        times = {"other": [], "this": []}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                times[who].append(smoke.kernel_ms_per_call(
                    torch, make(libs[who]), it))
        if label == "4MiB_cold":
            cold_times = times
        b_ms, b_by = smoke.bound(n_words)
        row = {"case": label, "words": n_words, "other_ms": times["other"],
               "this_ms": times["this"], "bound_ms": b_ms, "bound_by": b_by}
        if all(times[w] and None not in times[w] for w in times):
            row["other_over_this"] = (min(times["other"])
                                      / min(times["this"]))
            row["median_other_over_this"] = (statistics.median(
                times["other"]) / statistics.median(times["this"]))
            summary[label] = {"min": row["other_over_this"],
                              "median": row["median_other_over_this"]}
            if label != "warm_after_copy":   # L2 may serve a warm chunk
                row["roofline_share"] = {w: b_ms / min(times[w])
                                         for w in times}
        smoke.log(json.dumps(row))

    # the C entry's host time a call, on one chunk that stays in L2
    host = {"other": [], "this": []}
    for _ in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            host[who].append(smoke.host_ms(
                torch, lambda: libs[who](chunks[0], 0, acc),  # noqa: B023
                2000, warmup=20))
    smoke.log(json.dumps({"case": "host_ms_per_call_L2_resident",
                          "other_ms": host["other"],
                          "this_ms": host["this"]}))

    floor = {}
    if args.floor:
        from repro_torch.kernels.checksum import checksum as kernel
        lib = CudaLibrary(ROOT / FLOOR_SOURCE, "checksum_floor", bind_floor)
        flib = lib.load()
        smoke.log(f"floor probes built; ptxas: "
                  f"{smoke.ptxas_kernels(lib.build_log)}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = kernel.plan(MiB, 0, sms)
        # the first version's grid: 256 threads, 1024 words a block
        first = (256, min(-(-MiB // 1024), sms * 8))
        out = torch.zeros(first[1] + plan.blocks, dtype=torch.int32,
                          device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        b_ms, _ = smoke.bound(MiB)
        raw = int(np.bitwise_xor.reduce(np.frombuffer(chunk_data[0], "<u4")))
        for name, kind, (threads, blocks) in (
                ("empty_plan_grid", 0, (plan.threads, plan.blocks)),
                ("load_plan_grid", 1, (plan.threads, plan.blocks)),
                ("load_first_grid", 1, first)):
            def probe(words=None):
                turn[0] = (turn[0] + 1) % len(chunks)
                words = chunks[turn[0]] if words is None else words
                err = flib.repro_floor(kind, threads, blocks,  # noqa: B023
                                       words.data_ptr(), MiB, out.data_ptr(),
                                       stream)
                smoke.check(err == 0, f"floor probe {name} failed: {err}")  # noqa: B023
            if kind:   # every word read once: the blocks' XOR is the words'
                out.zero_()
                probe(chunks[0])
                got = int(np.bitwise_xor.reduce(
                    out[:blocks].cpu().numpy().view(np.uint32)))
                smoke.check(got == raw, f"floor probe {name} missed words")
            times = [smoke.kernel_ms_per_call(torch, probe, 200)
                     for _ in range(2)]
            floor[name] = min(t for t in times if t is not None)
            smoke.log(json.dumps({"probe": name, "threads": threads,
                                  "blocks": blocks, "ms": times,
                                  "bound_ms": b_ms,
                                  "share_of_bound": b_ms / floor[name]}))
        cold_ms = {w: min(t for t in cold_times[w] if t is not None)
                   for w in cold_times}
        floor["this_over_load_plan_grid"] = (cold_ms["this"]
                                             / floor["load_plan_grid"])
        floor["other_over_load_first_grid"] = (cold_ms["other"]
                                               / floor["load_first_grid"])
    smoke.log(json.dumps({"card": card.strip(), "other_over_this": summary,
                          "floor_ms": floor}))


if __name__ == "__main__":
    main()
