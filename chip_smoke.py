#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; it builds the integrity-hash kernel from
the repository's own sources on first use.  Phases, each of which ends the
run with a non-zero exit code if it fails:

1. Device and build: the card's name and power limit, the kernel's build.
2. Kernel against its plain PyTorch version and the numpy reference, on the
   card, bit for bit, at the main path's shapes (4 MiB chunks, 256 MiB
   buffers), at global word offsets up to the 2**32 wrap, on an unaligned
   pointer and under a random chunking; with the kernel's, the plain
   version's and the host-to-device copy's times beside the kernel's bound.
3. Staging, the main path over real bytes: one ESGF-like dataset of 256 MiB
   files replicated by ``StagingArea`` from STORE to two pods through the
   Figure-4 scheduler and ``LocalFSTransport``, hashed on the card, with one
   corrupted chunk in flight that must be retransmitted, then audited.
4. Campaign: the paper's 2022 campaign (48 datasets, 7.3 PB) reproduces the
   JAX package's numbers.

It prints one ``{"kernels": [...]}`` JSON line and, last, the result line
``{"ok": true, "device": {...}}``.  It imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MiB = 1 << 20
GiB = 1 << 30
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks: HBM3 at 3.35 TB/s; 32-bit integer issue rate
# 132 SMs x 64 INT32 lanes x 1.98 GHz (half the 67 TFLOP/s FP32 lanes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_WORD = 12          # index add + multiply, XOR, mix32 (8), fold XOR

# the paper's mean file is 7.3 PB / 28.9 M files = 271 MiB
FILE_BYTES = 256 * MiB
N_FILES = 8
DATASET = "css03_data/CMIP6/CMIP/NCAR/CESM2/historical/r1i1p1f1/Amon/tas/gn/v20190308"

# the JAX package's run_campaign(CampaignConfig(n_datasets=48, scale=1.0,
# seed=0)); this script cannot import it
CAMPAIGN_WANT = {"duration_days": 106.167, "faults_total": 703,
                 "faults_per_transfer_max": 195, "quarantined": 0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean host-clock time of ``fn`` between two synchronisations."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profiled(torch, fn, iters: int) -> dict:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` and split the
    device time it recorded: the integrity-hash kernel, host-to-device
    copies, everything else; with the wall time of the window (profiler
    overhead included).  Times in ms, totals over the window."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"wall_ms": wall * 1e3, "kernel_ms": 0.0, "kernel_count": 0,
           "h2d_ms": 0.0, "h2d_count": 0}
    for avg in prof.key_averages():
        us = avg.self_device_time_total
        if "fold_words_kernel" in avg.key:
            out["kernel_ms"] += us / 1e3
            out["kernel_count"] += avg.count
        elif avg.key.startswith("Memcpy HtoD"):
            out["h2d_ms"] += us / 1e3
            out["h2d_count"] += avg.count
    return out


def bound(n_words: int):
    """Least time (ms) the card could fold ``n_words`` words in: the larger
    of the bytes moved (each word read once, the accumulator written once)
    over the memory rate and the integer operations over the issue rate."""
    bytes_ms = (4 * n_words + 4) / PEAK_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_WORD * n_words / PEAK_INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# ------------------------------------------------------------------ phases
def phase_device_and_build(torch, kernel) -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"[{torch.cuda.get_device_name(0)}]")
    t0 = time.perf_counter()
    lib = kernel.build()
    kernel.load()
    log(f"[1] kernel library {lib.relative_to(ROOT)} ready in "
        f"{time.perf_counter() - t0:.3f} s")
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")
    return card


def phase_kernel(torch, np, kernel, ref, ops, integrity, card: str) -> dict:
    """Kernel == plain PyTorch version (on the card) == numpy reference."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    max_err = 0
    n_cases = 0

    def fold_all(words, start, w_np):
        nonlocal max_err, n_cases
        acc = ops.new_accumulator(dev)
        got = ops.accumulator_value(kernel.fold_words_cuda(words, start, acc))
        plain = int(ref.fold_words_torch(words, start))
        want = ref.fold_words_np(w_np, start)
        max_err = max(max_err, abs(got - plain), abs(got - want))
        n_cases += 1
        check(got == plain == want,
              f"fold mismatch: {words.numel()} words at start {start}: "
              f"kernel {got:#010x} plain {plain:#010x} numpy {want:#010x}")
        return got

    # the byte sizes of the JAX package's kernel tests, whole checksums
    for size in [0, 1, 3, 4, 7, 100, 4096, 65536, 131072 * 4 + 5, 1_000_003,
                 5, 1021, 65537, 131072 * 4 - 1]:
        data = np.random.default_rng(size).bytes(size)
        w_np = ref.bytes_to_words(data)
        words = torch.from_numpy(w_np.view(np.int32)).to(dev)
        h = ref.finalize32_np(fold_all(words, 0, w_np), size)
        check(h == ref.checksum_bytes_np(data) == ops.checksum_bytes(data, DEVICE),
              f"checksum mismatch at {size} bytes")

    # the main path's 4 MiB chunk and a 256 MiB buffer (beyond the 50 MB
    # L2), at offsets up to the 2**32 wrap; an unaligned (scalar) pointer
    bufs = {}
    for label, nbytes in (("4MiB", 4 * MiB), ("256MiB", 256 * MiB)):
        data = rng.bytes(nbytes)
        w_np = np.frombuffer(data, dtype="<u4")
        words = ops.words_tensor(data, nbytes // 4, dev)
        for start in (0, 12345, 2 ** 32 - 3):
            fold_all(words, start, w_np)
        bufs[label] = (data, words)
    data, words = bufs["4MiB"]
    w_np = np.frombuffer(data, dtype="<u4")
    check(words[1:].data_ptr() % 16 != 0, "expected an unaligned view")
    fold_all(words[1:], 12345, w_np[1:])
    fold_all(words[3:-2], 2 ** 32 - 3, w_np[3:-2])

    # a random chunking of one buffer through the streaming hasher
    data = rng.bytes(64 * MiB + 3)
    s = integrity.StreamingChecksum(DEVICE)
    i = 0
    n_chunks = 0
    while i < len(data):
        n = int(rng.integers(1, 8 * MiB))
        s.update(data[i:i + n])
        i += n
        n_chunks += 1
    check(s.digest() == ref.checksum_bytes_np(data),
          "streaming digest mismatch under random chunking")
    torch.cuda.synchronize()
    log(f"[2] kernel == plain PyTorch == numpy on {n_cases} folds and a "
        f"{n_chunks}-chunk stream (max_abs_err {max_err})")

    # times: kernel over rotating 4 MiB chunks that together exceed L2 (the
    # cold chunk the main path hands it), and over the 256 MiB buffer
    chunks = [ops.words_tensor(rng.bytes(4 * MiB), MiB, dev)
              for _ in range(32)]
    acc = ops.new_accumulator(dev)
    turn = [0]

    def kernel_4mib():
        turn[0] = (turn[0] + 1) % len(chunks)
        kernel.fold_words_cuda(chunks[turn[0]], 0, acc)

    big_data, big = bufs["256MiB"]
    chunk_data = bufs["4MiB"][0]
    timings = {}
    for label, n_words, kfn, pfn, h2d, it in (
            ("4MiB", MiB, kernel_4mib,
             lambda: ref.fold_words_torch(chunks[0], 0),
             lambda: ops.words_tensor(chunk_data, MiB, dev), 200),
            ("256MiB", 64 * MiB,
             lambda: kernel.fold_words_cuda(big, 0, acc),
             lambda: ref.fold_words_torch(big, 0),
             lambda: ops.words_tensor(big_data, 64 * MiB, dev), 20)):
        b_ms, b_by = bound(n_words)
        # the kernel's own device time, from the profiler's CUDA activity;
        # CUDA events over back-to-back calls also count the wrapper's host
        # overhead wherever the host launches slower than the card runs
        prof = profiled(torch, kfn, it)
        events_ms = cuda_ms(torch, kfn, it)
        if prof["kernel_count"] == it:
            k_ms, source = prof["kernel_ms"] / it, "torch.profiler"
        else:                       # the profiler saw no device activity
            k_ms, source = events_ms, "cuda_events"
        timings[label] = {
            "ms": k_ms, "ms_source": source,
            "events_ms_per_call": events_ms,
            "plain_ms": cuda_ms(torch, pfn, max(2, it // 10)),
            "bound_ms": b_ms, "bound_by": b_by,
            "h2d_ms": host_ms(torch, h2d, max(3, it // 4)),
            "kernel_GBps": 4 * n_words / k_ms / 1e6,
            "roofline_share": b_ms / k_ms}
        log(f"    {label}: " + json.dumps(timings[label]))
    main = timings["4MiB"]
    return {"name": "fold_words", "route": "cuda",
            "source": "src/repro_torch/kernels/checksum/csrc/checksum.cu",
            "replaces": "src/repro/kernels/checksum/checksum.py:36",
            "launches": None, "max_abs_err": max_err, "exact": max_err == 0,
            "ms": main["ms"], "ms_source": main["ms_source"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "h2d_ms": main["h2d_ms"],
            "shape": "4 MiB chunk (1048576 words)",
            "at_256MiB": timings["256MiB"], "card": card}


def phase_staging(torch, np, kernel, ref, integrity, StagingArea,
                  chunk_bytes: int) -> dict:
    """The main path: StagingArea -> Figure-4 scheduler -> LocalFSTransport,
    every chunk hashed by the kernel on the card."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_smoke_") as tmp:
        free = shutil.disk_usage(tmp).free
        # STORE plus two pods hold a copy each; keep 2 GiB spare.  Only the
        # file count shrinks on a small disk, never the file size.
        n_files = int(min(N_FILES, (free - 2 * GiB) // (3 * FILE_BYTES)))
        check(n_files >= 2, f"only {free / GiB:.1f} GiB free under {tmp}")
        store_ds = os.path.join(tmp, "STORE", DATASET)
        os.makedirs(store_ds)
        rng = np.random.default_rng(SEED + 1)
        want = {}
        for i in range(n_files):
            name = f"tas_Amon_CESM2_historical_r1i1p1f1_gn_{i:02d}.nc"
            data = rng.bytes(FILE_BYTES)
            with open(os.path.join(store_ds, name), "wb") as f:
                f.write(data)
            want[name] = (FILE_BYTES, ref.checksum_bytes_np(data))
            del data
        victim = os.path.join(store_ds, sorted(want)[n_files // 2])
        hits = {"chunks": 0, "flipped": 0}

        def corruptor(path, chunk):
            # one flipped byte in the 17th chunk of one file's first copy
            # from STORE (to POD0); its retransmit arrives clean
            if path != victim or hits["flipped"]:
                return chunk
            hits["chunks"] += 1
            if hits["chunks"] < 17:
                return chunk
            hits["flipped"] = 1
            b = bytearray(chunk)
            b[12345] ^= 0x20
            return bytes(b)

        area = StagingArea(tmp, device=DEVICE)
        area.transport.corruptor = corruptor
        area.register(DATASET)
        ds = area.catalog[DATASET]

        kernel.launches = 0                       # main path starts here
        t0 = time.perf_counter()
        steps = area.run_until_staged()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        staged_launches = kernel.launches
        t1 = time.perf_counter()
        audits = {pod: area.transport.audit(ds, "STORE", pod)
                  for pod in area.pods}
        torch.cuda.synchronize()
        audit_wall = time.perf_counter() - t1
        launches = kernel.launches                # main path ends here
        # this script's own check of the device digests against numpy
        store = integrity.Manifest.scan(store_ds, DEVICE)

        # where one file's hash spends its time: reading it from the page
        # cache alone, then hashing it on the card under the profiler
        sample = os.path.join(store_ds, sorted(want)[0])

        def read_only():
            with open(sample, "rb") as f:
                while f.read(chunk_bytes):
                    pass
        read_ms = host_ms(torch, read_only, 3, warmup=1)
        prof = profiled(torch, lambda: integrity.stream_file_checksum(
            sample, DEVICE), 3)
        one_file = {k: v / 3 for k, v in prof.items()}
        one_file["read_only_ms"] = read_ms
        one_file["device_busy_share"] = (
            (prof["kernel_ms"] + prof["h2d_ms"]) / prof["wall_ms"]
            if prof["kernel_count"] else None)
        log(f"[3] one {FILE_BYTES >> 20} MiB file hashed, per file: "
            + json.dumps(one_file))

        rows = {pod: area.table.get(DATASET, pod) for pod in area.pods}
        for pod, rec in rows.items():
            check(rec.status.value == "SUCCEEDED", f"{pod}: {rec.status}")
            check(rec.files == n_files and
                  rec.bytes_transferred == n_files * FILE_BYTES,
                  f"{pod}: {rec.files} files, {rec.bytes_transferred} bytes")
        check(hits["flipped"] == 1, "the corruptor never fired")
        check(rows["POD0"].faults == 1 and rows["POD1"].faults == 0,
              f"faults POD0={rows['POD0'].faults} POD1={rows['POD1'].faults}"
              " (want 1 and 0)")
        for pod, report in audits.items():
            check(len(report) == n_files and all(r["ok"]
                                                 for r in report.values()),
                  f"audit of {pod} not clean: {report}")
        check(store.entries == want,
              "device digests differ from the numpy reference")
        check(area.staged_ok(DATASET), "staged_ok is false")

        per_pass = FILE_BYTES // chunk_bytes
        # POD0: n+1 copies (one retransmit), each hashed at source and
        # destination; POD1: n relayed copies, hashed at both ends
        chunks_staged = per_pass * (4 * n_files + 2)
        chunks_audit = per_pass * 4 * n_files   # 2 audits x 2 sides
        check(staged_launches == chunks_staged,
              f"{staged_launches} kernel launches for {chunks_staged} "
              "chunks staged")
        check(launches - staged_launches == chunks_audit,
              f"{launches - staged_launches} launches for {chunks_audit} "
              "chunks audited")
        moved = 2 * n_files * FILE_BYTES
        hashed = chunk_bytes * (chunks_staged + chunks_audit)
        out = {"files": n_files, "file_bytes": FILE_BYTES,
               "bytes_landed": moved, "steps": steps,
               "faults": {p: r.faults for p, r in rows.items()},
               "relay_source_POD1": rows["POD1"].source,
               "stage_wall_s": wall, "landed_GBps": moved / wall / 1e9,
               "audit_wall_s": audit_wall,
               "hashed_bytes": hashed,
               "hash_GBps_end_to_end": hashed / (wall + audit_wall) / 1e9,
               "launches": launches, "launches_staging": staged_launches,
               "chunks_hashed": chunks_staged + chunks_audit,
               "one_file_hash": one_file}
        log("[3] staging: " + json.dumps(out))
        return out


def phase_campaign(campaign) -> dict:
    t0 = time.perf_counter()
    r = campaign.run_campaign(campaign.CampaignConfig(
        n_datasets=48, scale=1.0, seed=0))
    got = {"duration_days": round(r.duration_days, 3),
           "faults_total": r.faults_total,
           "faults_per_transfer_max": r.faults_per_transfer_max,
           "quarantined": r.quarantined}
    check(got == CAMPAIGN_WANT, f"campaign {got} != {CAMPAIGN_WANT}")
    out = dict(got, total_PB=r.total_bytes / 1024 ** 5,
               timeline_points=len(r.timeline),
               wall_s=time.perf_counter() - t0)
    log("[4] campaign: " + json.dumps(out))
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "GPU")
    import numpy as np

    from repro_torch.core import campaign, integrity
    from repro_torch.core.transport import _CHUNK_BYTES
    from repro_torch.data.staging import StagingArea
    from repro_torch.kernels.checksum import checksum as kernel
    from repro_torch.kernels.checksum import ops, ref

    t0 = time.perf_counter()
    card = phase_device_and_build(torch, kernel)
    entry = phase_kernel(torch, np, kernel, ref, ops, integrity, card)
    staging = phase_staging(torch, np, kernel, ref, integrity, StagingArea,
                            _CHUNK_BYTES)
    entry["launches"] = staging["launches"]
    check(entry["launches"] > 0, "the main path never launched the kernel")
    phase_campaign(campaign)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    check(not leaked, f"JAX-side modules were imported: {leaked}")
    log(f"total wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
