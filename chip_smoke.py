#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; it builds the port's kernel libraries
(the integrity hash, the lane segment step, flash attention, the selective
scan and Mamba1's fused decode step) from the repository's own sources, all
at once, one ``nvcc`` each, on first use.  Phases, each of which ends the run with a non-zero exit code if
it fails, and each of which prints its wall time:

1. Device and build: the card's name and power limit, the kernels' builds
   with their registers and spills.
2. Kernel against its plain PyTorch version and the numpy reference, on the
   card, bit for bit, at the main path's shapes (4 MiB chunks, 256 MiB
   buffers), at global word offsets up to the 2**32 wrap, on unaligned
   pointers, at sizes that straddle the kernel's tiles and its wave, and
   under random chunkings; every plan the library makes equal to
   ``checksum.plan``'s; the device time per call cold at 4 MiB and 256 MiB
   with the plan, registers and shared memory, and the kernel's, the
   plain version's and the host-to-device copy's times beside the kernel's
   bound, with the time on a chunk just copied to the card.
3. Staging, the main path over real bytes: one ESGF-like dataset of 256 MiB
   files replicated by ``StagingArea`` from STORE to two pods through the
   Figure-4 scheduler and ``LocalFSTransport``, hashed on the card, with one
   corrupted chunk in flight that must be retransmitted, then audited.
4. Campaign: the paper's 2022 campaign (48 datasets, 7.3 PB) reproduces the
   JAX package's numbers.
5. Lane segment step: the kernel against its plain PyTorch version on the
   card and the numpy reference, bit for bit with NaN in the same places, at
   the ensemble path's [256 lanes, 256 rows] and the full catalog's
   [256, 4582], with edge rows and a ragged shape; with the kernel's, the
   plain version's and the copies' times beside the kernel's bound.
6. Ensemble, the second main path: ``ensemble-paper-bands`` (256 lanes, 128
   datasets, scale 0.01) through ``run_ensemble`` on the numpy backend and
   on the default torch backend on the card; every lane's gate fields and
   the bands must be equal, lane 0 must pass ``check_lane0`` on the card,
   and the kernel must launch once per segment step; with each backend's
   wall time, the per-tick split and the device's busy share.
7. Flash attention: the kernel against its plain PyTorch version on the
   card (2.5e-2 in bf16, 2e-5 in f32, ``tests/test_kernels.py``'s
   tolerances) at smollm-135m's serve shape, a ragged T, a window at
   hd 128, hd 32, qwen3-14b's serve shape, f32 (the CUDA-core kernel), one
   train_4k sequence at qwen3-14b's heads, qwen3-moe-30b-a3b's serve shape
   [4, 256, 32/4, 128] (a GQA group of 8), gemma3-27b's local (window 1024)
   and global prefill of 2048-token prompts [4, 2048, 32/16, 128],
   qwen2-vl-7b's serve shape [4, 256, 28/4, 128] (a GQA group of 7) and
   zamba2-1.2b's and musicgen-large's [4, 256, 32/32, 64], phase 17's
   example shapes (the smoke serve's waves [4, 32|16, 4/1, 32], shorter
   than one tile, and the quickstart's [8, 128, 9/3, 64]), and over strided
   KV-cache views; each bf16 case on the tensor-core kernel, with the block
   it launched.  The kernel's time and ``scaled_dot_product_attention``'s
   (with an explicit boolean mask for a window) are both the profiler's
   device time per call (every kernel the call launches, whose names give
   SDPA's backend), CUDA events over back-to-back calls beside them; with
   the plain version's time and the kernel's bound.
8. Selective scan: the kernel against its plain PyTorch version on the card
   (rtol/atol 1e-4) at falcon-mamba-7b's serve shape, a ragged shape, one
   4096-token prompt, the serve shape at the model's own range of A and
   dt and phase 17's smoke serve waves [4, 32|16, 256, 8], at every layout (threads a channel), over the split in halves and
   on unaligned views; each case and layout timed as the profiler's device
   time per call beside the bound, with the layout ``layout_for`` picks
   and ptxas's registers and spills.
8b. Mamba1's fused decode step: its conv-step and selective-state kernels
   against their plain PyTorch versions on the card (the conv's outputs bit
   for bit, h and y at ``STEP_TOL``) at falcon-mamba-7b's serve shape [16,
   8192, 16, 256] in bf16 and f32 and phase 17's smoke serve [4, 256, 8, 8],
   also with dt_bias, A_log and D in bf16; each kernel timed as the
   profiler's device time per call over eight input sets in turn (past the
   L2), beside its bytes bound and the plain versions' time.
9. Serving, the third main path: smollm-135m and falcon-mamba-7b at their
   published configs with all layers, weights from the port's seeded init
   on the card, 8 requests through ``launch.serve`` and ``Engine`` (4
   slots, prompts of 4 to 255 tokens, 16 new tokens); every request must
   return 16 tokens, and flash attention must launch once per layer per
   prefill wave (smollm), all on the tensor-core kernel, and the scan
   likewise (falcon-mamba).  falcon-mamba's decode step is a CUDA graph:
   its first step at a batch size captures it (the seconds are printed)
   and every later one replays, in the served, the profiled and the
   checked runs; every other arch decodes eagerly.  The selective-state
   step kernel launches twice a Mamba1 layer at the capture (its warm-up
   and the capture) and never in a replay.  At full
   width and depth, prefill plus decode must match the forward at
   tests/test_models.py's tolerances with f32 weights (in bf16 the same
   errors are printed, beside the drift between two forwards of another
   length, which already exceeds those tolerances at 64 layers), and a
   2-layer cut
   must give the same prefill logits on the CPU (plain versions) and on the
   card (kernels).  With prefill ms per wave, decode ms per token, tokens/s
   and the card's busy share.
10. Training, the fourth main path.  (10a) The kernels' autograd
   Functions: flash attention at smollm-135m's training batch [8, 1024,
   9/3, 64], at qwen3-14b's heads [1, 2048, 40/8, 128], at qwen3-moe's
   [4, 1024, 32/4, 128] and at gemma3-27b's windowed [2, 2048, 32/16, 128]
   (window 1024) and at phase 17's example batches [8, 128, 9/3, 64] and
   [4, 128, 4/1, 32] in bf16, the scan at falcon-mamba-7b's width [2, 512,
   8192, 16]; each forward held
   to the plain version (phase 7's and 8's tolerances), each gradient to
   the all-eager computation's (``GRAD_REL_TOL`` of the largest).  (10)
   smollm-135m at its published width and depth, seeded bf16 weights,
   AdamW, 8 x 1024 tokens a step, remat, 12 steps with a checkpoint every
   6 and one injected failure at step 9 through ``train.loop.train``;
   checkpoints hashed on the card and replicated from POD0 to POD1 and
   STORE; then POD0's tree is destroyed, ``restore_anywhere`` restores
   from POD1 (verified on the card), the restored state must equal the
   state in memory and serve the same tokens.  Launches asserted with
   ``==``: flash attention once a layer a forward (remat doubles it) of
   every executed step, the hash once a 4 MiB read of every file scanned,
   copied, re-read and verified.  With step ms, tokens/s, the card's busy
   share in one profiled step, the kernel's and the eager backward's
   shares, the top device kernels and the checkpoint walls and GB/s.
   Then falcon-mamba-7b at full width cut to 4 layers (``MAMBA_CUTS``),
   3 steps, the scan launched once a layer a step.
11. The replication CLI (host only, no kernel may launch):
   ``repro_torch.scenarios.run.main`` on paper-2022 at the engine_comparison
   shape must give the JAX package's 474 iterations / 105.613 d / 703
   faults; ``--kill-after 200 --checkpoint-dir`` must exit 3 and
   ``--resume`` end on the same trajectory and digest; ``--obs`` must leave
   the trajectory alone and render through ``repro_torch.obs.report``; a
   two-scenario sweep writes to a temporary ``--out``.  Each run's wall time.
12. MoE serving: qwen3-moe-30b-a3b (48 layers, GQA 32/4 at hd 128, 128
   experts top-8) and deepseek-v2-lite-16b (27 layers, MLA, 64 experts
   top-6 and 2 shared) at their published configs, seeded bf16 weights, with
   phase 9's traffic; flash attention must launch once a layer a prefill
   wave for qwen3-moe, all on the tensor-core kernel, and never for
   deepseek (MLA is eager).  Prefill plus decode against the forward in
   f32 with drop-free capacity at 8 layers (``MOE_CUTS``).  Prefill ms per
   wave, decode ms per token, tokens/s, peak memory, and the card's busy
   share and top kernels over one more wave, profiled.
13. MoE training through ``train.loop.train``, 3 steps of 4 x 1024 tokens
   with remat, each model at full width and cut in depth
   (``MOE_TRAIN_CUTS``): a finite loss and ``aux``; qwen3-moe's flash
   launches ``==`` layers x steps x 2; deepseek-v2-lite's one checkpoint
   (params and AdamW state) hashed by the integrity kernel at its save and
   its restore (launches ``==`` the files' 4 MiB reads), restored equal to
   the state in memory with the router's AdamW state f32 and the lead block
   a list.  Step ms, tokens/s, forward+backward and AdamW ms, peak memory,
   checkpoint GB/s.

14. The last four families served at their published configs through
   phase 9's function: gemma3-27b (prompts of 1030-2000 tokens, its ring
   caches wrapping), zamba2-1.2b, qwen2-vl-7b (also an M-RoPE prefill of
   frontend embeddings) and musicgen-large; B3 launches ``==`` a wave's
   attention calls.
15. The same four trained 3 steps with remat (``FAMILY_TRAIN_CUTS``), B3
   launches ``==``, zamba2-1.2b's checkpoint hashed by B1 at its save and
   restore.
16. The sharded path, on a world-size-1 NCCL group and a 1 x 1 ("data",
   "model") ``DeviceMesh`` on the card: the relay, naive and ring
   collectives return x and ``psum_compressed`` goes through NCCL's
   all-gather to ``dequantize(quantize(x))`` bit for bit; smollm-135m (30
   layers) and falcon-mamba-7b (4 layers) prefill 4 x 256 tokens through
   ``dryrun.build_prefill_step`` with bf16 weights placed by
   ``load_for_mesh`` and ``param_specs``: B3 ``==`` 30 and B4 ``==`` 4
   launches on the local shards, logits bit-equal to the unsharded
   prefill's;
   two ``build_train_step`` steps of smollm-135m at 2 x 1024 tokens with
   ZeRO-1 state, params equal to two unsharded steps', B3 ``==`` 120; an
   elastic restore hashed by B1 (``==`` the files' 4 MiB reads) and placed
   by ``load_for_mesh``, gathered back bit for bit; the dry run of
   smollm-135m train_4k on a fake 8 x 8 mesh in a subprocess (bytes,
   FLOPs, collectives).  The phase must take less than 90 s.
17. The examples, each through its ``main`` on the card:
   ``examples/torch_quickstart.py`` trains smollm-135m at its published
   config, 8 x 128 tokens, 12 steps, a failure at step 11 restarted from
   the step-10 checkpoint (B3 ``==`` 30 layers x 13 executed steps, B1
   ``==`` the checkpoint's 4 MiB reads at its save and restore);
   ``torch_serve_batched.py`` serves 8 requests on smollm-135m's and
   falcon-mamba-7b's smoke configs (B3 / B4 ``==`` layers x waves);
   ``torch_train_with_replication.py`` stages a dataset to two pods,
   trains 60 steps with a checkpoint replicated to POD1 and STORE every
   20, loses POD0 and restores from POD1 (B1 ``==`` every file's 4 MiB
   reads); ``torch_replication_campaign.py`` ends on the reference's line,
   with no launch.  Each example's wall and the phase's.

Each main path (phases 3, 6, 9, 10, 12, 13, 14, 15, 16 and 17) is driven
with every kernel's launch count set to 0 just before it and read just
after.
It prints one ``{"kernels": [...]}`` JSON line, each kernel's ``launches``
from its serving or replication path, ``launches_training`` from phase 10,
the MoE and family paths' launches (``launches_moe_serve``,
``launches_moe_training``, ``launches_family_serve``,
``launches_family_training``) and the sharded path's
(``launches_sharded`` of B3 and B4, ``launches_elastic`` of B1) and the
examples' (``launches_examples``), and, last, the result line ``{"ok": true, "device": {...}}``.  It imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MiB = 1 << 20
GiB = 1 << 30
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks: HBM3 at 3.35 TB/s; 32-bit integer issue rate
# 132 SMs x 64 INT32 lanes x 1.98 GHz (half the 67 TFLOP/s FP32 lanes); fp64
# issue rate 132 SMs x 64 FP64 lanes x 1.98 GHz (33.5 TFLOP/s counting a
# fused multiply-add as two)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
PEAK_FP64_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_WORD = 12          # index add + multiply, XOR, mix32 (8), fold XOR
# the lane step per element: 4 f64 read, 4 f64 + 1 bool written; two
# subtractions, a division, two products and a sum
LANE_STEP_BYTES = 4 * 8 + 4 * 8 + 1
LANE_STEP_OPS = 6

# the paper's mean file is 7.3 PB / 28.9 M files = 271 MiB
FILE_BYTES = 256 * MiB
N_FILES = 8
DATASET = "css03_data/CMIP6/CMIP/NCAR/CESM2/historical/r1i1p1f1/Amon/tas/gn/v20190308"

# the JAX package's run_campaign(CampaignConfig(n_datasets=48, scale=1.0,
# seed=0)); this script cannot import it
CAMPAIGN_WANT = {"duration_days": 106.167, "faults_total": 703,
                 "faults_per_transfer_max": 195, "quarantined": 0}

# the ensemble path: ensemble-paper-bands at all 256 lanes, cut in datasets
# and scale
ENSEMBLE = "ensemble-paper-bands"
ENSEMBLE_DATASETS = 128
ENSEMBLE_SCALE = 0.01
ENSEMBLE_CUTS = ("datasets 2291 -> 128, scale 1.0 -> 0.01: the host lanes "
                 "engine does not finish 16 lanes of the full catalog in "
                 "100 s")
# the lane step's shapes: the ensemble path's [lanes, 2 replicas x 128
# datasets], the full catalog's [lanes, 2 x 2291], and a ragged one
LANE_SHAPES = {"main": (256, 256), "full_catalog": (256, 4582),
               "ragged": (255, 4583)}


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


def profiled(torch, fn, iters: int, kernel_name: str = "fold_words_kernel",
             warmup: bool = True) -> dict:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` and split the
    device time it recorded: the kernel named ``kernel_name``, host-to-device
    and device-to-host copies; with the wall time of the window (profiler
    overhead included).  Times in ms, totals over the window."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
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
           "h2d_ms": 0.0, "h2d_count": 0, "d2h_ms": 0.0, "d2h_count": 0}
    for avg in prof.key_averages():
        us = avg.self_device_time_total
        for part, match in (("kernel", kernel_name in avg.key),
                            ("h2d", avg.key.startswith("Memcpy HtoD")),
                            ("d2h", avg.key.startswith("Memcpy DtoH"))):
            if match:
                out[f"{part}_ms"] += us / 1e3
                out[f"{part}_count"] += avg.count
                break
    return out


def device_ms_by_name(torch, fn, iters: int, tries: int = 3) -> dict:
    """Device time of one call of ``fn`` under ``torch.profiler``, by the
    name of each kernel, memset or copy it recorded: ``{name: (mean ms over
    the launches recorded, launches recorded)}`` (it may drop a few).  A
    window in which it recorded nothing is profiled again, up to ``tries``
    times; then the dict is empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    by = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, n = by.get(e.name, (0.0, 0))
                by[e.name] = (us + e.self_device_time_total, n + 1)
        if by:
            break
    return {name: (us / n / 1e3, n) for name, (us, n) in by.items()}


def device_ms_per_call(torch, fn, iters: int, tries: int = 3):
    """Device time of one call of ``fn`` under ``torch.profiler``: the
    per-name means of ``device_ms_by_name`` summed, since every call
    launches each of them once; with the launches recorded by name.  The
    time is None where nothing was recorded."""
    by = device_ms_by_name(torch, fn, iters, tries)
    ms = sum(ms for ms, _ in by.values()) if by else None
    return ms, {name: n for name, (_, n) in by.items()}


def kernel_ms_per_call(torch, fn, iters: int):
    """Device time of one call of ``fn`` in kernels alone, leaving out the
    copies and memsets it makes (a chunk copied to the card before it is
    folded); None where the profiler recorded no kernel."""
    by = device_ms_by_name(torch, fn, iters)
    kernels = [ms for name, (ms, _) in by.items()
               if not name.startswith(("Memcpy", "Memset"))]
    return sum(kernels) if kernels else None


def kernel_label(line: str) -> str:
    """``name<template args>`` of the kernel in a ptxas "Compiling entry
    function '<mangled>'" line (the Itanium mangling's length-prefixed
    name ending in ``kernel``), else the line."""
    mangled = line.split("'")[1] if "'" in line else line
    # a length prefix ends where its name begins, but may start inside a
    # longer run of digits (a hash before it)
    for j in range(1, len(mangled)):
        if not (mangled[j - 1].isdigit() and not mangled[j].isdigit()):
            continue
        i = j - 1
        while i >= 0 and mangled[i].isdigit():
            name = mangled[j:j + int(mangled[i:j])]
            if name.endswith("kernel"):
                rest = mangled[j + len(name):]
                args = []
                if rest.startswith("I"):
                    k = 1
                    while rest.startswith("Li", k):
                        end = rest.index("E", k)
                        args.append(rest[k + 2:end])
                        k = end + 1
                return name + (f"<{', '.join(args)}>" if args else "")
            i -= 1
    return line.strip()


def roofline(n_bytes: float, n_ops: float, ops_per_s: float):
    """Least time (ms) the card could take, and what sets it: the larger of
    the bytes over the memory rate and the operations over their rate."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def kernel_time(prof: dict, events_ms: float):
    """A kernel's own device time per launch, and its source: the
    profiler's mean over the launches it recorded (it may drop a few), or,
    where it recorded none, CUDA events over back-to-back calls, which also
    count the wrapper's host time wherever the host launches slower than
    the card runs."""
    if prof["kernel_count"]:
        return prof["kernel_ms"] / prof["kernel_count"], "torch.profiler"
    return events_ms, "cuda_events"


def bound(n_words: int):
    """Least time (ms) the card could fold ``n_words`` words in: each word
    read once and the accumulator written once; 12 integer operations a
    word."""
    return roofline(4 * n_words + 4, OPS_PER_WORD * n_words,
                    PEAK_INT32_OPS_PER_S)


def lane_step_bound(n: int):
    """Least time (ms) for the lane step over ``n`` elements: 65 bytes and
    6 fp64 operations each."""
    return roofline(LANE_STEP_BYTES * n, LANE_STEP_OPS * n,
                    PEAK_FP64_OPS_PER_S)


# ------------------------------------------------------------------ phases
def phase_device_and_build(torch, kernels) -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"[{torch.cuda.get_device_name(0)}]")
    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        libs = list(pool.map(lambda k: k.LIBRARY.build(), kernels))
    for kernel, lib in zip(kernels, libs):
        kernel.LIBRARY.load()
        log(f"[1] kernel library {lib.relative_to(ROOT)} ready")
        for line in kernel.LIBRARY.build_log.splitlines():
            if "Compiling entry function" in line:
                log(f"    ptxas: {kernel_label(line)}")
            elif "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    log(f"[1] {len(kernels)} kernel libraries built in "
        f"{time.perf_counter() - t0:.3f} s")
    return card


def checksum_plan_row(kernel, ptx: dict, words, sms: int) -> dict:
    """The plan ``checksum.plan`` makes for a fold of ``words``, whether
    the library's own plan equals it, and ptxas's registers, spills and
    shared memory for the kernel it launches."""
    n, mod = words.numel(), words.data_ptr() % 16
    plan = kernel.plan(n, mod, sms)
    label = f"fold_words_kernel<{plan.loads}>"
    return {"plan": plan.__dict__,
            "plan_equal": plan == kernel.library_plan(n, mod, sms),
            "kernel": label, **ptx.get(label, {})}


def phase_kernel(torch, np, kernel, ref, ops, integrity, card: str) -> dict:
    """Kernel == plain PyTorch version (on the card) == numpy reference;
    timed cold at 4 MiB and 256 MiB beside the bound, with its plan (held
    to the Python mirror) and ptxas's registers, spills and shared
    memory."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptx = ptxas_kernels(kernel.LIBRARY.build_log)
    max_err = 0
    n_cases = 0

    def fold_all(words, start, w_np):
        nonlocal max_err, n_cases
        plain = int(ref.fold_words_torch(words, start))
        want = ref.fold_words_np(w_np, start)
        if words.numel():   # no words: no plan and no launch
            row = checksum_plan_row(kernel, ptx, words, sms)
            check(row["plan_equal"],
                  f"plan of {words.numel()} words at {words.data_ptr() % 16} "
                  f"mod 16: the library's differs from checksum.plan's "
                  f"{row['plan']}")
        acc = ops.new_accumulator(dev)
        got = ops.accumulator_value(kernel.fold_words_cuda(words, start, acc))
        max_err = max(max_err, abs(got - plain), abs(got - want))
        n_cases += 1
        check(got == plain == want,
              f"fold mismatch: {words.numel()} words at start {start}: "
              f"kernel {got:#010x} plain {plain:#010x} numpy {want:#010x}")
        return want

    # the byte sizes of the JAX package's kernel tests, whole checksums
    for size in [0, 1, 3, 4, 7, 100, 4096, 65536, 131072 * 4 + 5, 1_000_003,
                 5, 1021, 65537, 131072 * 4 - 1]:
        data = np.random.default_rng(size).bytes(size)
        w_np = ref.bytes_to_words(data)
        words = torch.from_numpy(w_np.view(np.int32)).to(dev)
        h = ref.finalize32_np(fold_all(words, 0, w_np), size)
        check(h == ref.checksum_bytes_np(data) == ops.checksum_bytes(data, DEVICE),
              f"checksum mismatch at {size} bytes")

    # sizes that straddle one block's tile (exactly one, and one plus 1, 2
    # and 3 words), one wave of the card (where a thread's loads go from
    # one to four) and one tile of four loads beyond it, and a call of
    # fewer words than one block has threads; at every word offset mod 16
    # and up to the 2**32 wrap
    tile = 4 * kernel.THREADS
    wave = 4 * sms * kernel.THREADS_PER_SM
    for n in (tile, tile + 1, tile + 2, tile + 3, wave, wave + 4,
              wave + tile * kernel.LOADS_BIG + 1, 300):
        w_np = rng.integers(0, 2 ** 32, n + 3, dtype=np.uint32)
        buf = torch.from_numpy(w_np.view(np.int32)).to(dev)
        for off in range(4):
            for start in (0, 2 ** 32 - 3):
                fold_all(buf[off:off + n], start, w_np[off:off + n])

    # the main path's 4 MiB chunk and a 256 MiB buffer (beyond the 50 MB
    # L2), at offsets up to the 2**32 wrap; unaligned views
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

    # a random chunking of one buffer through the streaming hasher, and the
    # same words cut at random straight through the wrapper
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
    w_np = ref.bytes_to_words(data)
    words = torch.from_numpy(w_np.view(np.int32)).to(dev)
    want = ref.fold_words_np(w_np, 0)
    cuts = np.unique(np.concatenate([[0, w_np.size], rng.integers(
        1, w_np.size, 40)]))
    acc = ops.new_accumulator(dev)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        kernel.fold_words_cuda(words[lo:hi], int(lo), acc)
    check(ops.accumulator_value(acc) == want,
          "random chunking of the wrapper's calls differs from numpy")
    torch.cuda.synchronize()
    log(f"[2] kernel == plain PyTorch == numpy on {n_cases} folds, a "
        f"{n_chunks}-chunk stream and {len(cuts) - 1} random chunks "
        f"(max_abs_err {max_err}); every plan == checksum.plan (sms {sms})")

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
        prof = profiled(torch, kfn, it)
        events_ms = cuda_ms(torch, kfn, it)
        k_ms, source = kernel_time(prof, events_ms)
        row = checksum_plan_row(kernel, ptx, chunks[0] if n_words == MiB
                                else big, sms)
        check(row["plan_equal"], f"fold_words {label}: the library's plan "
              f"differs from checksum.plan's {row['plan']}")
        ms, names = device_ms_per_call(torch, kfn, it)
        check(bool(names) and all("fold_words_kernel" in n for n in names),
              f"fold_words {label}: launched {sorted(names)}")
        row.update(ms=ms, roofline_share=b_ms / ms if ms else None)
        log(f"    {label} plan: " + json.dumps(row))
        timings[label] = {
            "ms": k_ms, "ms_source": source,
            "profiled_launches": prof["kernel_count"], "launched": it,
            "events_ms_per_call": events_ms,
            "device_ms_per_call": ms,
            "plain_ms": cuda_ms(torch, pfn, max(2, it // 10)),
            "bound_ms": b_ms, "bound_by": b_by,
            "h2d_ms": host_ms(torch, h2d, max(3, it // 4)),
            "kernel_GBps": 4 * n_words / k_ms / 1e6,
            "roofline_share": b_ms / k_ms}
        log(f"    {label}: " + json.dumps(timings[label]))
    main = timings["4MiB"]
    # what the main path hands the kernel: a chunk just copied to the card,
    # which L2 may still hold (its time only: no share of the bound)
    main["warm_after_copy_ms"] = kernel_ms_per_call(
        torch, lambda: kernel.fold_words_cuda(
            ops.words_tensor(chunk_data, MiB, dev), 0, acc), 100)
    # the wrapper's host time a call, on one chunk that stays in L2
    main["wrapper_host_ms"] = host_ms(
        torch, lambda: kernel.fold_words_cuda(chunks[0], 0, acc), 2000,
        warmup=20)
    log(f"    4MiB warm_after_copy_ms {main['warm_after_copy_ms']}, "
        f"wrapper_host_ms {main['wrapper_host_ms']}")
    return {"name": "fold_words", "route": "cuda",
            "source": "src/repro_torch/kernels/checksum/csrc/checksum.cu",
            "replaces": "src/repro/kernels/checksum/checksum.py:36",
            "launches": None, "max_abs_err": max_err, "exact": max_err == 0,
            "ms": main["ms"], "ms_source": main["ms_source"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "h2d_ms": main["h2d_ms"],
            "warm_after_copy_ms": main["warm_after_copy_ms"],
            "wrapper_host_ms": main["wrapper_host_ms"],
            "shape": "4 MiB chunk (1048576 words)",
            "at_256MiB": timings["256MiB"], "card": card}


def phase_staging(torch, np, kernel, ref, integrity, StagingArea,
                  chunk_bytes: int, lane_kernel) -> dict:
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

        kernel.launches = lane_kernel.launches = 0    # main path starts
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
        launches = kernel.launches                    # main path ends
        check(lane_kernel.launches == 0,
              "staging launched the lane-step kernel")
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


# --------------------------------------------------- lane segment step (B2)
LANE_EDGES = [  # (t, bytes_done, rate, bound)
    (10.0, 5.0, 0.0, 100.0), (10.0, 5.0, -3.0, 100.0),
    (10.0, 5.0, float("nan"), 100.0), (10.0, 100.0, 2.0, 50.0),
    (0.0, 5.0, 2.0, 100.0), (float("inf"), 5.0, 2.0, 100.0),
    (float("inf"), 5.0, 0.0, 100.0), (10.0, 0.0, 10.0, 100.0),
    (10.0, 5.0, 2.0, float("nan")), (0.0, 0.0, 1.0, -0.0),
    (float("nan"), 5.0, 2.0, 100.0), (10.0, 5.0, float("inf"), 100.0),
    (10.0, 5.0, 2.0, float("inf")), (5e-324, 1e300, 1e-300, 1e308)]


def lane_inputs(np, shape, seed: int, edges: bool):
    """Drawn as the JAX package's ensemble tests draw segment-step inputs;
    with ``edges``, the edge rows written over some elements."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 3600.0, size=shape)
    bd = rng.uniform(0.0, 1e12, size=shape)
    rate = np.where(rng.random(shape) < 0.2, 0.0,
                    rng.uniform(1e6, 1e9, size=shape))
    bound = bd + rng.uniform(0.0, 1e11, size=shape)
    if edges:
        flat = [a.reshape(-1) for a in (t, bd, rate, bound)]
        step = flat[0].size // len(LANE_EDGES)
        for k, row in enumerate(LANE_EDGES):
            for a, v in zip(flat, row):
                a[k * step] = v
    return t, bd, rate, bound


def lane_mismatch(np, got, want) -> float:
    """0.0 when ``got`` equals ``want`` bit for bit wherever ``want`` is not
    NaN and is NaN in the same places; else the largest difference (inf for
    a NaN placed differently, a sign of zero or a flipped ``hit``)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if want.dtype == np.bool_:
        return 0.0 if np.array_equal(got, want) else float("inf")
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        return float("inf")
    g, w = got[~nan], want[~nan]
    bad = g.view(np.int64) != w.view(np.int64)
    if not bad.any():
        return 0.0
    with np.errstate(invalid="ignore"):
        diff = np.abs(g[bad] - w[bad])
    # a zero of the other sign, or an inf of the other sign, is inf too
    return float(np.max(np.where(diff > 0, diff, np.inf)))


def phase_lane_step(torch, np, kernel, ref, card: str) -> dict:
    """B2: kernel == plain PyTorch version on the card == numpy reference."""
    dev = torch.device(DEVICE)
    names = ("t_left", "new_bytes", "adv", "moved", "hit")
    max_err = 0.0
    cases = []
    for seed, (label, shape) in enumerate(LANE_SHAPES.items()):
        for edges in (False, True):
            host = lane_inputs(np, shape, SEED + seed, edges)
            with np.errstate(invalid="ignore", over="ignore"):
                want = ref.lane_segment_step_np(*host)
            ins = [torch.from_numpy(a).to(dev) for a in host]
            got = kernel.lane_step_cuda(*ins)
            plain = ref.lane_segment_step_torch(*ins)
            torch.cuda.synchronize()
            for g, p, w, name in zip(got, plain, want, names):
                g, p = g.cpu().numpy(), p.cpu().numpy()
                err = max(lane_mismatch(np, g, w), lane_mismatch(np, g, p),
                          lane_mismatch(np, p, w))
                max_err = max(max_err, err)
                check(err == 0.0, f"lane step {label}{list(shape)} edges="
                      f"{edges}: {name} differs (max err {err})")
            cases.append(f"{label}{list(shape)}{'+edges' if edges else ''}")
    log(f"[5] lane step: kernel == plain PyTorch == numpy, bit for bit, on "
        f"{len(cases)} cases: {', '.join(cases)}")

    timings = {}
    for label in ("main", "full_catalog"):
        shape = LANE_SHAPES[label]
        n = shape[0] * shape[1]
        host = lane_inputs(np, shape, SEED + 10, False)
        ins = [torch.from_numpy(a).to(dev) for a in host]
        it = 200 if label == "main" else 50
        b_ms, b_by = lane_step_bound(n)
        # inputs just copied in sit in L2 on the main path; the full
        # catalog's 76 MB do not fit the 50 MB L2
        prof = profiled(torch, lambda: kernel.lane_step_cuda(*ins), it,
                        kernel_name="lane_step_kernel")
        events_ms = cuda_ms(torch, lambda: kernel.lane_step_cuda(*ins), it)
        k_ms, source = kernel_time(prof, events_ms)
        out = kernel.lane_step_cuda(*ins)
        timings[label] = {
            "shape": list(shape), "ms": k_ms, "ms_source": source,
            "profiled_launches": prof["kernel_count"], "launched": it,
            "events_ms_per_call": events_ms,
            "plain_ms": cuda_ms(torch, lambda: ref.lane_segment_step_torch(
                *ins), max(5, it // 10)),
            "bound_ms": b_ms, "bound_by": b_by,
            # the per-tick copies of the torch backend: four pageable input
            # copies in, five outputs back
            "h2d_ms": host_ms(torch, lambda: [torch.from_numpy(a).to(dev)
                                              for a in host],
                              max(5, it // 10)),
            "d2h_ms": host_ms(torch, lambda: [o.cpu() for o in out],
                              max(5, it // 10)),
            "kernel_GBps": LANE_STEP_BYTES * n / k_ms / 1e6,
            "roofline_share": b_ms / k_ms}
        log(f"    {label}: " + json.dumps(timings[label]))
    main = timings["main"]
    return {"name": "lane_step", "route": "cuda",
            "source": "src/repro_torch/kernels/lane_step/csrc/lane_step.cu",
            "replaces": "src/repro/kernels/lane_step/lane_step.py:31",
            "launches": None, "max_abs_err": max_err, "exact": max_err == 0,
            "ms": main["ms"], "ms_source": main["ms_source"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "h2d_ms": main["h2d_ms"],
            "d2h_ms": main["d2h_ms"],
            "shape": f"[256 lanes, 256 rows] ({256 * 256} elements)",
            "at_full_catalog": timings["full_catalog"], "card": card}


def phase_ensemble(torch, ens_engine, ens_run, registry, kernel,
                   hash_kernel) -> dict:
    """The ensemble main path on the numpy backend and on the default torch
    backend on the card; the kernel must launch once per segment step."""
    espec = registry.get_scenario(ENSEMBLE)
    check(espec.n_lanes == 256, f"{ENSEMBLE} has {espec.n_lanes} lanes")
    log(f"[6] cuts: {ENSEMBLE_CUTS}")
    calls = {"n": 0, "s": 0.0}
    make = ens_engine.make_segment_fn

    def counting(backend, device):
        """This script's count and host-clock time of the engine's
        segment-step calls (the package has no such hook)."""
        fn = make(backend, device)

        def segment(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            calls["s"] += time.perf_counter() - t0
            calls["n"] += 1
            return out
        return segment

    ens_engine.make_segment_fn = counting
    kw = dict(scale=ENSEMBLE_SCALE, n_datasets=ENSEMBLE_DATASETS)
    runs = {}
    try:
        for backend in ("numpy", "torch"):
            calls.update(n=0, s=0.0)
            if backend == "torch":
                kernel.launches = hash_kernel.launches = 0   # path starts
            t0 = time.perf_counter()
            res = ens_engine.run_ensemble(espec, backend=backend, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[backend] = {"result": res, "wall_s": wall,
                             "segment_calls": calls["n"],
                             "segment_s": calls["s"]}
        launches = kernel.launches                           # path ends
        check(hash_kernel.launches == 0,
              "the ensemble path launched the integrity-hash kernel")

        # the device's busy share over one profiled torch run
        calls.update(n=0, s=0.0)
        prof = profiled(torch, lambda: ens_engine.run_ensemble(
            espec, backend="torch", **kw), 1,
            kernel_name="lane_step_kernel", warmup=False)
        prof_calls = calls["n"]
        lane0 = ens_run.check_lane0(espec, ENSEMBLE_SCALE, ENSEMBLE_DATASETS)
    finally:
        ens_engine.make_segment_fn = make

    num, tor = runs["numpy"]["result"], runs["torch"]["result"]
    check(num.engine == tor.engine == "lanes",
          f"engines {num.engine}/{tor.engine}, want lanes")
    check(num.backend == "numpy" and tor.backend == "torch:cuda",
          f"backends {num.backend}/{tor.backend}")
    check(len(tor.lanes) == 256, f"{len(tor.lanes)} lanes")
    for i, (a, b) in enumerate(zip(num.lanes, tor.lanes)):
        diff = {f: (getattr(a, f), getattr(b, f))
                for f in ens_run.GATE_FIELDS if getattr(a, f) != getattr(b, f)}
        check(not diff, f"lane {i}: cuda differs from numpy: {diff}")
    check(num.bands == tor.bands, "bands differ between numpy and cuda")
    check(lane0["match"] and lane0["backend"] == "torch:cuda",
          f"check_lane0 on cuda: {lane0}")
    n_calls = runs["torch"]["segment_calls"]
    check(n_calls == runs["numpy"]["segment_calls"],
          f"{n_calls} segment steps on cuda, "
          f"{runs['numpy']['segment_calls']} on numpy")
    check(n_calls > 0 and launches == n_calls,
          f"{launches} lane-step launches for {n_calls} segment steps")
    t_run = runs["torch"]
    # device time per tick from the profiled run: copies are 4 in and 5 out
    # per tick, so their totals are divided by the ticks it ran
    per = {k: prof[f"{k}_ms"] / prof_calls for k in ("h2d", "kernel", "d2h")}
    split = {"host_engine_ms": (t_run["wall_s"] - t_run["segment_s"]) * 1e3
             / n_calls,
             "segment_call_ms": t_run["segment_s"] * 1e3 / n_calls,
             "h2d_ms": per["h2d"], "kernel_ms": per["kernel"],
             "d2h_ms": per["d2h"]}
    busy = (prof["h2d_ms"] + prof["kernel_ms"] + prof["d2h_ms"])
    out = {"ensemble": ENSEMBLE, "lanes": len(tor.lanes),
           "datasets": ENSEMBLE_DATASETS, "scale": ENSEMBLE_SCALE,
           "segment_steps": n_calls, "launches": launches,
           "wall_s_numpy": runs["numpy"]["wall_s"],
           "wall_s_cuda": t_run["wall_s"],
           "segment_s_numpy": runs["numpy"]["segment_s"],
           "segment_s_cuda": t_run["segment_s"],
           "per_tick_cuda": split,
           "profiled_wall_ms": prof["wall_ms"],
           "profiled_events": {k: prof[f"{k}_count"]
                               for k in ("kernel", "h2d", "d2h")},
           "device_busy_ms": busy,
           "device_busy_share": (busy / prof["wall_ms"]
                                 if prof["kernel_count"] else None),
           "sim_days_p50": tor.bands["sim_days"]["p50"],
           "lane0": {k: lane0[k] for k in ("match", "backend", "seed")}}
    log("[6] ensemble: " + json.dumps(out))
    return out


# ------------------------------------------------------ flash attention (B3)
# H100 SXM published peaks beside PEAK_BYTES_PER_S: 989 TFLOP/s dense bf16 on
# the tensor cores, 67 TFLOP/s fp32 outside them; the special-function units
# give 16 exp per SM per clock (132 SMs x 1.98 GHz)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
ATTN_TOL = {"bfloat16": 2.5e-2, "float32": 2e-5}   # tests/test_kernels.py
# (label, B, T, H, Hkv, hd, window, dtype); "main" is smollm-135m's serve
# shape, "qwen3_14b_serve" qwen3-14b's, "train_4k" one sequence of
# train_4k at qwen3-14b's heads, "qwen3_moe_serve" qwen3-moe-30b-a3b's
# serve shape (a GQA group of 8); gemma3-27b's local (window 1024) and
# global prefill of a wave of 2048-token prompts, qwen2-vl-7b's serve shape
# (a GQA group of 7) and zamba2-1.2b's and musicgen-large's (hd 64, no
# grouping); phase 17's examples: the smoke serve's two prefill waves
# (prompts bucketed to 32 and 16 tokens, shorter than one tile) and the
# quickstart's 8 x 128 training batch at smollm-135m's heads
FLASH_CASES = [("main", 4, 256, 9, 3, 64, None, "bfloat16"),
               ("ragged_T200", 2, 200, 9, 3, 64, None, "bfloat16"),
               ("window128_hd128", 1, 384, 2, 2, 128, 128, "bfloat16"),
               ("hd32", 2, 256, 8, 2, 32, None, "bfloat16"),
               ("qwen3_14b_serve", 4, 256, 40, 8, 128, None, "bfloat16"),
               ("f32_window64", 2, 256, 8, 8, 32, 64, "float32"),
               ("train_4k", 1, 4096, 40, 8, 128, None, "bfloat16"),
               ("qwen3_moe_serve", 4, 256, 32, 4, 128, None, "bfloat16"),
               ("gemma3_local", 4, 2048, 32, 16, 128, 1024, "bfloat16"),
               ("gemma3_global", 4, 2048, 32, 16, 128, None, "bfloat16"),
               ("qwen2_vl_serve", 4, 256, 28, 4, 128, None, "bfloat16"),
               ("zamba2_musicgen_serve", 4, 256, 32, 32, 64, None,
                "bfloat16"),
               ("example_serve_T32", 4, 32, 4, 1, 32, None, "bfloat16"),
               ("example_serve_T16", 4, 16, 4, 1, 32, None, "bfloat16"),
               ("example_quickstart", 8, 128, 9, 3, 64, None, "bfloat16")]
# the kernel each input type launches
FLASH_KERNELS = {"bfloat16": ("tensor_core", "flash_fwd_wgmma_kernel"),
                 "float32": ("cuda_core", "flash_fwd_kernel")}


def attention_pairs(T: int, window) -> int:
    """(query, key) pairs the causal (windowed) mask keeps."""
    return sum(min(t + 1, window or t + 1) for t in range(T))


def flash_bound(B, T, H, Hkv, hd, window, elt: int, flops_per_s: float):
    """Least time (ms) for the attention: QK^T and PV at 2 FLOPs per
    multiply-add over the kept pairs, against q, k, v read once and o
    written once."""
    flops = 4 * B * H * hd * attention_pairs(T, window)
    n_bytes = elt * (2 * B * T * H * hd + 2 * B * T * Hkv * hd)
    return roofline(n_bytes, flops, flops_per_s)


def phase_flash(torch, kernel, ref, card: str) -> dict:
    """B3: kernel == plain PyTorch version on the card, at the main path's
    shapes; with the kernel's, the plain version's and SDPA's times, the
    kernel's and SDPA's by the same measure (the profiler's device time per
    call)."""
    import torch.nn.functional as F
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    timings = {}
    for label, B, T, H, Hkv, hd, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        path, kernel_name = FLASH_KERNELS[dname]
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, T, Hkv, hd, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        before = dict(kernel.launches_by_path)
        got = kernel.flash_attention_cuda(q, k, v, window)
        check(kernel.launches_by_path[path] == before[path] + 1,
              f"flash {label}: {dname} did not launch the {path} kernel")
        plain = ref.attention_torch(q, k, v, window)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        max_err = max(max_err, err)
        tol = ATTN_TOL[dname]
        check(torch.allclose(got.float(), plain.float(), atol=tol, rtol=tol),
              f"flash {label}: kernel differs from the plain version "
              f"(max err {err}, tol {tol})")
        if label == "main":
            # the prefill reads k and v as slices of a longer KV cache
            kc, vc = (torch.zeros(B, 4 * T, Hkv, hd, dtype=dtype, device=dev)
                      for _ in range(2))
            kc[:, :T], vc[:, :T] = k, v
            view = kernel.flash_attention_cuda(q, kc[:, :T], vc[:, :T])
            check(torch.equal(view, got), "flash over cache views differs")
        it = 20 if label == "train_4k" else 50
        b_ms, b_by = flash_bound(B, T, H, Hkv, hd, window, q.element_size(),
                                 PEAK_BF16_FLOPS if dname == "bfloat16"
                                 else PEAK_FP32_FLOPS)
        kfn = lambda: kernel.flash_attention_cuda(q, k, v, window)  # noqa
        k_ms, names = device_ms_per_call(torch, kfn, it)
        check(all(kernel_name in n for n in names),
              f"flash {label}: launched {sorted(names)}, not only "
              f"{kernel_name}")
        events_ms = cuda_ms(torch, kfn, it)
        source = "torch.profiler" if k_ms is not None else "cuda_events"
        blocks = {}
        if dname == "bfloat16":
            # every block shape the library has at this hd, held to the
            # plain version and timed; the launch picks one of them
            for shape in kernel.blocks_for(hd):
                forced = kernel.flash_attention_cuda(q, k, v, window, shape)
                torch.cuda.synchronize()
                f_err = (forced.float() - plain.float()).abs().max().item()
                max_err = max(max_err, f_err)
                check(torch.allclose(forced.float(), plain.float(), atol=tol,
                                     rtol=tol),
                      f"flash {label} block {shape}: differs from the plain "
                      f"version (max err {f_err}, tol {tol})")
                f_ms, _ = device_ms_per_call(
                    torch, lambda: kernel.flash_attention_cuda(  # noqa
                        q, k, v, window, shape), it)
                blocks["x".join(map(str, shape))] = dict(
                    kernel.block_shape(hd, T, window, shape), ms=f_ms,
                    max_abs_err=f_err)
        lib_ms = lib_events_ms = lib_names = lib_err = None
        if dname == "bfloat16":
            # the same function in one SDPA call; a window needs an explicit
            # boolean mask (True = attend), which rules out the flash
            # backend: the kernels it launches name the backend it chose
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if window is not None:
                i = torch.arange(T, device=dev)
                d = i[:, None] - i[None, :]
                mask = (d >= 0) & (d < window)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            lib_err = (sdpa().transpose(1, 2).float() - plain.float()).abs(
                ).max().item()
            lib_ms, lib_names = device_ms_per_call(torch, sdpa, it)
            lib_events_ms = cuda_ms(torch, sdpa, it)
        timings[label] = {
            "shape": [B, T, H, Hkv, hd], "window": window, "dtype": dname,
            "kernel": path, "max_abs_err": err,
            "ms": k_ms if k_ms is not None else events_ms,
            "ms_source": source, "profiled_launches": sum(names.values()),
            "launched": it, "events_ms_per_call": events_ms,
            "plain_ms": cuda_ms(torch, lambda: ref.attention_torch(
                q, k, v, window), max(2, it // 10)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_events_ms_per_call": lib_events_ms,
            "library_kernels": lib_names,
            "library_max_abs_err": lib_err,
            "block": (kernel.block_shape(hd, T, window)
                      if dname == "bfloat16" else None),
            "blocks": blocks}
        timings[label]["roofline_share"] = b_ms / timings[label]["ms"]
        log(f"[7] flash {label}: " + json.dumps(timings[label]))
    main = timings["main"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:31",
            "launches": None, "max_abs_err": max_err,
            "ms": main["ms"], "ms_source": main["ms_source"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), profiler device time per call",
            "shape": "smollm-135m serve [B=4, T=256, H=9, Hkv=3, hd=64] bf16",
            "at_train_4k": timings["train_4k"],
            "at_qwen3_moe_serve": timings["qwen3_moe_serve"],
            "at_families": {k: timings[k] for k in (
                "gemma3_local", "gemma3_global", "qwen2_vl_serve",
                "zamba2_musicgen_serve")},
            "at_examples": {k: timings[k] for k in (
                "example_serve_T32", "example_serve_T16",
                "example_quickstart")},
            "cases": timings,
            "card": card}


# ------------------------------------------------------ selective scan (B4)
# (label, B, T, D, N, inputs); "main" is falcon-mamba-7b's serve shape,
# "long" one 4096-token prompt (a train_4k sequence) at its width, and
# "model_range" the serve shape with the model's own A and dt (scan_inputs);
# phase 17's falcon-mamba smoke serve: its two prefill waves of 32 and 16
# tokens at the smoke width (256 channels, 8 states)
SCAN_CASES = [("main", 4, 256, 8192, 16, "test"),
              ("ragged", 1, 100, 300, 8, "test"),
              ("long", 1, 4096, 8192, 16, "test"),
              ("model_range", 4, 256, 8192, 16, "model"),
              ("example_serve_T32", 4, 32, 256, 8, "test"),
              ("example_serve_T16", 4, 16, 256, 8, "test")]
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py


def scan_inputs(torch, gen, B, T, D, N, zero_h0=False, model=False):
    """Drawn as tests/test_kernels.py draws them, on the card; with
    ``model``, A and dt as falcon-mamba's Mamba1 layer makes them
    (``models/ssm.py``: A = -(1..N) for every channel, dt = softplus of a
    projection with a zero bias, here of a standard normal), where |dt * A|
    reaches tens."""
    dev = gen.device
    u = torch.randn(B, T, D, generator=gen, device=dev)
    dt = (torch.nn.functional.softplus(
        torch.randn(B, T, D, generator=gen, device=dev)) if model else
        0.01 + 0.19 * torch.rand(B, T, D, generator=gen, device=dev))
    Bm, Cm = (torch.randn(B, T, N, generator=gen, device=dev)
              for _ in range(2))
    A = (-torch.arange(1, N + 1, dtype=torch.float32,
                       device=dev)[None].repeat(D, 1) if model else
         -(0.5 + 1.5 * torch.rand(D, N, generator=gen, device=dev)))
    h0 = (torch.zeros(B, D, N, device=dev) if zero_h0 else
          torch.randn(B, D, N, generator=gen, device=dev))
    return u, dt, Bm, Cm, A, h0


def scan_bound(B, T, D, N):
    """Least time (ms) for the scan: u, dt, Bm, Cm, A, h0 read and y, hT
    written once, against one exp per (b, t, d, n) at the SFU rate."""
    n_bytes = 4 * (3 * B * T * D + 2 * B * T * N + D * N + 2 * B * D * N)
    return roofline(n_bytes, B * T * D * N, PEAK_SFU_PER_S)


def ptxas_kernels(build_log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel in a
    ``-Xptxas -v`` log, by ``kernel_label``."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line)
            out[name] = {}
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            out[name]["spill_stores"] = int(words[words.index("spill") - 2])
            out[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                out[name]["smem_bytes"] = int(words[words.index("smem") - 2])
    return out


def phase_scan(torch, kernel, ref, card: str) -> dict:
    """B4: kernel == plain PyTorch version on the card at rtol/atol 1e-4, at
    every case, at every layout, over the split in halves and on unaligned
    views; each case and layout timed as the profiler's device time per
    call, beside the bound, with ptxas's registers and spills."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    lib = kernel.LIBRARY.load()
    ptx = ptxas_kernels(kernel.LIBRARY.build_log)
    if ptx:   # a library built by an earlier run leaves no log
        for layout in kernel.LAYOUTS:
            got = ptx.get(f"selective_scan_kernel<16, {layout}>", {})
            check(got.get("spill_stores") == 0 == got.get("spill_loads"),
                  f"scan layout {layout} at N=16 spills: {got}")
    max_err = 0.0

    def close(got, want, what):
        nonlocal max_err
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        share = ((got - want).abs() / (SCAN_TOL["atol"] + SCAN_TOL["rtol"]
                                       * want.abs())).max().item()
        check(torch.allclose(got, want, **SCAN_TOL),
              f"scan {what}: kernel differs from the plain version "
              f"(max err {err})")
        return {"max_abs_err": err, "tol_share": share}

    def worst(a, b):
        return {k: max(a[k], b[k]) for k in a}

    timings = {}
    for label, B, T, D, N, kind in SCAN_CASES:
        ins = scan_inputs(torch, gen, B, T, D, N, model=kind == "model")
        y2, h2 = ref.selective_scan_torch(*ins)
        picked = kernel.layout_for(B, D, N)
        check(lib.repro_selective_scan_layout_for(B, D, N) == picked,
              f"scan {label}: the library picks layout "
              f"{lib.repro_selective_scan_layout_for(B, D, N)}, "
              f"layout_for {picked}")
        before = kernel.launches
        y, hT = kernel.selective_scan_cuda(*ins)
        check(kernel.launches == before + 1, f"scan {label}: not one launch")
        errs = worst(close(y, y2, f"{label} y"), close(hT, h2, f"{label} hT"))
        b_ms, b_by = scan_bound(B, T, D, N)
        it = 10 if T >= 4096 else 20
        layouts = {}
        for layout in kernel.LAYOUTS:
            yl, hl = kernel.selective_scan_cuda(*ins, layout=layout)
            l_errs = worst(close(yl, y2, f"{label} layout {layout} y"),
                           close(hl, h2, f"{label} layout {layout} hT"))
            errs = worst(errs, l_errs)
            ms, names = device_ms_per_call(
                torch, lambda: kernel.selective_scan_cuda(  # noqa: B023
                    *ins, layout=layout), it)
            name = f"selective_scan_kernel<{N}, {layout}>"
            check(bool(names) and all(name in n for n in names),
                  f"scan {label} layout {layout}: launched {sorted(names)}, "
                  f"not only {name}")
            layouts[str(layout)] = dict(
                l_errs, ms=ms, roofline_share=b_ms / ms if ms else None,
                **ptx.get(name, {}))
        events_ms = cuda_ms(torch, lambda: kernel.selective_scan_cuda(  # noqa
            *ins), it)
        k_ms = layouts[str(picked)]["ms"]
        timings[label] = {
            "shape": [B, T, D, N], "inputs": kind, "layout": picked,
            **errs, "ms": k_ms if k_ms is not None else events_ms,
            "ms_source": ("torch.profiler" if k_ms is not None
                          else "cuda_events"),
            "events_ms_per_call": events_ms,
            "plain_ms": cuda_ms(torch, lambda: ref.selective_scan_torch(
                *ins), 1, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_ms": 4 * (3 * B * T * D + 2 * B * T * N + D * N
                             + 2 * B * D * N) / PEAK_BYTES_PER_S * 1e3,
            "exp_ms": B * T * D * N / PEAK_SFU_PER_S * 1e3,
            "layouts": layouts}
        timings[label]["roofline_share"] = b_ms / timings[label]["ms"]
        log(f"[8] scan {label}: " + json.dumps(timings[label]))
        del ins, y, hT, y2, h2
    # scanning [0:T] equals [0:T/2] then [T/2:T] with the state carried, at
    # every layout
    u, dt, Bm, Cm, A, h0 = scan_inputs(torch, gen, 4, 256, 8192, 16,
                                       zero_h0=True)
    for layout in kernel.LAYOUTS:
        y_full, h_full = kernel.selective_scan_cuda(u, dt, Bm, Cm, A, h0,
                                                    layout)
        ya, ha = kernel.selective_scan_cuda(u[:, :128], dt[:, :128],
                                            Bm[:, :128], Cm[:, :128], A, h0,
                                            layout)
        yb, hb = kernel.selective_scan_cuda(u[:, 128:], dt[:, 128:],
                                            Bm[:, 128:], Cm[:, 128:], A, ha,
                                            layout)
        close(torch.cat([ya, yb], 1), y_full, f"halves y, layout {layout}")
        close(hb, h_full, f"halves hT, layout {layout}")
    # inputs the 16-byte copies cannot take, which go through the kernel's
    # 4-byte copies and loads: rows of 301 floats, Bm and Cm sliced from one
    # projection at a 4-byte offset, A and h0 one float off a 16-byte line
    u, dt, _, _, A, h0 = scan_inputs(torch, gen, 2, 100, 301, 8)
    proj = torch.randn(2, 100, 17, generator=gen, device=dev)
    Bm, Cm = proj[..., 1:9], proj[..., 9:]
    A, h0 = (torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
             .copy_(x) for x in (A, h0))
    y2, h2 = ref.selective_scan_torch(u, dt, Bm, Cm, A, h0)
    for layout in kernel.LAYOUTS:
        y, hT = kernel.selective_scan_cuda(u, dt, Bm, Cm, A, h0, layout)
        close(y, y2, f"unaligned views y, layout {layout}")
        close(hT, h2, f"unaligned views hT, layout {layout}")
    log(f"[8] scan: kernel == plain PyTorch (rtol/atol 1e-4) on "
        f"{len(SCAN_CASES)} cases at layouts {kernel.LAYOUTS}, the split "
        f"in halves and unaligned views (max_abs_err {max_err})")
    main = timings["main"]
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:30",
            "launches": None, "max_abs_err": max_err,
            "ms": main["ms"], "ms_source": main["ms_source"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "library": "none: no single PyTorch call computes this scan",
            "shape": "falcon-mamba-7b serve [B=4, T=256, D=8192, N=16] f32",
            "layout": main["layout"], "cases": timings, "card": card}


# ------------------------------------------ Mamba1's fused decode step
# (label, B, d_in, N, dt rank, activations): falcon-mamba-7b's serve shape
# (the main path: 16 slots of the benchmark's cells), phase 17's smoke serve
# (4 slots, 256 channels, 8 states), and the serve shape in f32 (phase 9's
# f32 prefill/decode check)
STEP_CASES = [("main", 16, 8192, 16, 256, "bfloat16"),
              ("smoke", 4, 256, 8, 8, "bfloat16"),
              ("f32", 16, 8192, 16, 256, "float32")]
# input sets a timing cycles through, as the 64 layers of a step do: eight
# of the main shape's ~25 MB pass the 50 MB L2
STEP_SETS = 8
STEP_TOL = {"h": dict(rtol=1e-4, atol=1e-4),          # tests/test_torch_
            "bfloat16": dict(rtol=2 ** -7, atol=1e-4),  # mamba_step.py
            "float32": dict(rtol=1e-4, atol=1e-4)}


def step_inputs(torch, gen, B, C, N, R, dtype):
    """(conv step's inputs, state step's inputs) as falcon-mamba's layer
    makes them: the conv state a view of a longer window (as prefill leaves
    it), dt, B and C views of one x_proj output, A = -(1..N), dt_proj of
    unit rows; the state step's xc is drawn (the checks pass the conv's)."""
    dev = gen.device

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=gen, device=dev)
                ).to(dt)
    conv_in = (rnd(B, 1, C, dt=dtype), rnd(B, 6, C, dt=dtype)[:, 3:],
               rnd(4, C, scale=0.5, dt=dtype), rnd(C, scale=0.1, dt=dtype))
    dt, Bm, Cm = torch.split(rnd(B, 1, R + 2 * N, dt=dtype), [R, N, N], -1)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev))[None].repeat(C, 1)
    state_in = [dt, Bm, Cm, rnd(R, C, scale=R ** -0.5, dt=dtype),
                rnd(C, scale=0.5), A_log, 1.0 + rnd(C, scale=0.1),
                torch.nn.functional.silu(rnd(B, 1, C)), rnd(B, 1, C, dt=dtype),
                rnd(B, C, N)]
    return conv_in, state_in


def step_bytes(B, C, N, R, elt: int) -> dict:
    """Bytes each kernel of the step reads and writes once, at a conv of 4
    taps and activations of ``elt`` bytes: the conv step's xz, state, taps,
    bias, xc (f32, and in bf16 where elt is 2) and new state; the state
    step's dt, B and C, dt_proj, dt_bias, A_log, D, xc, z, h both ways and
    y."""
    conv = (B * C * elt + 2 * 3 * B * C * elt + 5 * C * elt + 4 * B * C
            + (B * C * elt if elt == 2 else 0))
    state = (B * (R + 2 * N) * elt + R * C * elt + 2 * 4 * C + 4 * C * N
             + 4 * B * C + B * C * elt + 2 * 4 * B * C * N + B * C * elt)
    return {"mamba_conv_step_kernel": conv, "mamba_state_step_kernel": state}


def phase_mamba_step(torch, step, ref, card: str) -> dict:
    """Mamba1's fused decode step (``mamba_step.cu``): each kernel against
    its plain version on the card at ``STEP_CASES`` (the conv's outputs bit
    for bit, h and y at ``STEP_TOL``), also with dt_bias, A_log and D in
    bf16; each timed as the profiler's device time per call over
    ``STEP_SETS`` input sets in turn, beside its bytes bound and the plain
    versions' time."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    step.LIBRARY.load()          # phase 1 printed its ptxas lines
    cases = {}
    for label, B, C, N, R, dt_name in STEP_CASES:
        dtype = getattr(torch, dt_name)
        sets = [step_inputs(torch, gen, B, C, N, R, dtype)
                for _ in range(STEP_SETS)]
        conv_in, state_in = sets[0]
        got = step.conv_step_cuda(*conv_in)
        want = ref.conv_step_torch(*conv_in)
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(got, want)),
              f"step {label}: the conv kernel differs from the plain "
              f"version")
        errs = {}
        for params in ("f32", "bf16"):
            ins = state_in[:7] + [got[0]] + state_in[8:]
            if params == "bf16":
                ins[4:7] = [t.to(torch.bfloat16) for t in ins[4:7]]
            y, h = step.state_step_cuda(*ins)
            y2, h2 = ref.state_step_torch(*ins)
            for what, a, b, tol in (("h", h, h2, STEP_TOL["h"]),
                                    ("y", y, y2, STEP_TOL[dt_name])):
                err = (a.float() - b.float()).abs().max().item()
                check(torch.allclose(a.float(), b.float(), **tol),
                      f"step {label} ({params} params): the state kernel's "
                      f"{what} differs from the plain version by {err}")
                errs[f"{what}_max_abs_err_{params}_params"] = err
        turn = iter(range(10 ** 9))

        def conv_call():
            step.conv_step_cuda(*sets[next(turn) % STEP_SETS][0])

        def state_call():
            step.state_step_cuda(*sets[next(turn) % STEP_SETS][1])
        bytes_ = step_bytes(B, C, N, R, dtype.itemsize)
        kernels = {}
        for name, call in (("mamba_conv_step_kernel", conv_call),
                           ("mamba_state_step_kernel", state_call)):
            ms, names = device_ms_per_call(torch, call, 64)
            check(bool(names) and all(name in n for n in names),
                  f"step {label}: launched {sorted(names)}, not only {name}")
            b_ms, b_by = roofline(bytes_[name], B * C * N if "state" in name
                                  else 0, PEAK_SFU_PER_S)
            kernels[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                             "bytes": bytes_[name],
                             "roofline_share": b_ms / ms if ms else None}

        def plain():
            xc, _, _ = ref.conv_step_torch(*conv_in)
            ref.state_step_torch(*state_in[:7], xc, *state_in[8:])
        cases[label] = {"shape": [B, C, N, R], "dtype": dt_name, **errs,
                        "kernels": kernels,
                        "events_ms_per_step": cuda_ms(
                            torch, lambda: (conv_call(), state_call()), 64),
                        "plain_ms": cuda_ms(torch, plain, 5)}
        log(f"[8b] step {label}: " + json.dumps(cases[label]))
        del sets, conv_in, state_in
    main = cases["main"]
    k = main["kernels"]
    ms = [v["ms"] for v in k.values()]
    return {"name": "mamba_step", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_step.cu",
            "replaces": "none: the JAX package's single decode step is jnp "
                        "(src/repro/models/ssm.py mamba1_block, T == 1)",
            "launches": None,
            "ms": sum(ms) if all(m is not None for m in ms) else None,
            "ms_source": "torch.profiler", "plain_ms": main["plain_ms"],
            "bound_ms": sum(v["bound_ms"] for v in k.values()),
            "bound_by": "bytes", "library_ms": None,
            "library": "none: no single PyTorch call computes this step",
            "shape": "falcon-mamba-7b serve [B=16, d_in=8192, N=16, R=256] "
                     "bf16", "cases": cases, "card": card}


# ------------------------------------------------------------ serving (3rd)
# (arch, layers, flash and scan launches a prefill wave, the name of the
# kernel its prefill launches, requests profiled, the f32 check's cut: its
# layers and the MoE capacity factor (None: no MoE), or None for the
# published config; and, optionally, a mapping of options: "prompts" (the
# least and most tokens of a prompt, in place of the launcher's),
# "max_seq", "check_tokens" (the consistency checks' sequence, 32 by
# default), "cut_layers" (the card-vs-CPU cut, 2 by default), "cut_f32"
# (that cut in f32) and "mrope_prefill" (one prefill of frontend
# embeddings with M-RoPE ids))
SERVE_ARCHS = (("smollm-135m", 30, {"flash": 30, "scan": 0},
                "flash_fwd_wgmma_kernel", 8, None),
               ("falcon-mamba-7b", 64, {"flash": 0, "scan": 64},
                "selective_scan_kernel", 8, None))
# qwen3-moe's GQA runs B3 in every layer; deepseek-v2-lite's MLA is eager
# (q.k head dim 192, v 128).  A wave launches ~10^5 kernels, so one wave is
# profiled.  The f32 check runs at a depth whose f32 weights fit, drop-free
MOE_CHECK = (8, 8.0)
MOE_SERVE_ARCHS = (("qwen3-moe-30b-a3b", 48, {"flash": 48, "scan": 0},
                    "flash_fwd_wgmma_kernel", 4, MOE_CHECK),
                   ("deepseek-v2-lite-16b", 27, {"flash": 0, "scan": 0},
                    None, 4, MOE_CHECK))
MOE_CUTS = (f"the f32 prefill/decode check: {MOE_CHECK[0]} layers of 48 "
            f"(qwen3-moe) and of 27 (deepseek-v2-lite), capacity_factor "
            f"1.25 -> {MOE_CHECK[1]} (no drops); the card-vs-CPU cut in f32 "
            f"at that capacity; the bf16 serving runs at full depth")
# The last four families.  gemma3-27b's prompts are longer than its
# 1024-token window and padded to 2048, so its local layers prefill past
# their rings' length and decode across the wrap; its f32 check (6 layers,
# one group: 62 in f32 are 108 GB) runs 1040 tokens, past the window.
# zamba2-1.2b runs B3 once a group (6 calls of its shared block); its cut
# is one group and a tail layer, the least depth that reaches the shared
# block.  qwen2-vl-7b also prefills the frontend's embeddings with M-RoPE.
# musicgen-large's card-vs-CPU cut runs in f32: its per-book heads are drawn
# at 1/sqrt(4) (the reference's init scales by the first axis), so its
# logits reach ~20, and one bf16 step apart in a hidden state moved them by
# 1.0 between the CPU and an H100 in a bf16 cut.
FAMILY_SERVE_ARCHS = (
    ("gemma3-27b", 62, {"flash": 62, "scan": 0}, "flash_fwd_wgmma_kernel", 4,
     (6, None), {"prompts": (1030, 2000), "max_seq": 2080,
                 "check_tokens": 1040}),
    ("zamba2-1.2b", 38, {"flash": 6, "scan": 0}, "flash_fwd_wgmma_kernel", 4,
     None, {"cut_layers": 7}),
    ("qwen2-vl-7b", 28, {"flash": 28, "scan": 0}, "flash_fwd_wgmma_kernel", 4,
     None, {"mrope_prefill": True}),
    ("musicgen-large", 48, {"flash": 48, "scan": 0},
     "flash_fwd_wgmma_kernel", 4, None, {"cut_f32": True}))
FAMILY_CUTS = ("gemma3-27b's f32 prefill/decode check at 6 of 62 layers (one "
               "local/global group; 62 layers in f32 are 108 GB); the "
               "card-vs-CPU cuts at 2 layers (gemma3: two windowed layers; "
               "musicgen in f32), 7 (zamba2: one group, the shared block, "
               "one tail layer); one wave profiled (4 requests, not 8: "
               "zamba2's 8 launched 160,583 device ops); "
               "the bf16 serving runs at full depth")
SERVE = dict(requests=8, max_new=16, max_batch=4, max_seq=1024)
PREFILL_TOL = dict(atol=0.12, rtol=0.05)   # tests/test_models.py, bf16
DECODE_TOL = dict(atol=0.5, rtol=0.03)


def device_events(torch, prof) -> list:
    """The kernels, copies and fills the profiler recorded on the device,
    without the spans of ``record_function`` ranges it also puts there."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_ms(torch, prof) -> float:
    """Device time of every kernel, copy and fill the profiler recorded."""
    return sum(e.self_device_time_total
               for e in device_events(torch, prof)) / 1e3


def allclose(torch, got, want, tol, what: str) -> float:
    """The largest difference, after checking |got - want| <= atol + rtol *
    |want| everywhere."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, **tol),
          f"{what}: max err {err} beyond {tol}")
    return err


def consistency(torch, model, toks, check_tol: bool) -> dict:
    """prefill(T-8) + 8 decode steps against the forward over T tokens, and
    the forward over T-8 tokens against the first T-8 of that forward (the
    same sums in matmuls of another shape).  Asserted at
    tests/test_models.py's tolerances when ``check_tol``; an f32 model's
    caches are f32."""
    from repro_torch import tree
    T = toks.shape[1]
    Tp = T - 8
    full = model(toks).float()
    short = model(toks[:, :Tp]).float()
    cache = model.init_cache(toks.shape[0], T + 8)
    if model.dtype == torch.float32:
        cache = tree.tree_map(lambda x: x.float(), cache)
    logits, cache = model.prefill(toks[:, :Tp], cache)
    errs = {"forward_short_vs_long": (short - full[:, :Tp]).abs().max()
            .item(),
            "prefill": (logits[:, 0].float() - full[:, Tp - 1]).abs().max()
            .item(), "decode": 0.0}
    if check_tol:
        allclose(torch, logits[:, 0], full[:, Tp - 1], PREFILL_TOL,
                 "prefill vs forward")
    paths = []
    for t in range(Tp, T):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        paths.append(model.decode_path)
        errs["decode"] = max(errs["decode"], (lg[:, 0].float() - full[:, t])
                             .abs().max().item())
        if check_tol:
            allclose(torch, lg[:, 0], full[:, t], DECODE_TOL,
                     f"decode t={t} vs forward")
    check(paths == graph_paths(model, len(paths)),
          f"decode paths {paths} at batch {toks.shape[0]}")
    return errs


def next_span_index(spans) -> int:
    """The index the program's span log gives its next record."""
    return spans.LOG[-1].index + 1 if spans.LOG else 0


def decode_spans(spans, first: int) -> list:
    """The ``lm.decode_step`` spans recorded from index ``first`` on."""
    return [r for r in spans.LOG
            if r.index >= first and r.name == "lm.decode_step"]


def graph_paths(model, n: int, captured: bool = False) -> list:
    """The paths ``n`` decode steps take at a new batch size: a capture
    and replays where the model decodes as a CUDA graph (all replays where
    it has ``captured`` that size), else eager steps."""
    if not model.graphs_decode():
        return ["eager"] * n
    return (["replay"] if captured else ["capture"]) + ["replay"] * (n - 1)


MROPE_PREFILL = dict(batch=4, seq=256, decode=16)


def mrope_prefill(torch, model, flash, n_layers: int) -> dict:
    """One prefill of the frontend's embeddings with M-RoPE ids (an image
    grid, then text) into a cache, then greedy decode steps from it (the
    token table, t on all three streams, as in the reference): B3 once a
    layer, the prefill's logits against the forward's last position, the
    M-RoPE rotation not the plain one, finite decode logits."""
    from repro_torch.models.frontends import train_batch_stub
    b, seq, n_dec = (MROPE_PREFILL[k] for k in ("batch", "seq", "decode"))
    batch = train_batch_stub(model.cfg, b, seq, seed=SEED + 11,
                             device=DEVICE)
    del batch["labels"]
    check(set(batch) == {"embeds", "positions3"},
          f"the vlm batch holds {sorted(batch)}")
    before = flash.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, model.init_cache(b, seq + n_dec))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(flash.launches == before + n_layers,
          f"the M-RoPE prefill launched {flash.launches - before} B3 "
          f"kernels, not {n_layers}")
    full = model(batch)
    err = allclose(torch, logits[:, 0], full[:, -1], PREFILL_TOL,
                   "M-RoPE prefill vs forward")
    plain, _ = model.prefill({"embeds": batch["embeds"]},
                             model.init_cache(b, seq))
    rope_diff = (plain.float() - logits.float()).abs().max().item()
    check(rope_diff > 0, "the M-RoPE prefill equals the plain-RoPE one")
    tok = logits.argmax(-1)
    t0 = time.perf_counter()
    for t in range(seq, seq + n_dec):
        lg, cache = model.decode_step(cache, tok, t)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
    check(bool(torch.isfinite(lg.float()).all()),
          "M-RoPE decode logits not finite")
    return {"batch": b, "seq": seq, "decode_steps": n_dec,
            "launches": n_layers, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms,
            "prefill_vs_forward_max_err": err,
            "mrope_vs_plain_rope_max_diff": rope_diff}


def phase_serve(torch, get_config, LM, launch_serve, Engine, flash, scan,
                others, archs=SERVE_ARCHS, label: int = 9,
                step=None) -> dict:
    """Full-width serving through the engine on the card, of smollm-135m and
    falcon-mamba-7b (phase 9), of the MoE archs (phase 12) or of the last
    four families (phase 14), with every count set to 0 just before each
    run and read just after.  ``step`` (``mamba_step``) is held to the
    decode steps' paths: each Mamba1 mixer launches its selective-state
    kernel once an eager step, twice a step that captures a graph (its
    warm-up and the capture), and never in a replay."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    out = {}
    for arch, n_layers, per_wave, kernel_name, n_prof, f32_cut, *more in archs:
        opts = more[0] if more else {}
        max_seq = opts.get("max_seq", SERVE["max_seq"])
        cfg = get_config(arch)

        def serve(eng, n):
            """(engine, finished requests, wall s) of n seeded requests:
            the launcher's prompts, or opts["prompts"]' lengths."""
            if "prompts" not in opts:
                return launch_serve.serve(cfg, n, SERVE["max_new"],
                                          engine=eng, seed=SEED)
            lo, hi = opts["prompts"]
            g = torch.Generator().manual_seed(SEED)
            t = time.perf_counter()
            for _ in range(n):
                plen = int(torch.randint(lo, hi + 1, (), generator=g))
                eng.submit(torch.randint(0, cfg.vocab_size, (plen,),
                                         generator=g).numpy(),
                           max_new_tokens=SERVE["max_new"])
            done = eng.run_to_completion()
            return eng, done, time.perf_counter() - t

        check(cfg.n_layers == n_layers, f"{arch} has {cfg.n_layers} layers")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = LM(cfg, device=DEVICE, seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        eng = Engine(cfg, model=model, max_batch=SERVE["max_batch"],
                     max_seq=max_seq)
        for k in (flash, scan, *others, *([step] if step else [])):
            k.launches = 0                                   # path starts
        flash.launches_by_path.update(tensor_core=0, cuda_core=0)
        first = next_span_index(spans)
        eng, done, wall = serve(eng, SERVE["requests"])
        torch.cuda.synchronize()
        launches = {"flash": flash.launches, "scan": scan.launches}
        step_launches = step.launches if step else None
        by_path = dict(flash.launches_by_path)
        stray = sum(k.launches for k in others)              # path ends
        check(len(done) == SERVE["requests"] and all(
            r.done and len(r.out_tokens) == SERVE["max_new"] for r in done),
            f"{arch}: not every request returned {SERVE['max_new']} tokens")
        want = {k: eng.waves * n for k, n in per_wave.items()}
        check(launches == want and stray == 0,
              f"{arch}: launches {launches} (others {stray}), want {want} "
              f"for {eng.waves} prefill waves of {per_wave}")
        # bf16 prefills run on the tensor cores, never the f32 kernel
        check(by_path == {"tensor_core": want["flash"], "cuda_core": 0},
              f"{arch}: flash launches by kernel {by_path}")
        tokens = sum(len(r.out_tokens) for r in done)
        pre_s, dec_s = eng.stats["prefill_s"], eng.stats["decode_s"]
        waves = eng.waves
        # falcon-mamba's decode step is one CUDA graph a batch size: the
        # first step captures it, every later one replays
        steps = decode_spans(spans, first)
        paths = [r.attrs["graph"] for r in steps]
        check(paths == graph_paths(model, len(dec_s)),
              f"{arch}: decode paths {paths}")
        if step:
            per = {"capture": 2, "replay": 0, "eager": 1}
            want_step = model.mamba1_layers * sum(per[p] for p in paths)
            check(step_launches == want_step,
                  f"{arch}: {step_launches} selective-state step launches, "
                  f"want {want_step} for {model.mamba1_layers} Mamba1 "
                  f"layers and decode paths {dict(Counter(paths))}")
            launches["mamba_step"] = step_launches
        capture_s = steps[0].seconds if paths[0] == "capture" else None
        graph = model.graphs_decode()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # the card's busy share over a second, profiled run of n_prof
        # requests; the device's activity alone is traced (the host's ops
        # would add as many events as the kernels, minutes to read back for
        # an MoE wave's ~10^5)
        eng2 = Engine(cfg, model=model, max_batch=SERVE["max_batch"],
                      max_seq=max_seq)
        t_prof = time.perf_counter()
        first = next_span_index(spans)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            serve(eng2, n_prof)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t1) * 1e3
        paths = [r.attrs["graph"] for r in decode_spans(spans, first)]
        check(paths == graph_paths(model, len(paths), captured=True),
              f"{arch}: profiled decode paths {paths}")
        evs = device_events(torch, prof)
        busy = sum(e.self_device_time_total for e in evs) / 1e3
        kern = sum(e.self_device_time_total for e in evs
                   if kernel_name and kernel_name in e.name) / 1e3
        by_name = {}
        for e in evs:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
        top = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                     reverse=True)
        n_evs = len(evs)
        del prof, evs
        profile_s = time.perf_counter() - t_prof

        # at full width: prefill(T-k) + k decode steps against the forward.
        # In bf16 over many random layers, two forwards of the same tokens
        # in matmuls of another shape already differ by more than the bf16
        # tolerances (forward_short_vs_long), so the check is asserted on
        # the same weights in f32, where only the paths' sum orders differ;
        # an MoE's f32 check is cut in depth and made drop-free (f32_cut)
        book = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        toks = torch.randint(0, cfg.vocab_size,
                             (2, opts.get("check_tokens", 32), *book),
                             device=DEVICE,
                             generator=torch.Generator(device=DEVICE)
                             .manual_seed(SEED + 9))
        t1 = time.perf_counter()
        bf16_errs = consistency(torch, model, toks, check_tol=False)
        mrope = (mrope_prefill(torch, model, flash, n_layers)
                 if opts.get("mrope_prefill") else None)
        bf16_check_s = time.perf_counter() - t1
        del model, eng, eng2
        torch.cuda.empty_cache()
        f32_cfg, cut_dtype = cfg, torch.bfloat16
        if f32_cut:
            f32_cfg = cfg.with_(n_layers=f32_cut[0])
            if f32_cut[1] is not None:
                f32_cfg = f32_cfg.with_(moe=dataclasses.replace(
                    cfg.moe, capacity_factor=f32_cut[1]))
                cut_dtype = torch.float32
        if opts.get("cut_f32"):
            cut_dtype = torch.float32
        t1 = time.perf_counter()
        model = LM(f32_cfg, dtype=torch.float32, device=DEVICE, seed=SEED)
        f32_errs = consistency(torch, model, toks, check_tol=True)
        check_s = time.perf_counter() - t1
        del model
        torch.cuda.empty_cache()

        # a 2-layer cut at full width: plain versions on the CPU against the
        # kernels on the card, from the same weights (an MoE's in f32 and
        # drop-free, where a bf16 rounding apart cannot flip its routing)
        cut = f32_cfg.with_(n_layers=opts.get("cut_layers", 2))
        t1 = time.perf_counter()
        on_card = LM(cut, dtype=cut_dtype, device=DEVICE, seed=SEED + 1)
        on_cpu = LM(cut, dtype=cut_dtype, device="cpu",
                    params=on_card.params("cpu"))
        lg_card, _ = on_card.prefill(toks, on_card.init_cache(2, 64))
        lg_cpu, _ = on_cpu.prefill(toks.cpu(), on_cpu.init_cache(2, 64))
        err_cut = allclose(torch, lg_card, lg_cpu, PREFILL_TOL,
                           "2-layer cut, card vs CPU")
        cut_s = time.perf_counter() - t1
        del on_card, on_cpu
        torch.cuda.empty_cache()

        out[arch] = {
            "layers": n_layers, "params": n_params, "init_s": init_s,
            "requests": len(done), "tokens": tokens, "waves": waves,
            "launches": launches, "flash_launches_by_path": by_path,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "prefill_ms_per_wave": [x * 1e3 for x in pre_s],
            "decode_ms_per_step": sum(dec_s) * 1e3 / len(dec_s),
            "decode_ms_per_token": sum(dec_s) * 1e3 / (tokens - len(done)),
            "decode_graph": graph,
            "decode_capture_s": capture_s,
            "peak_memory_gb": peak_gb, "profiled_requests": n_prof,
            "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
            "device_busy_share": busy / prof_wall, "device_launches": n_evs,
            "kernel_ms": kern, "kernel_share_of_busy": kern / busy if busy
            else None,
            "top_device_ops_ms_count": [[ms, n, k[:80]] for ms, n, k in
                                        top[:10]],
            "consistency_max_err": {"f32": f32_errs, "bf16": bf16_errs},
            "f32_check_layers": f32_cfg.n_layers, "f32_check_s": check_s,
            "profile_s": profile_s, "bf16_check_s": bf16_check_s,
            "cut_s": cut_s,
            "cut_layers": cut.n_layers,
            "cut_2_layers_cpu_vs_card_max_err": err_cut,
            "cut_2_layers_dtype": str(cut_dtype)[6:],
            "check_tokens": toks.shape[1], "max_seq": max_seq}
        if mrope is not None:
            out[arch]["mrope_prefill"] = mrope
        log(f"[{label}] serve {arch}: " + json.dumps(out[arch]))
    return out


# ------------------------------------------------------------ training (4th)
# (label, B, T, H, Hkv, hd, window): smollm-135m's training batch, one
# 2048-token sequence at qwen3-14b's heads, qwen3-moe-30b-a3b's training
# batch (phase 13: a GQA group of 8 at hd 128), and gemma3-27b's local
# layers at 2 x 2048 tokens, where the 1024-token window masks; phase 17's
# quickstart batch (8 x 128 at smollm-135m's heads) and the replication
# example's smoke batch (4 x 128 at hd 32)
TRAIN_ATTN_CASES = [("smollm_train", 8, 1024, 9, 3, 64, None),
                    ("qwen3_14b_train", 1, 2048, 40, 8, 128, None),
                    ("qwen3_moe_train", 4, 1024, 32, 4, 128, None),
                    ("gemma3_train", 2, 2048, 32, 16, 128, 1024),
                    ("example_quickstart", 8, 128, 9, 3, 64, None),
                    ("example_replication", 4, 128, 4, 1, 32, None)]
# falcon-mamba-7b's width: (B, T, D, N)
TRAIN_SCAN_CASE = ("falcon_mamba_train", 2, 512, 8192, 16)
# the Functions' gradients against the all-eager computation's: the largest
# difference over the largest eager gradient, input by input
GRAD_REL_TOL = 1e-3
# the main path: smollm-135m at its published width and depth, one injected
# failure and restart, checkpoints on POD0 replicated to POD1 and STORE
TRAIN = dict(steps=12, batch_size=8, seq_len=1024, ckpt_every=6,
             fail_at_step=9, peak_lr=1e-3, warmup=4, remat=True,
             microbatches=1, log_every=1)
TRAIN_REPLICAS = ("POD1", "STORE")
# three sites of two ~1.9 GB checkpoints each, and the one being written
TRAIN_DISK_BYTES = 14 * GiB
TRAIN_SERVE = dict(requests=4, max_new=8, max_batch=4, max_seq=256)
# falcon-mamba-7b at full width; 64 layers with f32 AdamW state need ~117 GB
MAMBA_TRAIN_LAYERS = 4
MAMBA_TRAIN = dict(steps=3, batch_size=2, seq_len=512, peak_lr=1e-3,
                   warmup=1, remat=False, microbatches=1, log_every=1)
MAMBA_CUTS = ("falcon-mamba-7b layers 64 -> 4: 64 layers with f32 AdamW "
              "state need ~117 GB of the card's 80")


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def grads_of(torch, fn, ins, weights):
    """(outputs, gradients of sum(output * weight) for every input)."""
    ins = [x.detach().requires_grad_(True) for x in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    return [o.detach() for o in outs], torch.autograd.grad(total, ins)


def phase_train_grads(torch, flash, fops, flash_ref, scan, sops,
                      scan_ref) -> dict:
    """The kernels' autograd Functions on the card: forward against the
    plain version, gradients against the all-eager computation's."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    out = {}
    for label, B, T, H, Hkv, hd, window in TRAIN_ATTN_CASES:
        q = torch.randn(B, T, H, hd, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, T, Hkv, hd, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        w = [torch.randn(B, T, H, hd, generator=gen, device=dev)]
        before = flash.launches
        fn = lambda *x: fops.flash_attention(*x, window)      # noqa: E731
        (got,), g_fn = grads_of(torch, fn, (q, k, v), w)
        check(flash.launches == before + 1,
              f"train grads {label}: the Function launched "
              f"{flash.launches - before} kernels, not 1")
        eager_fn = lambda *x: flash_ref.attention_torch(      # noqa: E731
            *x, window)
        (eager,), g_eager = grads_of(torch, eager_fn, (q, k, v), w)
        tol = ATTN_TOL["bfloat16"]
        fwd_err = (got.float() - eager.float()).abs().max().item()
        check(torch.allclose(got.float(), eager.float(), atol=tol, rtol=tol),
              f"train grads {label}: forward err {fwd_err} beyond {tol}")
        errs = {n: rel_err(torch, a, b)
                for n, a, b in zip("qkv", g_fn, g_eager)}
        check(max(errs.values()) <= GRAD_REL_TOL,
              f"train grads {label}: gradients {errs} beyond {GRAD_REL_TOL}")
        it = 5
        out[label] = {
            "shape": [B, T, H, Hkv, hd], "window": window,
            "forward_max_abs_err": fwd_err, "grad_rel_err": errs,
            "function_fwd_bwd_ms": host_ms(torch, lambda: grads_of(
                torch, fn, (q, k, v), w), it),
            "eager_fwd_bwd_ms": host_ms(torch, lambda: grads_of(
                torch, eager_fn, (q, k, v), w), it)}
        log(f"[10] grads {label}: " + json.dumps(out[label]))
    label, B, T, D, N = TRAIN_SCAN_CASE
    ins = scan_inputs(torch, gen, B, T, D, N, model=True)
    w = [torch.randn(B, T, D, generator=gen, device=dev),
         torch.randn(B, D, N, generator=gen, device=dev)]
    before = scan.launches
    got, g_fn = grads_of(torch, sops.selective_scan, ins, w)
    check(scan.launches == before + 1,
          f"train grads {label}: the Function launched "
          f"{scan.launches - before} kernels, not 1")
    eager, g_eager = grads_of(torch, scan_ref.selective_scan_torch, ins, w)
    fwd_err = max((a - b).abs().max().item() for a, b in zip(got, eager))
    check(all(torch.allclose(a, b, **SCAN_TOL) for a, b in zip(got, eager)),
          f"train grads {label}: forward err {fwd_err} beyond {SCAN_TOL}")
    errs = {n: rel_err(torch, a, b) for n, a, b in
            zip(("u", "dt", "Bm", "Cm", "A", "h0"), g_fn, g_eager)}
    check(max(errs.values()) <= GRAD_REL_TOL,
          f"train grads {label}: gradients {errs} beyond {GRAD_REL_TOL}")
    out[label] = {
        "shape": [B, T, D, N], "forward_max_abs_err": fwd_err,
        "grad_rel_err": errs,
        "function_fwd_bwd_ms": host_ms(torch, lambda: grads_of(
            torch, sops.selective_scan, ins, w), 2, warmup=1),
        "eager_fwd_bwd_ms": host_ms(torch, lambda: grads_of(
            torch, scan_ref.selective_scan_torch, ins, w), 2, warmup=1)}
    log(f"[10] grads {label}: " + json.dumps(out[label]))
    return out


def hash_launches(size: int, chunk: int) -> int:
    """Launches of the hash kernel for a file of ``size`` bytes streamed in
    ``chunk``-byte reads: one a read that holds a whole word, and one for
    a last partial word (``StreamingChecksum``)."""
    full, rest = divmod(size, chunk)
    return full + (rest >= 4) + (size % 4 != 0)


def ckpt_hash_launches(d: str, chunk: int) -> dict:
    """The hash launches one checkpoint directory costs: its MANIFEST scan
    (every file but MANIFEST.json and COMMITTED; a restore's verify reads
    the same files), and one copy of the whole directory (source stream
    and destination re-read)."""
    sizes = {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)}
    scan = sum(hash_launches(s, chunk) for f, s in sizes.items()
               if f not in ("MANIFEST.json", "COMMITTED"))
    copy = 2 * sum(hash_launches(s, chunk) for s in sizes.values())
    return {"scan": scan, "copy": copy, "bytes": sum(sizes.values())}


def train_dir(need: int) -> str:
    """A temporary directory on the roomier of the temp and build
    filesystems, or a failure that says how much is free."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    roots = [tempfile.gettempdir(), str(build)]
    free = {r: shutil.disk_usage(r).free for r in roots}
    best = max(roots, key=free.get)
    check(free[best] >= need,
          f"training needs {need / GiB:.0f} GiB free for three sites of "
          f"checkpoints; free: " + ", ".join(
              f"{r} {f / GiB:.1f} GiB" for r, f in free.items()))
    return tempfile.mkdtemp(prefix="repro_torch_train_", dir=best)


def phase_train(torch, get_config, LM, Engine, launch_serve, loop, adamw,
                CheckpointReplicator, chunk_bytes: int, kernel, lane_kernel,
                flash, scan) -> dict:
    """The fourth main path: smollm-135m trained at full width and depth
    with one injected failure, checkpoints hashed on the card and
    replicated to two sites, the primary lost, and a verified restore from
    POD1 that serves the same tokens; then falcon-mamba-7b at full width,
    cut in depth.  Every count is set to 0 just before each run and read
    just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.tree import leaves, unflatten
    kernels = (kernel, lane_kernel, flash, scan)
    cfg = get_config("smollm-135m")
    check(cfg.n_layers == 30, f"smollm-135m has {cfg.n_layers} layers")
    tmp = train_dir(TRAIN_DISK_BYTES)
    walls = {"save_s": [], "replicate_s": [], "restore_s": []}
    saved = {}
    save, restore = loop.save_checkpoint, loop.restore_checkpoint

    def timed_save(*args, **kw):
        t = time.perf_counter()
        d = save(*args, **kw)
        walls["save_s"].append(time.perf_counter() - t)
        saved["tree"] = args[2]          # the params and state in memory
        return d

    def timed_restore(*args, **kw):
        t = time.perf_counter()
        got = restore(*args, **kw)
        walls["restore_s"].append(time.perf_counter() - t)
        return got

    try:
        rep = CheckpointReplicator(tmp, primary="POD0",
                                   replicas=TRAIN_REPLICAS, device=DEVICE)
        replicate = rep.replicate

        def timed_replicate(rel):
            t = time.perf_counter()
            ok = replicate(rel)
            walls["replicate_s"].append(time.perf_counter() - t)
            check(ok, f"replication of {rel} did not verify everywhere")
            return ok

        rep.replicate = timed_replicate
        loop.save_checkpoint, loop.restore_checkpoint = (timed_save,
                                                         timed_restore)
        ckpt_dir = os.path.join(rep.site_dir("POD0"), "ckpts")
        tc = loop.TrainConfig(ckpt_dir=ckpt_dir, replicator=rep,
                              device=DEVICE, seed=SEED, **TRAIN)
        for k in kernels:
            k.launches = 0                                   # path starts
        flash.launches_by_path.update(tensor_core=0, cuda_core=0)
        t0 = time.perf_counter()
        res = loop.train(cfg, tc)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        shutil.rmtree(ckpt_dir)                              # POD0 is lost
        t1 = time.perf_counter()
        got = rep.restore_anywhere("ckpts", saved["tree"])
        restore_s = time.perf_counter() - t1
        launches = {"checksum": kernel.launches,
                    "lane_step": lane_kernel.launches,
                    "flash": flash.launches, "scan": scan.launches}
        by_path = dict(flash.launches_by_path)               # path ends
        loop.save_checkpoint, loop.restore_checkpoint = save, restore

        check(got is not None, "no checkpoint restored after losing POD0")
        step, tree, d, site = got
        check(site == "POD1" and step == TRAIN["steps"],
              f"restored step {step} from {site}, want step "
              f"{TRAIN['steps']} from POD1")
        for a, b in zip(leaves(tree), leaves(saved["tree"])):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  "the restored checkpoint differs from the state in memory")
        check(res.restarts == 1 and res.final_step == TRAIN["steps"],
              f"restarts {res.restarts}, final step {res.final_step}")
        losses = res.losses
        executed = len(losses)
        # steps 0..fail-1, then the steps from the last checkpoint on
        last_ckpt = TRAIN["fail_at_step"] // TRAIN["ckpt_every"] * TRAIN[
            "ckpt_every"]
        check(executed == TRAIN["fail_at_step"] + TRAIN["steps"] - last_ckpt,
              f"{executed} steps executed")
        check(all(x == x and abs(x) < float("inf") for x in losses),
              f"losses not finite: {losses}")
        first, last = (sum(losses[:3]) / 3, sum(losses[-3:]) / 3)
        check(last < first, f"loss did not fall: {first} -> {last}")

        # the hash: every file scanned at a save, copied to each replica
        # (source stream and destination re-read), and verified at the
        # restart's restore and at the last restore (the POD1 copies)
        pod1 = os.path.join(rep.site_dir("POD1"), "ckpts")
        per = {s: ckpt_hash_launches(os.path.join(pod1, f"step-{s:06d}"),
                                     chunk_bytes)
               for s in (last_ckpt, TRAIN["steps"])}
        want_hash = sum(p["scan"] + len(TRAIN_REPLICAS) * p["copy"]
                        for p in per.values()) + sum(
            per[s]["scan"] for s in (last_ckpt, TRAIN["steps"]))
        remat = 1 + int(TRAIN["remat"])
        want = {"checksum": want_hash, "lane_step": 0, "scan": 0,
                "flash": cfg.n_layers * executed * remat
                * TRAIN["microbatches"]}
        check(launches == want,
              f"training launches {launches}, want {want} ({executed} "
              f"steps x {cfg.n_layers} layers x {remat} forwards)")
        check(by_path == {"tensor_core": want["flash"], "cuda_core": 0},
              f"training flash launches by kernel {by_path}")

        # the restored params serve the tokens of the params in memory
        tokens = []
        for params in (tree["params"], saved["tree"]["params"]):
            eng = Engine(cfg, model=LM(cfg, device=DEVICE, params=params),
                         max_batch=TRAIN_SERVE["max_batch"],
                         max_seq=TRAIN_SERVE["max_seq"])
            _, done, _ = launch_serve.serve(
                cfg, TRAIN_SERVE["requests"], TRAIN_SERVE["max_new"],
                engine=eng, seed=SEED)
            tokens.append([r.out_tokens for r in
                           sorted(done, key=lambda r: r.rid)])
        check(tokens[0] == tokens[1],
              "the restored checkpoint serves other tokens")

        ckpt_bytes = per[TRAIN["steps"]]["bytes"]
        gbps = lambda n, s: [n / x / 1e9 for x in s]         # noqa: E731
        out = {
            "config": "smollm-135m, 30 layers, d 576, 9/3 heads, bf16, "
                      "AdamW", **TRAIN, "replicas": list(TRAIN_REPLICAS),
            "executed_steps": executed, "restarts": res.restarts,
            "restored_from_site": site, "restored_step": step,
            "losses": losses, "launches": launches,
            "flash_launches_by_path": by_path,
            "hash_launches_per_checkpoint": per,
            "train_wall_s": train_s, "loop_wall_s": res.wall_s,
            "checkpoint_bytes": ckpt_bytes,
            "save_s": walls["save_s"],
            "save_gb_per_s": gbps(ckpt_bytes, walls["save_s"]),
            "replicate_s": walls["replicate_s"],
            "replicate_gb_per_s": gbps(ckpt_bytes * len(TRAIN_REPLICAS),
                                       walls["replicate_s"]),
            "restart_restore_s": walls["restore_s"],
            "final_restore_s": restore_s,
            "final_restore_gb_per_s": ckpt_bytes / restore_s / 1e9,
            "serve_tokens_equal": True}
    finally:
        loop.save_checkpoint, loop.restore_checkpoint = save, restore
        shutil.rmtree(tmp, ignore_errors=True)

    # steady-state steps of the restored model, then one profiled step
    model = LM(cfg, device=DEVICE, params=tree["params"],
               remat=TRAIN["remat"])
    model.requires_grad_(True)
    state = tree["opt"]
    step_fn = loop.make_train_step(model, adamw.AdamWConfig(), tc)
    data = loop.for_model(cfg, TRAIN["batch_size"], TRAIN["seq_len"], SEED)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch_at(TRAIN["steps"]).items()}

    def one_step():
        nonlocal state
        _, state, loss, _ = step_fn(state, batch)
        return float(loss)

    one_step()
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        one_step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    busy = device_busy_ms(torch, prof)
    kern = sum(a.self_device_time_total for a in prof.key_averages()
               if "flash_fwd_wgmma_kernel" in a.key) / 1e3
    # the kernels the Function's backward launches, through its range
    eager_bwd = sum(e.device_time_total for e in prof.events()
                    if e.name == "flash_attention_eager_backward"
                    and e.device_type == DeviceType.CPU) / 1e3
    by_name = {}
    for e in device_events(torch, prof):
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
    top = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                 reverse=True)
    # the step's two halves apart: forward and backward, then AdamW
    params = model.parameter_tree()

    def fwd_bwd():
        loss, _ = model.loss_fn(batch)
        return torch.autograd.grad(loss, leaves(params))

    grads = unflatten(params, list(fwd_bwd()))
    lr = torch.tensor(TRAIN["peak_lr"], device=DEVICE)
    fwd_bwd_ms = host_ms(torch, fwd_bwd, 3, warmup=1)
    update_ms = host_ms(torch, lambda: adamw.update(grads, state, lr), 3,
                        warmup=1)
    tokens_per_step = TRAIN["batch_size"] * TRAIN["seq_len"]
    out.update({
        "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_step / step_s,
        "profiled_step_wall_ms": prof_wall, "device_busy_ms": busy,
        "device_busy_share": busy / prof_wall,
        "device_busy_over_step_ms": busy / (step_s * 1e3),
        "device_launches_per_step": sum(n for _, n, _ in top),
        "fwd_bwd_ms": fwd_bwd_ms, "adamw_update_ms": update_ms,
        "top_device_ops_ms_count": [[ms, n, k[:80]] for ms, n, k in
                                    top[:12]],
        "flash_kernel_ms": kern,
        "flash_kernel_share_of_busy": kern / busy if busy else None,
        "eager_backward_ms": eager_bwd,
        "eager_backward_share_of_busy": eager_bwd / busy if busy else None})
    log("[10] train smollm-135m: " + json.dumps(out))
    del model, state, step_fn, tree, saved, batch, grads
    torch.cuda.empty_cache()

    # falcon-mamba-7b at full width, cut in depth
    mcfg = get_config("falcon-mamba-7b").with_(n_layers=MAMBA_TRAIN_LAYERS)
    log(f"[10] reduced: {MAMBA_CUTS}")
    for k in kernels:
        k.launches = 0                                       # path starts
    t0 = time.perf_counter()
    mres = loop.train(mcfg, loop.TrainConfig(device=DEVICE, seed=SEED,
                                             **MAMBA_TRAIN))
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    mlaunches = {"checksum": kernel.launches,
                 "lane_step": lane_kernel.launches,
                 "flash": flash.launches, "scan": scan.launches}  # path ends
    mwant = {"checksum": 0, "lane_step": 0, "flash": 0,
             "scan": MAMBA_TRAIN_LAYERS * len(mres.losses)
             * (1 + int(MAMBA_TRAIN["remat"])) * MAMBA_TRAIN["microbatches"]}
    check(len(mres.losses) == MAMBA_TRAIN["steps"]
          and mres.final_step == MAMBA_TRAIN["steps"],
          f"falcon-mamba-7b ran {len(mres.losses)} steps")
    check(mlaunches == mwant,
          f"falcon-mamba-7b training launches {mlaunches}, want {mwant}")
    check(all(x == x and abs(x) < float("inf") for x in mres.losses),
          f"falcon-mamba-7b losses not finite: {mres.losses}")
    mamba = {"config": f"falcon-mamba-7b at d 4096, N 16, "
                       f"{MAMBA_TRAIN_LAYERS} of 64 layers, bf16, AdamW",
             "reduced": MAMBA_CUTS, **MAMBA_TRAIN, "losses": mres.losses,
             "launches": mlaunches, "wall_s": mwall,
             "loop_wall_s": mres.wall_s}
    log("[10] train falcon-mamba-7b: " + json.dumps(mamba))
    torch.cuda.empty_cache()
    return {"smollm-135m": out, "falcon-mamba-7b": mamba}


# ------------------------------------------------------- the CLI (host only)
# the JAX package's `python -m repro.scenarios.run --scenario paper-2022` at
# BENCH_scenarios.json's engine_comparison shape (n=48, scale 1.0, seed 0);
# this script cannot import it
CLI_ARGS = ["--scenario", "paper-2022", "--datasets", "48", "--scale", "1.0",
            "--seed", "0"]
CLI_WANT = {"iterations": 474, "duration_days": 105.613, "faults_total": 703}
CLI_KILL_AFTER = 200
CLI_SWEEP = ["--scenarios", "paper-2022,fault-storm", "--seeds", "0,1",
             "--datasets", "40", "--scale", "0.02", "--processes", "2"]


def phase_cli(cli, sweep, report) -> dict:
    """The replication CLI as an operator runs it: the paper's campaign to
    the reference's numbers, killed at an iteration and resumed to the same
    trajectory, its flight recorder rendered by the post-mortem report, and
    a two-scenario sweep; each run's report goes to a file, not stdout."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_cli_")
    walls = {}

    def run(label, argv, want_rc=0):
        path = os.path.join(tmp, f"{label}.json")
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv + ["--json", path])
        walls[label] = time.perf_counter() - t
        check(rc == want_rc, f"cli {label}: exit {rc}, want {want_rc}")
        with open(path) as f:
            return json.load(f)

    try:
        whole = run("paper_2022", CLI_ARGS)
        traj = whole["trajectory"]
        got = {"iterations": traj["iterations"],
               "duration_days": whole["duration_days"],
               "faults_total": whole["faults_total"]}
        check(got == CLI_WANT, f"cli paper-2022 {got} != {CLI_WANT}")
        ck = os.path.join(tmp, "ck")
        killed = run("kill", CLI_ARGS + ["--kill-after", str(CLI_KILL_AFTER),
                                         "--checkpoint-dir", ck],
                     want_rc=cli.EXIT_KILLED)
        check(killed["killed"] and killed["iterations"] == CLI_KILL_AFTER
              and killed["resume_with"].startswith(
                  "python -m repro_torch.scenarios.run --resume"),
              f"cli kill: {killed}")
        resumed = run("resume", ["--resume", ck])
        check(resumed["trajectory"] == traj,
              "cli resume ended on another trajectory: "
              f"{resumed['trajectory']} != {traj}")
        stream = os.path.join(tmp, "run.ndjson")
        observed = run("obs", CLI_ARGS + ["--obs", stream])
        check(observed["trajectory"] == traj,
              "cli --obs changed the trajectory")
        t = time.perf_counter()
        text = report.render(report.load_stream(stream))
        walls["report"] = time.perf_counter() - t
        check("records:" in text and "paper-2022" in text,
              "the obs report is empty")
        out = os.path.join(tmp, "sweep.json")
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            sweep.main(CLI_SWEEP + ["--out", out])
        walls["sweep"] = time.perf_counter() - t
        with open(out) as f:
            rows = json.load(f)["sweep"]
        check(len(rows) == 4 and all(r["complete"] or r["quarantined"]
                                     for r in rows),
              f"sweep rows: {[r['variant'] for r in rows]}")
        res = {"trajectory": traj, **got, "killed_at": killed["iterations"],
               "resumed_digest_equal": True,
               "report_lines": len(text.splitlines()),
               "sweep_variants": [r["variant"] for r in rows],
               "sweep_duration_days": [r["duration_days"] for r in rows],
               "wall_s": walls}
        log("[11] cli: " + json.dumps(res))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------- MoE training
# full width, cut in depth to what bf16 params, their bf16 gradients and f32
# AdamW state (master, m, v: 12 bytes a parameter) leave room for
MOE_TRAIN = dict(steps=3, batch_size=4, seq_len=1024, peak_lr=1e-3, warmup=1,
                 remat=True, log_every=1)
# (arch, layers (None: all), the training run's TrainConfig fields, whether
# its last step's checkpoint is saved, hashed, restored and held to the
# state in memory, B3 calls a forward, free disk the checkpoint needs)
MOE_TRAIN_ARCHS = (("qwen3-moe-30b-a3b", 4, MOE_TRAIN, False, 4, 0),
                   ("deepseek-v2-lite-16b", 2, MOE_TRAIN, True, 0,
                    20 * GiB))
MOE_TRAIN_CUTS = ("qwen3-moe-30b-a3b layers 48 -> 4 (3.1 G parameters: bf16 "
                  "params and grads and f32 AdamW state ~56 GB; 48 layers "
                  "need ~490 GB); deepseek-v2-lite-16b layers 27 -> 2, the "
                  "dense lead layer and one MoE layer, so that its one "
                  "checkpoint (params and AdamW state) is ~15 GB on disk "
                  "(4 layers: 31.6 GB, whose save and restore through B1 "
                  "took 101 of the phase's 124 s)")
# The last four families (phase 15).  gemma3-27b: one local/global group
# (6 layers) of 62 at 1 x 2048 tokens, where the window masks: its tied
# 262144 x 5376 embedding alone is 1.4 G parameters (22 GB with its grads
# and AdamW state), and 6 layers bring it to 3.9 G (62 GB, 70 GB with the
# new bf16 params), so a second sequence's f32 logits (4.3 GB a copy) do
# not fit.  qwen2-vl-7b: 8 of 28 layers on the frontend's embeddings with
# M-RoPE ids (2.95 G parameters, 47 GB).  zamba2-1.2b at two groups of six
# and one tail layer (13 of 38: the least depth with two-level banks, the
# shared block and a tail); its checkpoint is saved, hashed, restored and
# held to memory.  musicgen-large at full depth.
FAMILY_TRAIN = dict(steps=3, batch_size=4, seq_len=1024, peak_lr=1e-3,
                    warmup=1, remat=True, log_every=1)
FAMILY_TRAIN_ARCHS = (
    ("gemma3-27b", 6, dict(FAMILY_TRAIN, batch_size=1, seq_len=2048), False,
     6, 0),
    ("zamba2-1.2b", 13, FAMILY_TRAIN, True, 2, 10 * GiB),
    ("qwen2-vl-7b", 8, FAMILY_TRAIN, False, 8, 0),
    ("musicgen-large", None, FAMILY_TRAIN, False, 48, 0))
FAMILY_TRAIN_CUTS = ("gemma3-27b layers 62 -> 6 (one local/global group; "
                     "3.9 G parameters, ~70 GB with grads, AdamW state and "
                     "the new params) and batch 2 -> 1 of 2048 tokens (a "
                     "second sequence's f32 logits do not fit); qwen2-vl-7b "
                     "layers 28 -> 8 (2.95 G parameters, ~47 GB); zamba2-1.2b "
                     "layers 38 -> 13 (two groups and a tail layer; its "
                     "checkpoint ~7 GB, not 16.4 GB, whose save and restore "
                     "took 46 s, and its eager steps a third); "
                     "musicgen-large at full depth")


def check_restored_tree(torch, tree, cfg) -> dict:
    """The pattern-specific shape of a restored training tree: the MoE
    router's AdamW state f32 and the lead blocks a list; a hybrid's groups a
    list of lists, its shared block one mapping."""
    params, opt = tree["params"], tree["opt"]
    out = {}
    if cfg.moe is not None:
        routers = [b["moe"]["router"] for part in (opt.master, opt.m, opt.v)
                   for b in part["blocks"]]
        check(len(routers) == 3 * len(params["blocks"]) and all(
            r.dtype == torch.float32 for r in routers),
            f"{cfg.name}: the router's AdamW state is not f32")
        check(isinstance(params["lead"], list)
              and len(params["lead"]) == cfg.moe.first_dense_layers,
              f"{cfg.name}: the lead blocks did not restore as a list")
        out["router_state_f32"] = True
    if cfg.hybrid is not None:
        e = cfg.hybrid.shared_attn_every
        g, n_tail = divmod(cfg.n_layers, e)
        check(len(params["groups"]) == g and all(
            isinstance(x, list) and len(x) == e for x in params["groups"])
            and "attn" in params["shared"]
            and len(params["tail"] or []) == n_tail,
            f"{cfg.name}: the restored hybrid tree has another layout")
        out["hybrid_layout"] = f"{g} groups of {e}, shared, tail {n_tail}"
    return out


def phase_train_archs(torch, get_config, LM, loop, adamw, kernels, flash,
                      checksum, chunk_bytes: int, specs, label: int,
                      cuts: str) -> dict:
    """Training through ``train.loop.train`` of each spec's model at full
    width, cut in depth where memory forces it: B3 in every attention
    forward (twice with remat), a finite loss (and a positive MoE ``aux``);
    where the spec says so, the last step's checkpoint hashed by B1 at its
    save and its restore, restored and held to the state in memory.  Every
    count is set to 0 just before each run and read just after; then a
    steady-state step of a fresh model, and its halves apart."""
    from repro_torch.tree import leaves, unflatten
    log(f"[{label}] reduced: {cuts}")
    out = {}
    for arch, n_layers, train, ckpt, calls, disk in specs:
        cfg = get_config(arch)
        if n_layers:
            cfg = cfg.with_(n_layers=n_layers)
        tokens_per_step = train["batch_size"] * train["seq_len"]
        tmp = train_dir(disk) if ckpt else None
        saved = {}
        save = loop.save_checkpoint

        def kept_save(*args, **kw):
            t = time.perf_counter()
            d = save(*args, **kw)
            saved.update(tree=args[2], dir=d, save_s=time.perf_counter() - t)
            return d

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tc = loop.TrainConfig(device=DEVICE, seed=SEED,
                              ckpt_dir=tmp and os.path.join(tmp, "ckpts"),
                              ckpt_every=train["steps"], **train)
        try:
            loop.save_checkpoint = kept_save
            for k in kernels:
                k.launches = 0                               # path starts
            flash.launches_by_path.update(tensor_core=0, cuda_core=0)
            t0 = time.perf_counter()
            res = loop.train(cfg, tc)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.__name__.rsplit(".", 1)[-1]: k.launches
                        for k in kernels}
            by_path = dict(flash.launches_by_path)           # path ends
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            check(len(res.losses) == train["steps"] and all(
                x == x and abs(x) < float("inf") for x in res.losses + res.aux)
                and (cfg.moe is None or all(a > 0 for a in res.aux)),
                f"{arch}: losses {res.losses}, aux {res.aux}")
            remat = 1 + int(train["remat"])
            want_flash = calls * train["steps"] * remat
            entry = {"config": f"{arch} at d {cfg.d_model}, {cfg.n_layers} "
                               f"of {get_config(arch).n_layers} layers, "
                               f"bf16, AdamW", **train,
                     "losses": res.losses, "aux": res.aux,
                     "launches": launches, "flash_launches_by_path": by_path,
                     "wall_s": wall, "loop_wall_s": res.wall_s,
                     "peak_memory_gb": peak_gb}
            want_hash = 0
            if ckpt:
                loop.save_checkpoint = save
                d = saved["dir"]
                per = ckpt_hash_launches(d, chunk_bytes)
                want_hash = per["scan"]
                checksum.launches = 0
                t = time.perf_counter()
                got = loop.restore_checkpoint(tc.ckpt_dir, saved["tree"],
                                              device=DEVICE)
                restore_s = time.perf_counter() - t
                check(got is not None and got[0] == train["steps"],
                      f"{arch}: no checkpoint restored")
                tree = got[1]
                for a, b in zip(leaves(tree), leaves(saved["tree"])):
                    check(a.dtype == b.dtype and torch.equal(a, b),
                          f"{arch}: the restored checkpoint differs from "
                          f"the state in memory")
                entry.update(check_restored_tree(torch, tree, cfg))
                check(checksum.launches == per["scan"],
                      f"{arch}: restore hashed {checksum.launches}, want "
                      f"{per['scan']}")
                entry.update(checkpoint_bytes=per["bytes"],
                             save_s=saved["save_s"], restore_s=restore_s,
                             save_gb_per_s=per["bytes"] / saved["save_s"] / 1e9,
                             restore_gb_per_s=per["bytes"] / restore_s / 1e9,
                             restored_equal=True)
                del tree, got
            want = {"checksum": want_hash, "lane_step": 0, "mamba_scan": 0,
                    "flash_attention": want_flash}
            check(launches == want,
                  f"{arch}: training launches {launches}, want {want}")
            check(by_path == {"tensor_core": want_flash, "cuda_core": 0},
                  f"{arch}: flash launches by kernel {by_path}")
        finally:
            loop.save_checkpoint = save
            saved.clear()
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

        # a steady-state step of a fresh model, then its halves apart
        torch.cuda.reset_peak_memory_stats()
        t_steady = time.perf_counter()
        model = LM(cfg, device=DEVICE, seed=SEED, remat=True)
        model.requires_grad_(True)
        state = adamw.init(model.params())
        step_fn = loop.make_train_step(model, adamw.AdamWConfig(), tc)
        data = loop.for_model(cfg, train["batch_size"], train["seq_len"],
                              SEED)
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in data.batch_at(0).items()}

        def one_step():
            nonlocal state
            _, state, loss, _ = step_fn(state, batch)
            return loss

        step_ms = host_ms(torch, one_step, 2, warmup=1)
        params = model.parameter_tree()

        def fwd_bwd():
            loss, _ = model.loss_fn(batch)
            return torch.autograd.grad(loss, leaves(params),
                                       allow_unused=True,
                                       materialize_grads=True)

        fwd_bwd_ms = host_ms(torch, fwd_bwd, 1, warmup=0)
        grads = unflatten(params, list(fwd_bwd()))
        lr = torch.tensor(train["peak_lr"], device=DEVICE)
        update_ms = host_ms(torch, lambda: adamw.update(grads, state, lr), 1,
                            warmup=0)
        entry.update(step_ms=step_ms,
                     tokens_per_s=tokens_per_step / step_ms * 1e3,
                     fwd_bwd_ms=fwd_bwd_ms, adamw_update_ms=update_ms,
                     steady_peak_memory_gb=torch.cuda.max_memory_allocated()
                     / 1e9, steady_s=time.perf_counter() - t_steady)
        del model, state, step_fn, batch, grads, params
        torch.cuda.empty_cache()
        out[arch] = entry
        log(f"[{label}] train {arch}: " + json.dumps(entry))
    return out


# ---------------------------------------------------------------- phase 16
SHARDED_MESH = {"data": 1, "model": 1}
SHARDED_PREFILL = (4, 256)                     # sequences, tokens
SHARDED_ARCHS = (("smollm-135m", 0, "flash", 30),
                 ("falcon-mamba-7b", MAMBA_TRAIN_LAYERS, "scan", 4))
SHARDED_TRAIN = dict(steps=2, batch=2, seq=1024)
SHARDED_BUDGET_S = 90.0
DRYRUN_CELL = ["--arch", "smollm-135m", "--shape", "train_4k",
               "--mesh", "data=8,model=8", "--microbatches", "2"]


def phase_sharded(torch, get_config, LM, kernels, checksum, flash, scan,
                  chunk_bytes: int, card: str) -> dict:
    """The sharded path on a world-size-1 NCCL group and a 1x1 ("data",
    "model") mesh on the card: the relay and compressed collectives; the
    sharded prefill of smollm-135m (all 30 layers) and falcon-mamba-7b (4)
    through ``build_prefill_step`` with B3 / B4 launched on the local
    shards, bit-equal to the unsharded prefill; two sharded ``build_train_step``
    steps of smollm-135m with ZeRO-1 state, held to two unsharded steps;
    an elastic restore hashed by B1 and placed by ``load_for_mesh``; and
    the dry run of one full-size cell on a fake 8 x 8 mesh, in a
    subprocess."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint.ckpt import restore_checkpoint, \
        save_checkpoint
    from repro_torch.checkpoint.elastic import load_for_mesh
    from repro_torch.core import relay_collectives as RC
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import axes as AX
    from repro_torch.models.axes import logical_axis_rules
    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compress as GC
    from repro_torch.tree import leaves, tree_map

    tmp = tempfile.mkdtemp(prefix="repro_torch_sharded_")
    # NCCL or nothing: a failed init raises, and nothing runs on gloo
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            device_id=torch.device(DEVICE, 0))
    out = {"card": card, "mesh": SHARDED_MESH, "backend": dist.get_backend()}
    try:
        check(out["backend"] == "nccl", f"backend {out['backend']}")
        mesh = make_mesh(SHARDED_MESH, DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)

        def place(x, *spec):
            return distribute_tensor(x, mesh, AX.placements(AX.Spec(*spec),
                                                            mesh))

        # -- the collectives: at size 1 relay, naive and ring return x
        x = torch.randn((64, 1024), generator=gen, device=DEVICE)
        for name, fn in (
                ("relay", lambda: RC.relay_broadcast_inner(x, None, 0, 4)),
                ("relay_mesh", lambda: RC.relay_broadcast(x, mesh, "data")),
                ("naive", lambda: RC.naive_broadcast_inner(x)),
                ("ring", lambda: RC.ring_all_gather_inner(x))):
            check(fn() is x, f"[16] {name} at size 1 did not return x")
        gathered, real = [], dist.all_gather_into_tensor

        def counting(out_t, in_t, *a, **kw):
            gathered.append(str(in_t.dtype))
            return real(out_t, in_t, *a, **kw)
        dist.all_gather_into_tensor = counting
        try:
            got = GC.psum_compressed(x)
        finally:
            dist.all_gather_into_tensor = real
        q, s = GC.quantize_int8(x)
        check(gathered == ["torch.int8", "torch.float32"],
              f"[16] psum_compressed gathered {gathered}")
        check(torch.equal(got, GC.dequantize_int8(q, s)),
              "[16] psum_compressed != dequantize(quantize(x))")
        out["collectives"] = {"relay_naive_ring": "x at size 1",
                              "psum_compressed_gathers": gathered}
        log(f"[16] collectives on NCCL: relay/naive/ring return x, "
            f"psum_compressed gathered {gathered} and equals "
            f"dequantize(quantize(x))")

        def sharded(cfg, params, remat):
            specs = SH.layer_param_specs(params, cfg, mesh)
            return LM(cfg, device=DEVICE, params=load_for_mesh(
                params, mesh, specs), remat=remat), specs

        def clone(tree):
            return tree_map(lambda t: t.clone(), tree)

        # -- sharded prefill, B3 / B4 on the local shards
        B, T_ = SHARDED_PREFILL
        out["prefill"] = {}
        for arch, n_layers, kname, want in SHARDED_ARCHS:
            cfg = get_config(arch)
            if n_layers:
                cfg = cfg.with_(n_layers=n_layers)
            plain = LM(cfg, device=DEVICE, seed=SEED, remat=False)
            model, _ = sharded(cfg, clone(plain.params()), False)
            rules = SH.logical_rules(mesh, B, cfg)
            toks = torch.randint(0, cfg.vocab_size, (B, T_), generator=gen,
                                 device=DEVICE)
            dtoks = place(toks, rules["batch"], None)
            cache = plain.init_cache(B, T_)
            dcache = load_for_mesh(model.init_cache(B, T_), mesh,
                                   SH.cache_specs(cache, B, T_, mesh,
                                                  rules["batch"]))

            def run_sharded():          # a prefill from 0 rewrites a cache
                with logical_axis_rules(mesh, rules):
                    return dryrun.build_prefill_step(model, mesh)(
                        model.params(), dtoks, dcache)[0]

            def run_plain():
                return dryrun.build_prefill_step(plain)(
                    plain.params(), toks, cache)[0]
            for k in kernels:
                k.launches = 0                               # path starts
            logits = run_sharded()
            torch.cuda.synchronize()
            launches = {"flash": flash.launches, "scan": scan.launches}
            check(launches[kname] == want and sum(launches.values()) == want,
                  f"[16] {arch}: sharded prefill launched {launches}, want "
                  f"{want} of {kname}")                      # path ends
            ref = run_plain()
            got = logits.full_tensor()
            err = (got.float() - ref.float()).abs().max().item()
            # a 1 x 1 mesh runs the same kernels on the same data: the
            # sharded logits must be the unsharded ones, bit for bit
            check(torch.equal(got, ref), f"[16] {arch}: sharded prefill "
                  f"differs from the unsharded one, max err {err}")
            ms = host_ms(torch, run_sharded, 3, warmup=1)
            plain_ms = host_ms(torch, run_plain, 3, warmup=1)
            out["prefill"][arch] = {
                "layers": cfg.n_layers, "batch": B, "tokens": T_,
                "launches": launches, "max_abs_err": err,
                "sharded_ms": ms, "plain_ms": plain_ms}
            log(f"[16] {arch} ({cfg.n_layers} layers) sharded prefill "
                f"{B}x{T_}: {kname} launches {launches[kname]}, bit equal "
                f"to unsharded (max err {err}), {ms:.2f} ms sharded "
                f"vs {plain_ms:.2f} ms unsharded [{card}]")
            del plain, model, logits, ref, got, cache, dcache
            torch.cuda.empty_cache()

        # -- sharded training, ZeRO-1 state, against the unsharded steps
        cfg = get_config("smollm-135m")
        tr = SHARDED_TRAIN
        plain = LM(cfg, device=DEVICE, seed=SEED, remat=True)
        model, pspecs = sharded(cfg, clone(plain.params()), True)
        plain.requires_grad_(True)
        model.requires_grad_(True)
        rules = SH.logical_rules(mesh, tr["batch"], cfg)
        batches = [{k: torch.randint(0, cfg.vocab_size,
                                     (tr["batch"], tr["seq"]), generator=gen,
                                     device=DEVICE)
                    for k in ("tokens", "labels")}
                   for _ in range(tr["steps"])]
        opt_p = adamw.init(plain.params())
        opt_s = dryrun.place_opt_state(
            adamw.init(model.params()), mesh,
            SH.layer_opt_specs(model.params(), cfg, mesh))
        step_p = dryrun.build_train_step(plain)
        step_s = dryrun.build_train_step(model, 1, mesh, pspecs)
        plain_ms, losses_p = [], []
        for b in batches:
            t = time.perf_counter()
            params_p, opt_p, loss = step_p(plain.params(), opt_p, b)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t) * 1e3)
            losses_p.append(loss.item())
        for k in kernels:
            k.launches = 0                                   # path starts
        step_ms, losses_s = [], []
        with logical_axis_rules(mesh, rules):
            for b in batches:
                db = {k: place(v, rules["batch"], None) for k, v in b.items()}
                t = time.perf_counter()
                params_s, opt_s, loss = step_s(model.params(), opt_s, db)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                losses_s.append(loss.full_tensor().item())
        launches = {"flash": flash.launches, "scan": scan.launches,
                    "checksum": checksum.launches}           # path ends
        want = cfg.n_layers * tr["steps"] * 2
        check(launches == {"flash": want, "scan": 0, "checksum": 0},
              f"[16] sharded training launched {launches}, want {want} B3")
        diffs = [(a.full_tensor().float() - b.float()).abs().max().item()
                 for a, b in zip(leaves((params_s, opt_s.master)),
                                 leaves((params_p, opt_p.master)))]
        train_err = max(diffs)
        check(train_err == 0.0 and losses_s == losses_p,
              f"[16] sharded steps differ from the unsharded: params and "
              f"master max err {train_err}, losses {losses_s} vs "
              f"{losses_p}")
        out["train"] = {"config": "smollm-135m, 30 layers, bf16, remat, "
                                  "AdamW with ZeRO-1 state placements",
                        **tr, "launches": launches, "losses": losses_s,
                        "max_abs_err": train_err, "step_ms": step_ms,
                        "plain_step_ms": plain_ms}
        log(f"[16] smollm-135m sharded training, {tr['steps']} steps of "
            f"{tr['batch']}x{tr['seq']}: B3 launches {launches['flash']}, "
            f"params and master equal to the unsharded steps (max err "
            f"{train_err}), losses {losses_s}, step ms {step_ms} sharded vs "
            f"{plain_ms} unsharded [{card}]")

        # -- elastic restore: hashed by B1 on the card, placed on the mesh
        tree = plain.params()
        d = save_checkpoint(os.path.join(tmp, "ckpts"), tr["steps"], tree,
                            device=DEVICE)
        per = ckpt_hash_launches(d, chunk_bytes)
        for k in kernels:
            k.launches = 0                                   # path starts
        t = time.perf_counter()
        got = restore_checkpoint(os.path.join(tmp, "ckpts"), tree,
                                 device=DEVICE)
        check(got is not None, "[16] no checkpoint restored")
        placed = load_for_mesh(got[1], mesh, SH.layer_param_specs(
            got[1], cfg, mesh))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        launches = {"checksum": checksum.launches, "flash": flash.launches,
                    "scan": scan.launches}                   # path ends
        check(launches == {"checksum": per["scan"], "flash": 0, "scan": 0},
              f"[16] elastic restore launched {launches}, want "
              f"{per['scan']} B1")
        for a, b in zip(leaves(placed), leaves(tree)):
            check(a.full_tensor().dtype == b.dtype
                  and torch.equal(a.full_tensor(), b),
                  "[16] the placed restore differs from the saved arrays")
        out["elastic"] = {"launches": launches["checksum"],
                          "bytes": per["bytes"], "restore_s": restore_s}
        log(f"[16] elastic restore of {per['bytes']} bytes: B1 launches "
            f"{launches['checksum']} (== the files' 4 MiB reads), placed "
            f"and gathered back bit for bit in {restore_s:.3f} s")
    finally:
        dist.destroy_process_group()

    # -- the dry run of a full-size cell on a fake 8 x 8 mesh
    rec_path = os.path.join(tmp, "dryrun.json")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *DRYRUN_CELL, "--out", rec_path],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"[16] dry run failed: {r.stderr[-2000:]}")
    with open(rec_path) as f:
        rec = json.load(f)
    check(rec["ok"] and rec["flops"] > 0 and rec["collectives"],
          f"[16] dry run: {rec}")
    out["dryrun"] = {k: rec[k] for k in ("arch", "shape", "mesh",
                                         "microbatches", "memory", "flops",
                                         "model_flops", "collectives")}
    out["dryrun"]["wall_s"] = time.perf_counter() - t
    log(f"[16] dry run {' '.join(DRYRUN_CELL)}: {json.dumps(out['dryrun'])}")
    shutil.rmtree(tmp, ignore_errors=True)
    return out



# ------------------------------------------------------------ phase 17
# The four examples a new user runs first, through their ``main`` in this
# process, on the card (their default device).  The quickstart trains the
# published smollm-135m at the reference's 8 x 128 tokens; its failure at
# step 11 falls after the step-10 checkpoint, so the restart restores it.
QUICKSTART = dict(steps=12, fail_at=11, ckpt_every=10, batch=8, seq=128)
QUICKSTART_ARGS = ["--preset", "full", "--arch", "smollm-135m",
                   "--steps", str(QUICKSTART["steps"]),
                   "--fail-at", str(QUICKSTART["fail_at"])]
# (arch, the kernel a prefill wave launches once a layer) on the smoke
# configs; 8 requests of 12 new tokens (the example's defaults)
SERVE_EXAMPLES = (("smollm-135m", "flash"), ("falcon-mamba-7b", "scan"))
SERVE_EXAMPLE_TOKENS = 8 * 12
REPLICATION = dict(steps=60, ckpt_every=20, replicas=2)
EXAMPLE_DISK_BYTES = 4 * GiB          # the quickstart's 1.9 GB checkpoint
# what examples/replication_campaign.py prints last at its defaults (the
# reference, on the CPU)
CAMPAIGN_EXAMPLE_LAST = ("campaign finished in 10.0 simulated days (floor "
                         "3.0 d); done=True")


class KeptDir:
    """``tempfile.TemporaryDirectory``'s stand-in in an example's module: the
    example's tree stays until phase 17 has counted its files' reads."""

    path = None

    def __init__(self, *args, **kw):
        pass

    def __enter__(self):
        return KeptDir.path

    def __exit__(self, *exc):
        return False


def run_example(torch, name: str, argv, kernels):
    """(stdout, wall s, launches by kernel) of ``examples/<name>.py``'s
    ``main(argv)``, every count set to 0 just before it and read just
    after; its temporary tree kept in ``KeptDir.path``."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    KeptDir.path = train_dir(EXAMPLE_DISK_BYTES)
    # only the example's own ``tempfile`` name sees the stand-in
    mod.tempfile = types.SimpleNamespace(TemporaryDirectory=KeptDir)
    for k in kernels:
        k.launches = 0                                       # path starts
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches
                for k in kernels}                            # path ends
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            log(f"[17] {name}: {line}")
    check(rc == 0, f"{name} exited {rc}")
    return text, wall, launches


def grab(pattern: str, text: str, what: str):
    """The groups of ``pattern``'s first match in ``text``, or a failure."""
    m = re.search(pattern, text, re.M)
    check(m is not None, f"{what}: no line matches {pattern!r}")
    return m.groups()


def phase_examples(torch, get_config, loop, kernels, checksum, flash, scan,
                   chunk_bytes: int, card: str) -> dict:
    """The four examples on the card, each through its ``main``: the
    quickstart at full width (B3 every forward, B1 over the checkpoint at
    its save and at the restart's restore), batched serving (B3 or B4 once
    a layer a prefill wave), training with replication (B1 on every byte
    staged, copied, re-read and restored) and the replication campaign
    (host only).  Launches ``==`` what each run's steps, waves and files
    give; each example's wall."""
    out = {"card": card}
    zero = {k.__name__.rsplit(".", 1)[-1]: 0 for k in kernels}
    byp = {"tensor_core": 0, "cuda_core": 0}
    try:
        # -- the quickstart, smollm-135m at its published config
        cfg = get_config("smollm-135m")
        walls = {"save_s": [], "restore_s": []}
        save, restore = loop.save_checkpoint, loop.restore_checkpoint

        def timed(fn, key):
            def run(*args, **kw):
                t = time.perf_counter()
                got = fn(*args, **kw)
                walls[key].append(time.perf_counter() - t)
                return got
            return run
        loop.save_checkpoint = timed(save, "save_s")
        loop.restore_checkpoint = timed(restore, "restore_s")
        flash.launches_by_path.update(byp)
        try:
            text, wall, launches = run_example(
                torch, "torch_quickstart", QUICKSTART_ARGS, kernels)
        finally:
            loop.save_checkpoint, loop.restore_checkpoint = save, restore
        by_path = dict(flash.launches_by_path)
        arch, steps, restarts = grab(
            r"^arch=(\S+) steps=(\d+) restarts=(\d+) ", text, "quickstart")
        first, last = (float(x) for x in grab(
            r"^loss: (\S+) -> (\S+) ", text, "quickstart"))
        check((arch, steps, restarts) == (
            cfg.name, str(QUICKSTART["steps"]), "1") and all(
            x == x and abs(x) < float("inf") for x in (first, last)),
            f"quickstart: {arch} {steps} steps, {restarts} restarts, loss "
            f"{first} -> {last}")
        # steps 0..fail-1, then the steps from the last checkpoint on
        executed = QUICKSTART["fail_at"] + QUICKSTART["steps"] - \
            QUICKSTART["ckpt_every"]
        ckpt = os.path.join(KeptDir.path, "ckpts",
                            f"step-{QUICKSTART['ckpt_every']:06d}")
        per = ckpt_hash_launches(ckpt, chunk_bytes)
        want = dict(zero, checksum=2 * per["scan"],
                    flash_attention=cfg.n_layers * executed)
        check(launches == want and by_path == dict(
            byp, tensor_core=want["flash_attention"]),
            f"quickstart launches {launches} ({by_path}), want {want}: "
            f"{executed} steps x {cfg.n_layers} layers, the checkpoint "
            f"scanned at its save and its restore")
        # one save; a restore at each start, the first finding nothing
        check(len(walls["save_s"]) == 1 and len(walls["restore_s"]) == 2,
              f"quickstart checkpoint walls {walls}")
        tokens = executed * QUICKSTART["batch"] * QUICKSTART["seq"]
        out["quickstart"] = {
            "argv": QUICKSTART_ARGS, "batch": QUICKSTART["batch"],
            "seq": QUICKSTART["seq"], "executed_steps": executed,
            "restarts": 1, "loss": [first, last], "launches": launches,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "checkpoint_bytes": per["bytes"], **walls,
            "save_gb_per_s": per["bytes"] / walls["save_s"][0] / 1e9,
            "restore_gb_per_s": per["bytes"] / walls["restore_s"][1] / 1e9}
        log(f"[17] quickstart: {json.dumps(out['quickstart'])} [{card}]")
        shutil.rmtree(KeptDir.path, ignore_errors=True)

        # -- batched serving on the smoke configs
        for arch, kernel in SERVE_EXAMPLES:
            text, wall, launches = run_example(
                torch, "torch_serve_batched", ["--arch", arch], kernels)
            n, waves, toks, tps = grab(
                r"served (\d+) requests in (\d+) waves, (\d+) tokens in "
                r"\S+ \((\S+) tok/s on cuda\)", text, arch)
            n_layers = get_config(arch).smoke().n_layers
            key = {"flash": "flash_attention", "scan": "mamba_scan"}[kernel]
            want = dict(zero, **{key: n_layers * int(waves)})
            check(int(n) == 8 and int(toks) == SERVE_EXAMPLE_TOKENS
                  and launches == want,
                  f"serve {arch}: {n} requests, {toks} tokens, launches "
                  f"{launches}, want {want} ({waves} waves x {n_layers} "
                  f"layers)")
            out[f"serve {arch}"] = {"requests": int(n), "waves": int(waves),
                                    "tokens": int(toks), "launches": launches,
                                    "wall_s": wall,
                                    "tokens_per_s": float(tps)}
            log(f"[17] serve {arch} (smoke): {waves} waves, launches "
                f"{launches}, wall {wall:.1f} s [{card}]")
            shutil.rmtree(KeptDir.path, ignore_errors=True)

        # -- training with replication: staging, checkpoints, a pod lost
        text, wall, launches = run_example(
            torch, "torch_train_with_replication", [], kernels)
        staged = grab(r"^\[stage\] .* in (\d+) scheduler steps; "
                      r"verified=(\w+)$", text, "staging")
        replicated = re.findall(r"^\[train\] step (\d+) loss \S+ ckpt "
                                r"replicated=(\w+)$", text, re.M)
        restored = grab(r"^\[recover\] restored step (\d+) from (\w+);",
                        text, "restore")
        ckpts = list(range(REPLICATION["ckpt_every"], REPLICATION["steps"] + 1,
                           REPLICATION["ckpt_every"]))
        check(staged == ("3", "True") and replicated == [
            (str(c), "True") for c in ckpts] and restored == (
            str(ckpts[-1]), "POD1"),
            f"train_with_replication: staged {staged}, replicated "
            f"{replicated}, restored {restored}")
        # the hash: every dataset file streamed and re-read into each pod;
        # each checkpoint scanned at its save and copied (streamed and
        # re-read) to each replica; the last one verified at the restore
        store = os.path.join(KeptDir.path, "STORE", "datasets", "tokens")
        staging = 2 * 2 * sum(hash_launches(os.path.getsize(
            os.path.join(store, f)), chunk_bytes) for f in os.listdir(store))
        pod1 = os.path.join(KeptDir.path, "POD1", "ckpts")
        per = {c: ckpt_hash_launches(os.path.join(pod1, f"step-{c:06d}"),
                                     chunk_bytes) for c in ckpts}
        want_hash = staging + sum(p["scan"] + REPLICATION["replicas"] *
                                  p["copy"] for p in per.values()) + \
            per[ckpts[-1]]["scan"]
        n_layers = get_config("smollm-135m").smoke().n_layers
        want = dict(zero, checksum=want_hash,
                    flash_attention=n_layers * REPLICATION["steps"])
        check(launches == want,
              f"train_with_replication launches {launches}, want {want}")
        out["train_with_replication"] = {
            "steps": REPLICATION["steps"], "checkpoints": ckpts,
            "restored": list(restored), "staging_hash_launches": staging,
            "launches": launches, "wall_s": wall}
        log(f"[17] train_with_replication: {len(ckpts)} checkpoints "
            f"replicated, restored step {restored[0]} from {restored[1]}, "
            f"launches {launches} (staging {staging}), wall {wall:.1f} s "
            f"[{card}]")
        shutil.rmtree(KeptDir.path, ignore_errors=True)

        # -- the replication campaign: host only
        text, wall, launches = run_example(
            torch, "torch_replication_campaign", [], kernels)
        last_line = text.strip().splitlines()[-1]
        check(last_line == CAMPAIGN_EXAMPLE_LAST and launches == zero,
              f"campaign: {last_line!r} (want {CAMPAIGN_EXAMPLE_LAST!r}), "
              f"launches {launches}")
        out["replication_campaign"] = {"last_line": last_line,
                                       "launches": launches, "wall_s": wall}
        log(f"[17] replication_campaign: {last_line!r}, the reference's; "
            f"no launch; wall {wall:.1f} s [{card}]")
    finally:
        if KeptDir.path:
            shutil.rmtree(KeptDir.path, ignore_errors=True)
    return out


def main() -> None:
    # one allocator pool that grows in place: phase 15's gemma3 step peaks
    # at ~71 GB of the card's 79, and a pool fragmented into fixed segments
    # by the earlier phases (10 GB reserved but unallocated in one run)
    # would not hold it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "GPU")
    # f32 matmuls and convolutions in full f32 (the f32 comparisons)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from repro_torch.checkpoint.replicate import CheckpointReplicator
    from repro_torch.configs import get_config
    from repro_torch.core import campaign, integrity
    from repro_torch.core.transport import _CHUNK_BYTES
    from repro_torch.data.staging import StagingArea
    from repro_torch.ensemble import engine as ens_engine
    from repro_torch.ensemble import run as ens_run
    from repro_torch.kernels.checksum import checksum as kernel
    from repro_torch.kernels.checksum import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention as flash
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.lane_step import lane_step as lane_kernel
    from repro_torch.kernels.lane_step import ref as lane_ref
    from repro_torch.kernels.mamba_scan import mamba_scan as scan
    from repro_torch.kernels.mamba_scan import mamba_step as step
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import LM
    from repro_torch.obs import report
    from repro_torch.optim import adamw
    from repro_torch.scenarios import registry
    from repro_torch.scenarios import run as cli
    from repro_torch.scenarios import sweep
    from repro_torch.serve.engine import Engine
    from repro_torch.train import loop

    t0 = time.perf_counter()
    walls = {}

    def timed(label, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        walls[label] = time.perf_counter() - t
        log(f"[{label}] phase wall {walls[label]:.1f} s")
        return result

    card = timed(1, phase_device_and_build, torch,
                 (kernel, lane_kernel, flash, scan, step))
    entry = timed(2, phase_kernel, torch, np, kernel, ref, ops, integrity,
                  card)
    flash.launches = scan.launches = 0
    staging = timed(3, phase_staging, torch, np, kernel, ref, integrity,
                    StagingArea, _CHUNK_BYTES, lane_kernel)
    check(flash.launches == scan.launches == 0,
          "staging launched a model kernel")
    entry["launches"] = staging["launches"]
    check(entry["launches"] > 0, "the main path never launched the kernel")
    timed(4, phase_campaign, campaign)
    lane_entry = timed(5, phase_lane_step, torch, np, lane_kernel, lane_ref,
                       card)
    flash.launches = scan.launches = 0
    ensemble = timed(6, phase_ensemble, torch, ens_engine, ens_run, registry,
                     lane_kernel, kernel)
    check(flash.launches == scan.launches == 0,
          "the ensemble launched a model kernel")
    lane_entry["launches"] = ensemble["launches"]
    flash_entry = timed(7, phase_flash, torch, flash, flash_ref, card)
    scan_entry = timed(8, phase_scan, torch, scan, scan_ref, card)
    step_entry = timed("8b", phase_mamba_step, torch, step, scan_ref, card)
    served = timed(9, phase_serve, torch, get_config, LM, launch_serve,
                   Engine, flash, scan, (kernel, lane_kernel), step=step)
    flash_entry["launches"] = served["smollm-135m"]["launches"]["flash"]
    flash_entry["launches_by_path"] = served["smollm-135m"][
        "flash_launches_by_path"]
    scan_entry["launches"] = served["falcon-mamba-7b"]["launches"]["scan"]
    step_entry["launches"] = served["falcon-mamba-7b"]["launches"][
        "mamba_step"]
    grads = timed("10a", phase_train_grads, torch, flash, flash_ops,
                  flash_ref, scan, scan_ops, scan_ref)
    trained = timed(10, phase_train, torch, get_config, LM, Engine,
                    launch_serve, loop, adamw, CheckpointReplicator,
                    _CHUNK_BYTES, kernel, lane_kernel, flash, scan)
    # the fourth path's launches: smollm-135m's run (the hash, flash
    # attention) and falcon-mamba-7b's (the scan)
    smol = trained["smollm-135m"]["launches"]
    for e, key in ((entry, "checksum"), (lane_entry, "lane_step"),
                   (flash_entry, "flash")):
        e["launches_training"] = smol[key]
    scan_entry["launches_training"] = trained["falcon-mamba-7b"][
        "launches"]["scan"]
    flash_entry["training_grads"] = {k: v for k, v in grads.items()
                                     if k != TRAIN_SCAN_CASE[0]}
    scan_entry["training_grads"] = grads[TRAIN_SCAN_CASE[0]]
    kernels = (kernel, lane_kernel, flash, scan)
    for k in kernels:
        k.launches = 0                                       # path starts
    timed(11, phase_cli, cli, sweep, report)
    check(all(k.launches == 0 for k in kernels),
          "the host-only CLI launched a kernel")                # path ends
    log(f"[12] reduced: {MOE_CUTS}")
    moe_served = timed(12, phase_serve, torch, get_config, LM, launch_serve,
                       Engine, flash, scan, (kernel, lane_kernel),
                       MOE_SERVE_ARCHS, 12, step=step)
    moe_trained = timed(13, phase_train_archs, torch, get_config, LM, loop,
                        adamw, kernels, flash, kernel, _CHUNK_BYTES,
                        MOE_TRAIN_ARCHS, 13, MOE_TRAIN_CUTS)
    # the MoE paths' launches: B3 in qwen3-moe's prefills and training
    # forwards, B1 over deepseek-v2-lite's checkpoint
    flash_entry["launches_moe_serve"] = {
        a: r["launches"]["flash"] for a, r in moe_served.items()}
    flash_entry["launches_moe_training"] = {
        a: r["launches"]["flash_attention"] for a, r in moe_trained.items()}
    entry["launches_moe_training"] = {
        a: r["launches"]["checksum"] for a, r in moe_trained.items()}
    log(f"[14] reduced: {FAMILY_CUTS}")
    family_served = timed(14, phase_serve, torch, get_config, LM,
                          launch_serve, Engine, flash, scan,
                          (kernel, lane_kernel), FAMILY_SERVE_ARCHS, 14,
                          step=step)
    family_trained = timed(15, phase_train_archs, torch, get_config, LM,
                           loop, adamw, kernels, flash, kernel, _CHUNK_BYTES,
                           FAMILY_TRAIN_ARCHS, 15, FAMILY_TRAIN_CUTS)
    # the last four families' launches: B3 in every prefill and training
    # forward, B1 over zamba2-1.2b's checkpoint
    flash_entry["launches_family_serve"] = {
        a: r["launches"]["flash"] for a, r in family_served.items()}
    flash_entry["launches_family_training"] = {
        a: r["launches"]["flash_attention"]
        for a, r in family_trained.items()}
    entry["launches_family_training"] = {
        a: r["launches"]["checksum"] for a, r in family_trained.items()}
    shard = timed(16, phase_sharded, torch, get_config, LM, kernels, kernel,
                  flash, scan, _CHUNK_BYTES, card)
    log(f"[16] sharded path: phase wall {walls[16]:.1f} s of "
        f"{SHARDED_BUDGET_S:.0f} [{card}]")
    check(walls[16] < SHARDED_BUDGET_S,
          f"[16] took {walls[16]:.1f} s, beyond {SHARDED_BUDGET_S} s")
    # the sharded path's launches: B3 / B4 on the local shards of the
    # prefills and the training steps, B1 under the elastic restore
    flash_entry["launches_sharded"] = {
        "smollm-135m prefill": shard["prefill"]["smollm-135m"]["launches"][
            "flash"], "smollm-135m training": shard["train"]["launches"][
            "flash"]}
    scan_entry["launches_sharded"] = {
        "falcon-mamba-7b prefill": shard["prefill"]["falcon-mamba-7b"][
            "launches"]["scan"]}
    entry["launches_elastic"] = shard["elastic"]["launches"]
    examples = timed(17, phase_examples, torch, get_config, loop, kernels,
                     kernel, flash, scan, _CHUNK_BYTES, card)
    log(f"[17] examples: phase wall {walls[17]:.1f} s [{card}]")
    # the examples' launches: B1 under the quickstart's checkpoint and the
    # staging and replication, B3 in their forwards and the smollm serve,
    # B4 in the falcon-mamba serve
    runs = {k: v["launches"] for k, v in examples.items() if k != "card"}
    for e, key in ((entry, "checksum"), (flash_entry, "flash_attention"),
                   (scan_entry, "mamba_scan")):
        e["launches_examples"] = {k: n[key] for k, n in runs.items()
                                  if n[key]}
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    check(not leaked, f"JAX-side modules were imported: {leaked}")
    log(f"phase walls (s): {json.dumps(walls)}")
    log(f"total wall {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"kernels": [entry, lane_entry, flash_entry,
                                  scan_entry, step_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
