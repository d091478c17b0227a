"""Audit driver: a landed replica verified against its manifest.

Set-up writes the source tree (the configuration's ``files`` in DRS-style
dataset directories, one at the mean of each equal stratum of the
traffic's size distribution, bytes from the seed made on the device),
has the program build the manifest from it (``Manifest.scan``, the B1 hash
of every byte), then flips one byte in one file of ``corrupt_every`` (at
least one), each at an offset from the seed: the tree on disk is now the
replica, in the page cache.  The window runs whole passes of
``Manifest.verify_many`` over the replica; ``audit_GB_per_s`` is the bytes
verified over the window's span.

Judged after the window: every digest of the manifest against the plain
hash of the source bytes, regenerated from the seed (``digest_errors``),
and every verdict of every pass against the flips made (``verdict_errors``):
a flipped file reported, no clean one.  The control verifies by size alone
(a quick check that breaks the guarantee) and reads its verdicts the same
way.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import gen
from perfbench.harness import ROOT, Context, Outcome, free_device, log
from perfbench.reference import b1_hash

_ACTIVITIES = ("CMIP", "ScenarioMIP", "HighResMIP", "DAMIP")
_SOURCES = ("CESM2", "E3SM-1-0", "GFDL-CM4", "IPSL-CM6A-LR", "MIROC6")
_TABLES = (("Amon", "tas"), ("Omon", "tos"), ("day", "pr"), ("3hr", "huss"),
           ("SImon", "siconc"))


def drs_paths(seed: int, n: int) -> List[str]:
    """``n`` distinct dataset file paths in CMIP6's DRS layout."""
    r = gen.rng(seed, 1)
    out = []
    for i in range(n):
        act = _ACTIVITIES[r.integers(len(_ACTIVITIES))]
        src = _SOURCES[r.integers(len(_SOURCES))]
        table, var = _TABLES[r.integers(len(_TABLES))]
        member = f"r{r.integers(1, 11)}i1p1f1"
        y0 = int(r.integers(1850, 2090))
        out.append(os.path.join(
            "CMIP6", act, "INST", src, "historical", member, table, var,
            "gn", f"v2019{i:04d}",
            f"{var}_{table}_{src}_historical_{member}_gn_{y0}01-"
            f"{y0 + 9}12.nc"))
    return out


def source_bytes(seed: int, index: int, size: int, device) -> np.ndarray:
    """File ``index``'s bytes, drawn on ``device`` from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(gen.torch_seed(seed, 2, index))
    return torch.randint(0, 256, (size,), dtype=torch.uint8, generator=g,
                         device=device).cpu().numpy()


def layout(ctx: Context) -> Tuple[List[str], List[int], Dict[str, int]]:
    """(paths, sizes, {path: flipped offset})."""
    tr = ctx.cell.traffic
    sizes = gen.stratum_means(tr["file_size"], ctx.cell.config["files"])
    order = gen.permutation(ctx.seed, len(sizes), 3)
    sizes = [sizes[i] for i in order]
    paths = drs_paths(ctx.seed, len(sizes))
    r = gen.rng(ctx.seed, 4)
    k = max(1, len(paths) // tr["corrupt_every"])
    flips = {paths[i]: int(r.integers(sizes[i]))
             for i in sorted(r.choice(len(paths), k, replace=False))}
    return paths, sizes, flips


def root_dir() -> str:
    """The replica's directory, under ``TMPDIR`` (else the checkout's
    ``build/tmp``): a data directory, removed when the run ends."""
    base = os.environ.get("TMPDIR") or str(ROOT / "build" / "tmp")
    return os.path.join(base, f"perfbench-audit-{os.getpid()}")


def run(ctx: Context) -> Outcome:
    from repro_torch.core.integrity import Manifest
    dev = ctx.device
    paths, sizes, flips = layout(ctx)
    root = root_dir()
    try:
        for i, (rel, size) in enumerate(zip(paths, sizes)):
            p = os.path.join(root, rel)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(source_bytes(ctx.seed, i, size, dev).data)
                f.flush()
                os.fsync(f.fileno())
        manifest = Manifest.scan(root, device=dev)
        for rel, off in flips.items():
            with open(os.path.join(root, rel), "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
                f.flush()
                os.fsync(f.fileno())
        reports, verified = _window(ctx, manifest, root, dev, sum(sizes))
        span = ctx.window_end - ctx.window_start
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        free_device(dev)
        readings = {"verdict_errors": _verdict_errors(reports, paths, flips),
                    "digest_errors": _digest_errors(ctx, manifest, paths,
                                                    sizes)}
        control = {}
        if ctx.control:
            control["verdict_errors"] = _verdict_errors(
                [_size_only(manifest, root)], paths, flips)
    finally:
        _remove(root)
    n = len(reports) * len(paths)
    return Outcome(
        metrics={"audit_GB_per_s": verified / span / 1e9},
        attempted=n, failed=readings["verdict_errors"], readings=readings,
        memory_peak=peak, control=control)


def _window(ctx: Context, manifest, root: str, dev, total: int):
    from repro_torch.core import integrity
    tracer = ctx.tracer
    fold, stream = integrity.fold_words, integrity.stream_file_checksum

    def traced_fold(words, start_word=0, acc=None):
        with tracer.span("audit.fold", sync=True,
                         bytes=4 * words.numel()):
            return fold(words, start_word, acc)

    def traced_stream(path, device="cuda"):
        with tracer.span("audit.read"):
            out = stream(path, device)
        tracer.tick()
        return out
    reports = []
    verified = 0
    if ctx.tracer.on:
        integrity.fold_words = traced_fold
        integrity.stream_file_checksum = traced_stream
    try:
        ctx.start_window()
        while True:
            reports.append(manifest.verify_many(root, device=dev))
            verified += total
            if ctx.done():
                break
        ctx.end_window()
    finally:
        integrity.fold_words = fold
        integrity.stream_file_checksum = stream
    return reports, verified


def _verdict_errors(reports, paths, flips) -> int:
    """Verdicts that differ from the flips made, over every pass; a file
    missing from a pass's report is an error."""
    bad = 0
    for rep in reports:
        for rel in paths:
            r = rep.get(rel)
            clean = rel not in flips
            if (r is None or r["ok"] != clean or r["size_ok"] is not True
                    or r["checksum_ok"] != clean):
                bad += 1
    return bad


def _digest_errors(ctx: Context, manifest, paths, sizes) -> int:
    """Manifest entries whose (size, digest) differ from the plain hash of
    the source bytes; an entry missing or extra is an error."""
    bad = len(set(manifest.entries) ^ set(paths))
    for i, (rel, size) in enumerate(zip(paths, sizes)):
        got = manifest.entries.get(rel)
        if got is None:
            continue
        data = source_bytes(ctx.seed, i, size, ctx.device)
        if tuple(got) != (size, b1_hash.digest(data)):
            bad += 1
    return bad


def _size_only(manifest, root: str) -> dict:
    """The control: each file's verdict by its size alone."""
    rep = {}
    for rel, (size, _) in manifest.entries.items():
        ok = os.path.getsize(os.path.join(root, rel)) == size
        rep[rel] = {"ok": ok, "size_ok": ok, "checksum_ok": ok}
    return rep


def _remove(root: str) -> None:
    if not os.path.isdir(root):
        return
    for dirpath, dirs, files in os.walk(root, topdown=False):
        for fn in files:
            os.unlink(os.path.join(dirpath, fn))
        for d in dirs:
            os.rmdir(os.path.join(dirpath, d))
    os.rmdir(root)
    log(f"removed {root}")
