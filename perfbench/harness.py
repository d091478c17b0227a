"""Runs one cell of ``BENCHMARK.json``: finds its files by name, drives the
window, judges the outputs, and prints the result line.

``main`` is ``run.py``'s body.  ``run_cell`` is everything after the look
for a chip; the tests call it on the CPU at small sizes.

The result's last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; then ``checks``, every number compared beside its
limit, which also end standard error.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (a metric's name
    holds dots, so it is no importable module name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def cell_of(w: dict) -> Cell:
    """The cell of a ``workloads`` entry, its files found by name."""
    return Cell(w["name"], w,
                load_json(BENCH_DIR / "configs" / f"{w['config']}.json"),
                load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                load_json(BENCH_DIR / "limits" / f"{w['name']}.json"))


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return cell_of(entries[name])


def end_to_end_of(cell: str, bench: dict) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(cell: str, bench: dict) -> List[dict]:
    e2e = {m["name"] for m in end_to_end_of(cell, bench)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


@dataclass
class Context:
    """What a driver gets: the cell's data, the run's arguments, and the
    tracer; it marks the window's start and end."""
    cell: Cell
    seed: int
    seconds: float
    device: object                       # torch.device
    tracer: object                       # tracing.Tracer
    t0: float                            # the process's start
    control: bool = False                # also read the control
    window_start: float = 0.0
    window_end: float = 0.0

    def start_window(self) -> None:
        self.tracer.start()
        self.window_start = time.perf_counter()

    def done(self) -> bool:
        """The window may end here: its seconds have passed, and the
        profiler of a traced run has run its course."""
        return (time.perf_counter() - self.window_start >= self.seconds
                and not self.tracer.pending)

    def end_window(self) -> None:
        self.tracer.stop()
        self.window_end = time.perf_counter()


@dataclass
class Outcome:
    """What a driver returns."""
    metrics: Dict[str, float]            # end-to-end values but setup_s
    attempted: int
    failed: int
    readings: Dict[str, float]           # the numbers compared
    memory_peak: int
    counters: dict = field(default_factory=dict)
    control: Dict[str, float] = field(default_factory=dict)


@dataclass
class TracedRun:
    """What a metric reader reads."""
    trace: object                        # tracing.TraceData or None
    counters: dict
    cell: Cell


def free_device(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def judge(readings: Mapping[str, float], limits: Mapping[str, float]
          ) -> Dict[str, dict]:
    """Every limited number beside its limit; a number not read is
    infinite (not correct)."""
    return {name: {"value": readings.get(name, float("inf")),
                   "limit": limit} for name, limit in limits.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, bench: dict, control: bool = False) -> dict:
    """Drive one run of ``cell`` on ``device`` and return its result
    object (``outcome`` beside it, under ``_outcome``)."""
    import torch

    from perfbench.tracing import Tracer
    device = torch.device(device)
    tracer = Tracer(trace, min(seconds, cell.traffic["trace_seconds"]),
                    device, cell.traffic.get("trace_lead_seconds", 0))
    ctx = Context(cell, seed, tracer.seconds if trace else seconds, device,
                  tracer, t0, control)
    driver = load_module(BENCH_DIR / "drivers" / f"{cell.driver}.py",
                         f"perfbench_driver_{cell.driver}")
    out: Outcome = driver.run(ctx)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if trace:
        data = tracer.data
        run = TracedRun(data, out.counters, cell)
        metrics = {}
        for m in per_layer_of(cell.name, bench):
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"]
                                 .replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = value
    else:
        values = dict(out.metrics, setup_s=ctx.window_start - t0)
        metrics = {m["name"]: values[m["name"]]
                   for m in end_to_end_of(cell.name, bench)
                   if m["name"] in values}
    checks = judge(out.readings, cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out.memory_peak}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "device": dev}
    if trace and tracer.data is not None:
        dev["busy_s"] = tracer.data.busy_s()
        dev["window_s"] = tracer.data.window_s
        result["breakdown"] = tracer.data.breakdown()
    result["checks"] = checks
    result["_outcome"] = out
    return result


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv: List[str], t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    cell = find_cell(args.workload, bench)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0, bench)
    found = forbidden_modules()
    if found:
        log(f"the process holds {found} after the window")
        return 3
    out = result.pop("_outcome")
    if out.control:
        log(f"control: {out.control}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
