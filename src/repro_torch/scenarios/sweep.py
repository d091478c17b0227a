"""Parameter-sweep runner: fan scenario variants across processes.

Capacity planning for continental-scale replication means asking many
what-ifs at once — N seeds of the fault storm, the degraded source at three
bandwidths, every registered scenario side by side.  ``sweep()`` runs each
variant in its own worker process (event-driven engine, so each run is
seconds), aggregates the resulting ``CampaignReport``s into flat comparison
rows, and ``emit_bench`` merges them into ``BENCH_scenarios.json``.

    PYTHONPATH=src python -m repro_torch.scenarios.sweep \
        --scenarios paper-2022,fault-storm --seeds 0,1 --datasets 40 --scale 0.02
"""
from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

BENCH_PATH = "BENCH_scenarios.json"


@dataclass(frozen=True)
class Variant:
    """One sweep cell: a registered scenario plus build overrides."""
    scenario: str
    n_datasets: Optional[int] = None
    scale: float = 1.0
    seed: int = 0
    engine: str = "events"

    @property
    def label(self) -> str:
        nd = self.n_datasets if self.n_datasets is not None else "full"
        return f"{self.scenario}[n={nd},scale={self.scale},seed={self.seed}]"


def _run_variant(v: Variant) -> Dict:
    """Worker: build + run one variant, flatten the report (module-level so
    it pickles across process boundaries)."""
    from repro_torch.scenarios.events import EngineStats, run_scenario
    stats = EngineStats()
    t0 = time.time()
    rep = run_scenario(v.scenario, engine=v.engine, scale=v.scale,
                       seed=v.seed, n_datasets=v.n_datasets, stats=stats)
    wall = time.time() - t0
    complete = (rep.quarantined == 0
                and all(b >= rep.total_bytes * 0.999
                        for b in rep.bytes_at.values()))
    return {
        "variant": v.label,
        "scenario": v.scenario,
        "seed": v.seed,
        "scale": v.scale,
        "n_datasets": v.n_datasets,
        "engine": v.engine,
        "wall_s": round(wall, 3),
        "iterations": stats.iterations,
        "events_per_s": round(stats.iterations / max(wall, 1e-9), 1),
        "duration_days": round(rep.duration_days, 3),
        "floor_days": round(rep.floor_days, 3),
        "total_tb": round(rep.total_bytes / 1024 ** 4, 3),
        "complete": complete,
        "faults_total": rep.faults_total,
        "faults_max": rep.faults_per_transfer_max,
        "quarantined": rep.quarantined,
        "notifications": len(rep.notifications),
        "per_route_gbps": {f"{a}->{b}": round(g, 3)
                           for (a, b), g in rep.per_route_gbps.items()},
        "per_route_transfers": {f"{a}->{b}": n
                                for (a, b), n in rep.per_route_transfers.items()},
    }


def sweep(variants: Sequence[Variant],
          processes: Optional[int] = None) -> List[Dict]:
    """Run all variants, multi-process when possible, and return comparison
    rows in input order.  Workers use the ``spawn`` start method (fork is
    unsafe once jax's thread pools exist); any pool-level failure falls back
    to in-process execution, where a genuine variant error re-raises."""
    variants = list(variants)
    if processes is None:
        processes = min(len(variants), os.cpu_count() or 1)
    if processes > 1 and len(variants) > 1:
        import multiprocessing as mp
        import pickle
        from concurrent.futures.process import BrokenProcessPool
        try:
            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(max_workers=processes,
                                     mp_context=ctx) as ex:
                return list(ex.map(_run_variant, variants))
        except (OSError, ImportError, pickle.PicklingError,
                BrokenProcessPool):
            pass    # pool infrastructure unavailable (restricted hosts, sys.path,
            #         semaphores) — genuine variant errors re-raise below
    return [_run_variant(v) for v in variants]


def to_frame(rows: Sequence[Dict]) -> Dict[str, list]:
    """Column-oriented view of the comparison rows (a minimal 'frame' —
    ready for tabulation or pandas ingestion without depending on pandas)."""
    cols: Dict[str, list] = {}
    for row in rows:
        for k, v in row.items():
            cols.setdefault(k, []).append(v)
    return cols


def emit_bench(rows: Sequence[Dict], path: str = BENCH_PATH,
               extra: Optional[Dict] = None) -> Dict:
    """Merge sweep rows (and optional extra sections, e.g. the engine
    comparison from ``benchmarks/campaign_replay.py``) into ``path``."""
    doc: Dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = {}
    if rows:
        doc["sweep"] = list(rows)
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.scenarios.registry import list_scenarios
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", default="all",
                    help="comma-separated scenario names, or 'all'")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds per scenario")
    ap.add_argument("--datasets", type=int, default=60)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--engine", choices=("events", "step"), default="events")
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--out", default=BENCH_PATH)
    args = ap.parse_args(argv)

    names = (list_scenarios() if args.scenarios == "all"
             else args.scenarios.split(","))
    unknown = [n for n in names if n not in list_scenarios()]
    if unknown:
        ap.error(f"unknown scenario(s): {', '.join(unknown)}; "
                 f"available: {', '.join(list_scenarios())}")
    seeds = [int(s) for s in args.seeds.split(",")]
    variants = [Variant(n, n_datasets=args.datasets, scale=args.scale,
                        seed=s, engine=args.engine)
                for n in names for s in seeds]
    t0 = time.time()
    rows = sweep(variants, processes=args.processes)
    emit_bench(rows, path=args.out,
               extra={"sweep_wall_s": round(time.time() - t0, 2)})
    for row in rows:
        print(f"{row['variant']:58} {row['duration_days']:8.2f} d "
              f"(floor {row['floor_days']:6.2f}) faults={row['faults_total']:5d} "
              f"quarantined={row['quarantined']:3d} wall={row['wall_s']:.2f}s")
    print(f"\n{len(rows)} variants -> {args.out}")


if __name__ == "__main__":
    main()
