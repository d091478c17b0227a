"""Ensemble CLI.

    PYTHONPATH=src python -m repro_torch.ensemble.run --ensemble ensemble-paper-bands \
        [--lanes N] [--scale S] [--datasets N] [--backend numpy|torch] \
        [--device cuda|cpu] \
        [--search [--objective sim_days] [--checkpoint FILE] [--chunk K]] \
        [--json out.json] [--verbose]
    PYTHONPATH=src python -m repro_torch.ensemble.run --ensemble <name> --check-lane0
    PYTHONPATH=src python -m repro_torch.ensemble.run --list

``--check-lane0`` is the bit-identity gate CI runs: lane 0 of the ensemble
replays through the array lanes engine AND through the scalar event engine,
and the two trajectories — iteration count, float-exact sim days, fault and
quarantine counters, per-replica bytes, succeeded-set digest — must match
exactly, on whichever backend runs the lanes (the numpy backend is the
reference, and the torch backend is bit-identical to it).  Exit code 4 on
any mismatch.

The lanes engine's segment step runs on ``--backend torch`` (the default:
the lane-step kernel) on ``--device cuda`` (the default; it raises when CUDA
is not available).  ``--device cpu`` runs the plain PyTorch version and
``--backend numpy`` the numpy reference.

``--search`` runs the checkpointed search driver instead of a plain band
reduction: lanes evaluate in ``--chunk``-sized pieces, progress persists to
``--checkpoint`` after every chunk, and the report names the winning lane
by ``--objective``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

from repro_torch.ensemble.batch import BACKENDS
from repro_torch.ensemble.engine import run_ensemble, scalar_lane
from repro_torch.ensemble.search import SearchDriver
from repro_torch.ensemble.spec import EnsembleSpec
from repro_torch.kernels.device import Device
from repro_torch.scenarios.registry import get_scenario, list_ensembles

EXIT_MISMATCH = 4

#: the trajectory fields the lane-0 gate compares (LaneResult attributes)
GATE_FIELDS = ("iterations", "sim_days", "faults_total", "quarantined",
               "bytes_at", "succeeded_digest", "timed_out")


def _get_ensemble(name: str, lanes: Optional[int]) -> EnsembleSpec:
    spec = get_scenario(name)
    if not isinstance(spec, EnsembleSpec):
        raise SystemExit(f"{name!r} is not an ensemble scenario; "
                         f"available: {', '.join(list_ensembles())}")
    if lanes is not None:
        spec = dataclasses.replace(spec, n_lanes=lanes)
    return spec


def check_lane0(espec: EnsembleSpec, scale: float,
                n_datasets: Optional[int], backend: str = "torch",
                device: Device = "cuda") -> dict:
    """Replay lane 0 through both engines and diff the trajectories.
    Returns ``{"match": bool, "mismatches": {...}, ...}``."""
    lane0 = dataclasses.replace(espec, n_lanes=1)
    ens = run_ensemble(lane0, scale=scale, n_datasets=n_datasets,
                       backend=backend, device=device)
    spec, seed, label = espec.lane_specs()[0]
    ref = scalar_lane(spec, seed, label, scale, n_datasets)
    got = ens.lane(0)
    mism = {}
    for f in GATE_FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        if a != b:
            mism[f] = {"scalar": a, "ensemble": b}
    return {"ensemble": espec.name, "engine": ens.engine,
            "backend": ens.backend, "seed": seed,
            "match": not mism, "mismatches": mism}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.ensemble.run")
    p.add_argument("--ensemble", help="registered ensemble name")
    p.add_argument("--list", action="store_true",
                   help="list registered ensembles and exit")
    p.add_argument("--lanes", type=int, default=None,
                   help="override the ensemble's lane count")
    p.add_argument("--scale", type=float, default=0.01)
    p.add_argument("--datasets", type=int, default=None)
    p.add_argument("--backend", default="torch", choices=BACKENDS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--check-lane0", action="store_true",
                   help="bit-identity gate: diff lane 0 vs the scalar engine")
    p.add_argument("--search", action="store_true",
                   help="run the checkpointed search driver")
    p.add_argument("--objective", default="sim_days")
    p.add_argument("--maximize", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="search progress file (resume by re-running)")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--json", dest="json_out", default=None)
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.list:
        for name in list_ensembles():
            spec = get_scenario(name)
            axes = ", ".join(a.name for a in spec.axes) or "seed sweep"
            print(f"{name:28s} lanes={spec.n_lanes:<4d} [{axes}]")
        return 0
    if not args.ensemble:
        p.error("--ensemble NAME required (or --list)")

    espec = _get_ensemble(args.ensemble, args.lanes)
    t0 = time.perf_counter()

    if args.check_lane0:
        out = check_lane0(espec, args.scale, args.datasets, args.backend,
                          args.device)
        out["wall_s"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(out, indent=2))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(out, f, indent=2)
        if not out["match"]:
            print("lane-0 trajectory MISMATCH vs scalar engine",
                  file=sys.stderr)
            return EXIT_MISMATCH
        return 0

    if args.search:
        def progress(k, n):
            if args.verbose:
                print(f"  {k}/{n} lanes", file=sys.stderr)
        driver = SearchDriver(espec, scale=args.scale,
                              n_datasets=args.datasets, backend=args.backend,
                              device=args.device,
                              objective=args.objective,
                              minimize=not args.maximize,
                              checkpoint=args.checkpoint, chunk=args.chunk)
        outcome = driver.run(progress=progress)
        out = outcome.to_json()
        out["wall_s"] = round(time.perf_counter() - t0, 3)
    else:
        res = run_ensemble(espec, scale=args.scale, n_datasets=args.datasets,
                           backend=args.backend, device=args.device)
        out = res.to_json()
        out["wall_s"] = round(time.perf_counter() - t0, 3)
        if not args.verbose:
            out.pop("lanes")

    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
