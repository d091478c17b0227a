"""Ensemble driver: compile an ``EnsembleSpec``, run every lane, reduce.

Dispatch: if the base spec (and therefore every lane — axes never add
subsystems the base lacks, except ``policy.*`` axes, which are checked per
lane) is lane-capable, all lanes run in one ``LanesEngine`` lockstep pass;
otherwise each lane is an independent scalar replay through the event
engine — same trajectories, no array speedup.  ``force_scalar=True``
requests the fallback explicitly (the bit-identity gate uses it to produce
the reference side).

The lanes engine's segment step runs on ``backend`` (default ``"torch"``,
the lane-step kernel) on ``device`` (default ``"cuda"``, which raises when
CUDA is not available); ``backend="numpy"`` or ``device="cpu"`` asks for the
host.  The scalar fallback does no device work and reports ``"numpy"``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.pause import DAY
from repro_torch.core.snapshot import succeeded_digest
from repro_torch.ensemble.batch import backend_label, make_segment_fn
from repro_torch.ensemble.lanes import LaneResult, LanesEngine, lane_capable
from repro_torch.ensemble.reduce import quantile_bands
from repro_torch.ensemble.spec import EnsembleSpec
from repro_torch.kernels.device import Device


@dataclass
class EnsembleResult:
    name: str
    n_lanes: int
    engine: str                    # "lanes" | "scalar"
    backend: str             # "numpy" | "torch:cuda" | "torch:cpu" (lanes)
    lanes: List[LaneResult]
    bands: Dict[str, Dict[str, float]]

    def lane(self, i: int) -> LaneResult:
        return self.lanes[i]

    def to_json(self) -> dict:
        return {
            "name": self.name, "n_lanes": self.n_lanes,
            "engine": self.engine, "backend": self.backend,
            "bands": self.bands,
            "lanes": [{"seed": r.seed, "label": r.label,
                       "iterations": r.iterations, "sim_days": r.sim_days,
                       "faults_total": r.faults_total,
                       "quarantined": r.quarantined,
                       "timed_out": r.timed_out,
                       "succeeded_digest": r.succeeded_digest}
                      for r in self.lanes],
        }


def scalar_lane(spec, seed: int, label: dict, scale: float,
                n_datasets: Optional[int]) -> LaneResult:
    """One lane as a plain scalar replay (the fallback and reference path).

    Accepts any spec with a ``build`` method the event engine can drive —
    single-campaign ``ScenarioSpec``s and ``FederationSpec``s (whose lanes
    reduce the per-member reports into one row: ``sim_days`` is the
    federation span, counters sum over members, and the digest chains the
    member digests in member order)."""
    import hashlib

    from repro_torch.scenarios.events import EngineStats, run_world
    stats = EngineStats()
    world = spec.build(scale=scale, seed=seed, n_datasets=n_datasets)
    report = run_world(world, engine="events", stats=stats)
    if hasattr(report, "members"):                       # FederationReport
        members = list(report.members.values())
        bytes_at: Dict[str, int] = {}
        for m in members:
            for k, v in m.bytes_at.items():
                bytes_at[k] = bytes_at.get(k, 0) + int(v)
        h = hashlib.sha256()
        for rt in world.runtimes:
            h.update(f"{rt.label}|{succeeded_digest(rt.table)}\n".encode())
        timed_out = any(
            report.finished_day[lbl] >= mem.start_day + mem.scenario.max_days
            for lbl, mem in zip(report.members, spec.members))
        return LaneResult(
            seed=seed, label=dict(label), iterations=stats.iterations,
            sim_days=report.span_days,
            faults_total=sum(m.faults_total for m in members),
            quarantined=sum(m.quarantined for m in members),
            bytes_at=bytes_at, succeeded_digest=h.hexdigest(),
            timed_out=timed_out)
    return LaneResult(
        seed=seed, label=dict(label), iterations=stats.iterations,
        sim_days=report.duration_days, faults_total=report.faults_total,
        quarantined=report.quarantined,
        bytes_at={k: int(v) for k, v in report.bytes_at.items()},
        succeeded_digest=succeeded_digest(world.table),
        timed_out=report.duration_days >= spec.max_days)


def run_ensemble(espec: EnsembleSpec, scale: float = 1.0,
                 n_datasets: Optional[int] = None, backend: str = "torch",
                 device: Device = "cuda", force_scalar: bool = False,
                 metrics: Sequence[str] = ("sim_days", "faults_total",
                                           "quarantined")) -> EnsembleResult:
    segment_fn = make_segment_fn(backend, device)
    lanes = espec.lane_specs()
    capable = (not force_scalar
               and all(lane_capable(spec)[0] for spec, _, _ in lanes))
    if capable:
        eng = LanesEngine(lanes, scale=scale, n_datasets=n_datasets,
                          segment_fn=segment_fn)
        results = eng.run()
        mode, backend = "lanes", backend_label(backend, device)
    else:
        results = [scalar_lane(spec, seed, label, scale, n_datasets)
                   for spec, seed, label in lanes]
        mode, backend = "scalar", "numpy"
    return EnsembleResult(name=espec.name, n_lanes=len(results), engine=mode,
                          backend=backend, lanes=results,
                          bands=quantile_bands(results, metrics=metrics))
