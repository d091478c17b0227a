"""Parameter search over an ensemble, with progress checkpointing.

``SearchDriver`` evaluates an ``EnsembleSpec``'s lanes in chunks and keeps
a JSON checkpoint of every finished lane, so an interrupted sweep resumes
where it stopped instead of replaying hundreds of worlds.  Lane order is
fixed by ``EnsembleSpec.combos()`` (deterministic in the spec), which is
what makes "skip the first *k* lanes" a sound resume protocol.

The winner is the lane minimizing (or maximizing) one scalar objective —
default ``sim_days``, the campaign-duration metric the paper optimizes —
with ties broken by lane index, so a search is a pure function of
``(espec, scale, n_datasets, objective)``.  ``SearchOutcome.bench_entry``
packages the winner for ``BENCH_scenarios.json`` so CI's regression gate
can hold the line on it.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.ensemble.batch import make_segment_fn
from repro_torch.ensemble.engine import EnsembleResult, scalar_lane
from repro_torch.ensemble.lanes import LaneResult, LanesEngine, lane_capable
from repro_torch.ensemble.reduce import DEFAULT_METRICS, quantile_bands
from repro_torch.ensemble.spec import EnsembleSpec
from repro_torch.kernels.device import Device


def _lane_row(idx: int, r: LaneResult) -> dict:
    return {"lane": idx, "seed": r.seed, "label": dict(r.label),
            "iterations": r.iterations, "sim_days": r.sim_days,
            "faults_total": r.faults_total, "quarantined": r.quarantined,
            "timed_out": r.timed_out,
            "succeeded_digest": r.succeeded_digest}


@dataclass
class SearchOutcome:
    """A finished (or resumed-to-finished) search."""
    name: str
    objective: str
    minimize: bool
    rows: List[dict]                    # lane order, one dict per lane
    bands: Dict[str, Dict[str, float]]

    @property
    def winner(self) -> dict:
        sign = 1.0 if self.minimize else -1.0
        return min(self.rows, key=lambda r: (sign * r[self.objective],
                                             r["lane"]))

    def ranking(self) -> List[dict]:
        sign = 1.0 if self.minimize else -1.0
        return sorted(self.rows, key=lambda r: (sign * r[self.objective],
                                                r["lane"]))

    def to_json(self) -> dict:
        return {"name": self.name, "objective": self.objective,
                "minimize": self.minimize, "n_lanes": len(self.rows),
                "winner": self.winner, "bands": self.bands,
                "lanes": self.rows}

    def bench_entry(self) -> dict:
        """The winner as a BENCH_scenarios.json block: the objective value
        plus the band around it, for ``check_regression.py`` to gate."""
        w = self.winner
        return {f"ensemble_{self.name}_{self.objective}":
                float(w[self.objective]),
                f"ensemble_{self.name}_{self.objective}_p95":
                float(self.bands[self.objective]["p95"])}


class SearchDriver:
    """Chunked, resumable evaluation of one ensemble.

    Each chunk of lanes runs through the array lanes engine when every lane
    in it is lane-capable (one lockstep pass), else through scalar replays.
    After every chunk the checkpoint file — ``{"name", "n_total", "done":
    [lane rows]}`` — is atomically rewritten; a fresh driver pointed at the
    same file skips the recorded prefix.  A checkpoint whose ``name`` or
    ``n_total`` disagrees with the spec is ignored (stale file), never
    merged.  The segment step runs on ``backend`` and ``device`` as in
    ``run_ensemble``; a CUDA device without CUDA raises here."""

    def __init__(self, espec: EnsembleSpec, scale: float = 1.0,
                 n_datasets: Optional[int] = None, backend: str = "torch",
                 device: Device = "cuda", objective: str = "sim_days",
                 minimize: bool = True,
                 checkpoint: Optional[str] = None, chunk: int = 16,
                 metrics: Sequence[str] = DEFAULT_METRICS):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.espec = espec
        self.scale = scale
        self.n_datasets = n_datasets
        self.backend = backend
        self.segment_fn = make_segment_fn(backend, device)
        self.objective = objective
        self.minimize = minimize
        self.checkpoint = checkpoint
        self.chunk = chunk
        self.metrics = tuple(metrics)

    # ------------------------------------------------------------ checkpoint
    def _load_done(self) -> List[dict]:
        if not self.checkpoint or not os.path.exists(self.checkpoint):
            return []
        try:
            with open(self.checkpoint) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return []
        if (state.get("name") != self.espec.name
                or state.get("n_total") != self.espec.n_lanes):
            return []
        return list(state.get("done", []))

    def _save_done(self, done: List[dict]) -> None:
        if not self.checkpoint:
            return
        state = {"name": self.espec.name, "n_total": self.espec.n_lanes,
                 "objective": self.objective, "done": done}
        d = os.path.dirname(os.path.abspath(self.checkpoint))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(state, f, indent=1)
            os.replace(tmp, self.checkpoint)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # ------------------------------------------------------------------- run
    def _eval_chunk(self, lanes) -> List[LaneResult]:
        if all(lane_capable(spec)[0] for spec, _, _ in lanes):
            eng = LanesEngine(lanes, scale=self.scale,
                              n_datasets=self.n_datasets,
                              segment_fn=self.segment_fn)
            return eng.run()
        return [scalar_lane(spec, seed, label, self.scale, self.n_datasets)
                for spec, seed, label in lanes]

    def run(self, progress=None) -> SearchOutcome:
        """Evaluate every not-yet-checkpointed lane; return the outcome over
        ALL lanes (checkpointed + fresh).  ``progress`` is an optional
        callable ``(n_done, n_total) -> None``."""
        lanes = self.espec.lane_specs()
        done = self._load_done()
        if done and progress is not None:
            progress(len(done), len(lanes))
        while len(done) < len(lanes):
            lo = len(done)
            batch = lanes[lo:lo + self.chunk]
            results = self._eval_chunk(batch)
            done.extend(_lane_row(lo + i, r) for i, r in enumerate(results))
            self._save_done(done)
            if progress is not None:
                progress(len(done), len(lanes))
        return SearchOutcome(
            name=self.espec.name, objective=self.objective,
            minimize=self.minimize, rows=done,
            bands=quantile_bands(done, metrics=self.metrics))


def run_search(espec: EnsembleSpec, **kw) -> SearchOutcome:
    """One-call convenience wrapper around ``SearchDriver``."""
    return SearchDriver(espec, **kw).run()
