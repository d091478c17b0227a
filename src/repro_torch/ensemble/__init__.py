"""Batched ensemble engine: N seed- or parameter-perturbed campaign worlds
advanced in lockstep by one process over dense ``[lane, row]`` arrays.

Public surface:

* ``EnsembleSpec`` / ``AxisSpec`` (``repro_torch.ensemble.spec``) — declare a base
  ``ScenarioSpec`` plus perturbation axes (seed, fault rates, route
  bandwidths, AIMD constants, ...).
* ``run_ensemble`` (``repro_torch.ensemble.engine``) — run every lane and reduce
  to per-metric quantile bands.  Lane-capable specs run on the array
  engine (``repro_torch.ensemble.lanes``); anything else falls back to per-lane
  scalar replays of the exact same trajectories.
* ``quantile_bands`` (``repro_torch.ensemble.reduce``) — permutation-invariant
  band reduction.
* ``SearchDriver`` (``repro_torch.ensemble.search``) — grid/randomized
  configuration search with progress checkpointing.

Determinism contract: lane 0 of any ensemble whose first lane carries the
base spec/seed reproduces the scalar events-engine trajectory bit-for-bit
(same iteration count, float-exact sim days, identical succeeded-set
digest).  The numpy backend is the reference; the torch backend (the CUDA
lane-step kernel, or its plain PyTorch version on the CPU) is bit-identical
to it, because neither contracts ``a*b + c`` into a fused multiply-add.
"""
from repro_torch.ensemble.engine import EnsembleResult, run_ensemble
from repro_torch.ensemble.lanes import LanesEngine, lane_capable
from repro_torch.ensemble.reduce import quantile_bands
from repro_torch.ensemble.search import SearchDriver, SearchOutcome, run_search
from repro_torch.ensemble.spec import AxisSpec, EnsembleSpec

__all__ = ["AxisSpec", "EnsembleSpec", "EnsembleResult", "LanesEngine",
           "SearchDriver", "SearchOutcome", "lane_capable", "quantile_bands",
           "run_ensemble", "run_search"]
