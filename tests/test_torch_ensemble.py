"""The port's ensemble engine against the JAX package's.

The port's lanes engine, run on its torch backend with the plain PyTorch
segment step (``device="cpu"``), must replay the JAX package's numpy
backend exactly: every lane's gate fields (iterations, float-exact sim days,
fault counters, bytes per replica, succeeded-set digest) and the quantile
bands.  The JAX package's jax and Pallas backends are never called here
(the installed jax lacks their scoped x64 switch).  Search checkpoints
written by either package resume in the other.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core.faults import FaultInjector as JFaultInjector
from repro.ensemble import EnsembleSpec as JEnsembleSpec
from repro.ensemble import AxisSpec as JAxisSpec
from repro.ensemble import SearchDriver as JSearchDriver
from repro.ensemble import quantile_bands as jquantile_bands
from repro.ensemble import run_ensemble as jrun_ensemble
from repro.ensemble.run import check_lane0 as jcheck_lane0
from repro.scenarios.registry import get_scenario as jget
from repro_torch.ensemble import AxisSpec, EnsembleSpec, SearchDriver
from repro_torch.ensemble import quantile_bands, run_ensemble, run_search
from repro_torch.ensemble.batch import BatchedFaultInjector
from repro_torch.ensemble.run import GATE_FIELDS, check_lane0, main
from repro_torch.kernels.lane_step import lane_step as kernel
from repro_torch.scenarios.registry import get_scenario

SCALE, ND = 0.01, 8
CPU = dict(backend="torch", device="cpu")


def _gate(lane):
    return {f: getattr(lane, f) for f in GATE_FIELDS}


def _ensembles(case):
    """The same ensemble declared in both packages."""
    if case == "paper-sweep":
        return (EnsembleSpec("t-sweep", get_scenario("paper-2022"),
                             n_lanes=4),
                JEnsembleSpec("t-sweep", jget("paper-2022"), n_lanes=4))
    return (EnsembleSpec("t-axes", get_scenario("paper-2022"),
                         axes=(AxisSpec("faults.transient_per_tb",
                                        (0.15, 6.0)),), n_lanes=2),
            JEnsembleSpec("t-axes", jget("paper-2022"),
                          axes=(JAxisSpec("faults.transient_per_tb",
                                          (0.15, 6.0)),), n_lanes=2))


# ------------------------------------------------------------ every lane
@pytest.mark.parametrize("case", ["paper-sweep", "transient-axis"])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_every_lane_equals_reference_numpy_backend(case, backend):
    port, ref = _ensembles(case)
    got = run_ensemble(port, scale=SCALE, n_datasets=ND, backend=backend,
                       device="cpu")
    want = jrun_ensemble(ref, scale=SCALE, n_datasets=ND, backend="numpy")
    assert got.engine == want.engine == "lanes"
    assert got.backend == ("torch:cpu" if backend == "torch" else "numpy")
    assert [_gate(r) for r in got.lanes] == [_gate(r) for r in want.lanes]
    assert [r.label for r in got.lanes] == [r.label for r in want.lanes]
    assert got.bands == want.bands
    if case == "transient-axis":
        assert got.lane(0).faults_total < got.lane(1).faults_total


def test_torch_backend_on_cpu_never_launches_the_kernel():
    before = kernel.launches
    port, _ = _ensembles("paper-sweep")
    run_ensemble(port, scale=SCALE, n_datasets=ND, **CPU)
    assert kernel.launches == before


def test_scalar_fallback_reports_numpy_and_equals_reference():
    port = dataclasses.replace(get_scenario("seed-sweep-federation"),
                               n_lanes=2)
    ref = dataclasses.replace(jget("seed-sweep-federation"), n_lanes=2)
    got = run_ensemble(port, scale=0.004, n_datasets=8, **CPU)
    want = jrun_ensemble(ref, scale=0.004, n_datasets=8)
    assert got.engine == "scalar" and got.backend == "numpy"
    assert got.to_json() == want.to_json()


# ------------------------------------------------------------ lane-0 gate
@pytest.mark.parametrize("name", ["ensemble-paper-bands", "aimd-search"])
def test_check_lane0_matches(name):
    espec = dataclasses.replace(get_scenario(name), n_lanes=2)
    out = check_lane0(espec, SCALE, ND, **CPU)
    assert out["match"], out["mismatches"]
    want = jcheck_lane0(dataclasses.replace(jget(name), n_lanes=2), SCALE,
                        ND, "numpy")
    assert out["engine"] == want["engine"] and out["seed"] == want["seed"]


def test_cli_check_lane0_and_bands(capsys):
    args = ["--ensemble", "ensemble-paper-bands", "--lanes", "2",
            "--datasets", str(ND), "--device", "cpu"]
    assert main(args + ["--check-lane0"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["match"] and out["backend"] == "torch:cpu"
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out)
    want = jrun_ensemble(dataclasses.replace(
        jget("ensemble-paper-bands"), n_lanes=2), scale=SCALE, n_datasets=ND)
    assert out["bands"] == want.bands


# --------------------------------------------------------- device default
@pytest.mark.parametrize("entry", ["run_ensemble", "search_driver",
                                   "run_search", "check_lane0", "cli"])
def test_default_device_is_cuda_and_raises_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("this case checks a machine without CUDA")
    espec, _ = _ensembles("paper-sweep")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "run_ensemble":
            run_ensemble(espec, scale=SCALE, n_datasets=ND)
        elif entry == "search_driver":
            SearchDriver(espec, scale=SCALE, n_datasets=ND)
        elif entry == "run_search":
            run_search(espec, scale=SCALE, n_datasets=ND)
        elif entry == "check_lane0":
            check_lane0(espec, SCALE, ND)
        else:
            main(["--ensemble", "ensemble-paper-bands", "--lanes", "2",
                  "--datasets", str(ND)])


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_search_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint cut to 3 of 6 lanes, written by one package, resumes in
    the other to the rows, winner and bands of a full run."""
    ckpt = str(tmp_path / "search.json")
    kw = dict(scale=SCALE, n_datasets=ND, chunk=2)
    port = EnsembleSpec("t-search", get_scenario("paper-2022"), n_lanes=6)
    ref = JEnsembleSpec("t-search", jget("paper-2022"), n_lanes=6)
    full = JSearchDriver(ref, backend="numpy", **kw).run()
    if writer == "jax":
        JSearchDriver(ref, checkpoint=ckpt, backend="numpy", **kw).run()
    else:
        SearchDriver(port, checkpoint=ckpt, **CPU, **kw).run()
    with open(ckpt) as f:
        state = json.load(f)
    state["done"] = state["done"][:3]
    with open(ckpt, "w") as f:
        json.dump(state, f)
    if writer == "jax":
        resumed = SearchDriver(port, checkpoint=ckpt, **CPU, **kw).run()
    else:
        resumed = JSearchDriver(ref, checkpoint=ckpt, backend="numpy",
                                **kw).run()
    assert resumed.rows == full.rows
    assert resumed.winner == full.winner
    assert resumed.bands == full.bands


def test_search_winner_equals_reference():
    port, ref = _ensembles("transient-axis")
    got = run_search(port, scale=SCALE, n_datasets=ND,
                     objective="faults_total", **CPU)
    want = JSearchDriver(ref, scale=SCALE, n_datasets=ND, backend="numpy",
                         objective="faults_total").run()
    assert got.to_json() == want.to_json()
    assert got.bench_entry() == want.bench_entry()
    assert got.winner["lane"] == 0


# ------------------------------------------------------ draws and reduction
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_fault_draws_equal_reference_solo_streams(seed):
    rng = np.random.default_rng(seed)
    n = 6
    seeds = [int(s) for s in rng.integers(0, 2 ** 31 - 1, n)]
    nbytes = [int(b) for b in rng.integers(1, 10 ** 13, n)]
    paths = [f"/css/ds-{i}" for i in range(n)]
    rate = float(rng.uniform(0.1, 20.0))
    marks, lens = BatchedFaultInjector(
        seeds, transient_per_tb=rate).transient_marks(paths, nbytes)
    for lane in range(n):
        solo = JFaultInjector(seeds[lane], transient_per_tb=rate
                              ).transient_marks(paths[lane], nbytes[lane])
        assert lens[lane] == len(solo)
        assert list(marks[lane, :lens[lane]]) == solo
        assert np.all(np.isinf(marks[lane, lens[lane]:]))


def test_quantile_bands_equal_reference_and_permutation_invariant():
    rng = np.random.default_rng(4)
    rows = [{"sim_days": float(v), "faults_total": int(i),
             "quarantined": int(i % 3)}
            for i, v in enumerate(rng.uniform(0.0, 1e4, 37))]
    perm = list(rows)
    rng.shuffle(perm)
    assert quantile_bands(rows) == jquantile_bands(rows)
    assert quantile_bands(rows) == quantile_bands(perm)
