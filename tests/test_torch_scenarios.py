"""The port's scenario engine against the JAX package's.

The scenario specs, the event engine, the control, demand, scrub and
observability subsystems and the snapshots are host numpy / sqlite / stdlib
code in both packages and follow the same operations, so registries,
trajectories, digests and snapshots must be exactly equal, and a snapshot
written by either package must resume in the other.
"""
import dataclasses
import enum

import pytest

from repro.core import snapshot as jsnap
from repro.ensemble.engine import scalar_lane as jscalar_lane
from repro.scenarios import crash_resume as jcrash
from repro.scenarios import events as jevents
from repro.scenarios import registry as jreg
from repro_torch.core import snapshot as tsnap
from repro_torch.ensemble.engine import scalar_lane as tscalar_lane
from repro_torch.scenarios import crash_resume as tcrash
from repro_torch.scenarios import events as tevents
from repro_torch.scenarios import registry as treg

# the shape of BENCH_scenarios.json's ``sweep`` block
SWEEP = dict(scale=0.02, n_datasets=40)


def _plain(x):
    """A spec as plain data: dataclasses as dicts tagged with their class
    name, enum members as their values (the packages' classes are distinct
    objects with equal fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__class__": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


# --------------------------------------------------------------- registries
def test_registry_listings_are_equal():
    for fn in ("list_scenarios", "list_federations", "list_crash_scenarios",
               "list_ensembles"):
        assert getattr(treg, fn)() == getattr(jreg, fn)(), fn
        assert getattr(treg, fn)(), fn


ALL_NAMES = (jreg.list_scenarios() + jreg.list_federations()
             + jreg.list_crash_scenarios() + jreg.list_ensembles())


@pytest.mark.parametrize("name", ALL_NAMES)
def test_registered_spec_equals_reference(name):
    port, want = treg.get_scenario(name), jreg.get_scenario(name)
    assert _plain(port) == _plain(want)
    assert treg.scenario_tags(port) == jreg.scenario_tags(want)


# ------------------------------------------------------------ trajectories
@pytest.mark.parametrize("name",
                         jreg.list_scenarios() + jreg.list_federations())
def test_scenario_trajectory_equals_reference(name):
    """Iterations, sim days, faults, quarantined, bytes per replica and the
    succeeded-set digest of one events-engine replay, at the sweep shape."""
    port = tscalar_lane(treg.get_scenario(name), 0, {}, **SWEEP)
    want = jscalar_lane(jreg.get_scenario(name), 0, {}, **SWEEP)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    assert port.iterations > 0 and port.succeeded_digest


def test_crash_resume_scenario_equals_reference(tmp_path):
    name = "crash-resume-storm"
    port = tcrash.run_crash_resume(treg.get_scenario(name),
                                   str(tmp_path / "port"), seed=0, **SWEEP)
    want = jcrash.run_crash_resume(jreg.get_scenario(name),
                                   str(tmp_path / "jax"), seed=0, **SWEEP)
    assert port == want
    assert port["match"] and len(port["kills"]) == 3


# --------------------------------------------------------------- snapshots
PACKAGES = {"jax": (jreg, jevents, jsnap, jcrash),
            "port": (treg, tevents, tsnap, tcrash)}


@pytest.mark.parametrize("scenario", ["paper-2022", "federation-paper-twice"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshot_resumes_across_packages(tmp_path, scenario, writer, reader):
    """Kill a run half way in one package, resume its on-disk snapshot in
    the other: the final trajectory tuple, digests included, equals an
    uninterrupted run's."""
    wreg, wevents, wsnap, _ = PACKAGES[writer]
    rreg, revents, rsnap, rcrash = PACKAGES[reader]

    world = rreg.get_scenario(scenario).build(seed=0, **SWEEP)
    stats = revents.EngineStats()
    report = revents.run_world(world, stats=stats)
    want = rcrash.summarize_trajectory(world, report, stats)

    world = wreg.get_scenario(scenario).build(seed=0, **SWEEP)
    with pytest.raises(wsnap.CampaignKilled):
        wevents.run_world(world, stats=wevents.EngineStats(),
                          checkpointer=wsnap.Checkpointer(
                              str(tmp_path), kill_after=stats.iterations // 2))

    world, snap, loop = rsnap.resume_world(str(tmp_path))
    assert loop.iterations == stats.iterations // 2
    stats = revents.EngineStats()
    report = revents.run_world(world, engine=snap.engine, stats=stats,
                               resume=loop)
    assert rcrash.summarize_trajectory(world, report, stats) == want


# BENCH_scenarios.json's engine_comparison: paper-2022, 48 datasets, scale
# 1.0, seed 0 (iterations, duration days, faults, the most on one transfer)
ENGINE_PIN = {"step": (5096, 106.167, 703, 195),
              "events": (474, 105.613, 703, 195)}


@pytest.mark.parametrize("engine", ENGINE_PIN)
def test_paper_campaign_engines_pinned(engine):
    """Both engines at the engine_comparison shape: the port's run equals
    the reference's and the numbers the repo has recorded for it."""
    got = []
    for events in (jevents, tevents):
        stats = events.EngineStats()
        rep = events.run_scenario("paper-2022", engine=engine, scale=1.0,
                                  seed=0, n_datasets=48, stats=stats)
        got.append((stats.iterations, round(rep.duration_days, 3),
                    rep.faults_total, rep.faults_per_transfer_max))
    assert got[1] == got[0] == ENGINE_PIN[engine]
