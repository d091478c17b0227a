"""The port's replication CLI, dashboard and reports against the JAX
package's, on the CPU (host numpy in both packages, no kernel).

* ``python -m repro_torch.scenarios.run --scenario paper-2022`` gives the
  reference's report at the ``engine_comparison`` shape (n=48, scale 1.0,
  seed 0: 474 iterations / 105.613 d / 703 faults) and at the ``scaling``
  n=2291 point (11383 iterations / 3151 faults): every field equal but
  ``wall_s``, the ``trajectory`` block and its digest included.
* ``--kill-after N --checkpoint-dir D`` exits 3 and names the package that
  resumes it; ``--resume D`` ends on the uninterrupted run's trajectory,
  also when the other package wrote D.
* The crash-resume family, a federation, ``--policy static``, ``--list``
  and ``--profile`` (the port's classes instrumented: non-zero buckets).
* ``--obs`` streams that render to the same ``obs.report`` text under both
  packages, each package reading the other's stream.
* A two-scenario sweep (n=40, scale 0.02, seeds 0 and 1) gives equal
  ``to_frame`` columns but the wall-time ones; ``emit_bench`` and the CLI
  write only where they are told (``BENCH_PATH`` stays relative to the
  working directory, as in the reference).
* Every dashboard renderer gives the reference's string on the same table
  state (mid-campaign, through the run loop's ``on_iteration`` hook).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import dashboard as jdash
from repro.obs import report as jreport
from repro.scenarios import events as jevents
from repro.scenarios import registry as jregistry
from repro.scenarios import run as jrun
from repro.scenarios import sweep as jsweep
from repro_torch.core import dashboard as dash
from repro_torch.obs import report
from repro_torch.obs.profile import PhaseProfiler
from repro_torch.scenarios import events
from repro_torch.scenarios import registry
from repro_torch.scenarios import run
from repro_torch.scenarios import sweep

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--datasets", "40", "--scale", "0.02"]
WALL_KEYS = ("wall_s", "events_per_s")
PKGS = {"jax": jrun, "torch": run}


def _run(mod, argv, tmp_path, name):
    """``mod.main(argv)``'s exit code and the report it wrote."""
    out = tmp_path / f"{name}.json"
    rc = mod.main(list(argv) + ["--json", str(out)])
    return rc, json.loads(out.read_text())


def _strip(rep):
    """A report without its wall-clock fields."""
    return {k: v for k, v in rep.items() if k not in WALL_KEYS}


# --------------------------------------------------------------- the run
@pytest.mark.parametrize("shape,n,iters,faults,days", [
    ("engine_comparison", 48, 474, 703, 105.613),
    ("scaling", 2291, 11383, 3151, None)])
def test_run_report_equals_reference(shape, n, iters, faults, days,
                                     tmp_path, capsys):
    argv = ["--scenario", "paper-2022", "--datasets", str(n), "--scale",
            "1.0", "--seed", "0"]
    rc, got = _run(run, argv, tmp_path, "torch")
    jrc, want = _run(jrun, argv, tmp_path, "jax")
    assert rc == jrc == 0
    assert got["trajectory"] == want["trajectory"]
    assert _strip(got) == _strip(want)
    assert got["engine_iterations"] == got["trajectory"]["iterations"] == iters
    assert got["faults_total"] == faults
    if days is not None:
        assert got["duration_days"] == days
    printed = json.loads(capsys.readouterr().out.split("\n}\n")[0] + "\n}")
    assert printed["trajectory"] == got["trajectory"]


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_kill_and_resume_across_packages(writer, reader, tmp_path):
    base = ["--scenario", "paper-2022", *SMALL, "--seed", "0"]
    _, whole = _run(run, base, tmp_path, "whole")
    ck = tmp_path / "ck"
    rc, killed = _run(PKGS[writer], base + ["--kill-after", "100",
                                            "--checkpoint-dir", str(ck)],
                      tmp_path, "killed")
    assert rc == run.EXIT_KILLED == jrun.EXIT_KILLED == 3
    assert killed["killed"] and killed["iterations"] == 100
    pkg = "repro_torch" if writer == "torch" else "repro"
    assert killed["resume_with"] == (f"python -m {pkg}.scenarios.run "
                                     f"--resume {ck}")
    rc, resumed = _run(PKGS[reader], ["--resume", str(ck)], tmp_path,
                       "resumed")
    assert rc == 0
    assert resumed["resumed_from"]["iterations"] == 100
    assert resumed["trajectory"] == whole["trajectory"]


@pytest.mark.parametrize("argv", [
    ["--scenario", "crash-resume-paper"],
    ["--scenario", "federation-paper-twice"],
    ["--scenario", "lossy-route-tuning", "--policy", "static"],
    ["--scenario", "paper-2022", "--engine", "step"],
], ids=["crash-resume", "federation", "static-policy", "step-engine"])
def test_scenario_families_equal_reference(argv, tmp_path):
    kw = ["--checkpoint-dir"] if "crash-resume-paper" in argv else []
    extra = SMALL + [*kw, *([str(tmp_path / "crash")] if kw else [])]
    rc, got = _run(run, argv + extra, tmp_path, "torch")
    if kw:
        extra[-1] = str(tmp_path / "crash-jax")
    jrc, want = _run(jrun, argv + extra, tmp_path, "jax")
    assert rc == jrc == 0
    got.pop("checkpoint_dir", None), want.pop("checkpoint_dir", None)
    assert _strip(got) == _strip(want)


def test_list_equals_reference():
    """In fresh processes: other test files register extra scenarios into
    the reference's registry of the process they share."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    got, want = (subprocess.run(
        [sys.executable, "-m", f"{pkg}.scenarios.run", "--list"], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)
        for pkg in ("repro_torch", "repro"))
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert "paper-2022" in got.stdout and "crash-resume-paper" in got.stdout


def test_unknown_scenario_exits_2(capsys):
    assert run.main(["--scenario", "no-such-scenario"]) == 2
    assert "no-such-scenario" in capsys.readouterr().err


def test_profile_buckets_the_port_run(tmp_path):
    rc, rep = _run(run, ["--scenario", "scrub-and-repair", *SMALL,
                         "--profile"], tmp_path, "prof")
    assert rc == 0
    phases = rep["profile"]["phases_s"]
    for bucket in ("sched", "transport", "table", "scrub"):
        assert phases[bucket] > 0, (bucket, phases)
    # the run's classes are the port's, and they are restored after it
    from repro_torch.core.scheduler import ReplicationScheduler
    with PhaseProfiler() as prof:
        before = ReplicationScheduler.step
        prof.instrument_standard()
        assert ReplicationScheduler.step is not before
    assert ReplicationScheduler.step is before


# ---------------------------------------------------------- obs reports
def test_obs_reports_equal_across_packages(tmp_path):
    streams = {}
    for name, mod in PKGS.items():
        streams[name] = tmp_path / f"{name}.ndjson"
        rc, rep = _run(mod, ["--scenario", "harsh-faults", *SMALL, "--obs",
                             str(streams[name])], tmp_path, name)
        assert rc == 0
    texts = {(r, s): rmod.render(rmod.load_stream(str(streams[s])))
             for r, rmod in (("jax", jreport), ("torch", report))
             for s in streams}
    assert len(set(texts.values())) == 1
    assert "records:" in texts["torch", "torch"]
    assert (report.load_stream(str(streams["torch"]))
            == jreport.load_stream(str(streams["jax"])))


def test_report_cli_writes_perfetto(tmp_path, capsys):
    stream = tmp_path / "run.ndjson"
    _run(run, ["--scenario", "harsh-faults", *SMALL, "--obs", str(stream)],
         tmp_path, "obs")
    capsys.readouterr()
    chrome = tmp_path / "trace.json"
    assert report.main([str(stream), "--top", "3", "--perfetto",
                        str(chrome)]) == 0
    text = capsys.readouterr().out
    assert jreport.main([str(stream), "--top", "3"]) == 0
    assert capsys.readouterr().out == text
    assert json.loads(chrome.read_text())["traceEvents"]
    assert report.main([str(stream), "--json"]) == 0
    assert jreport.main([str(stream), "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


# ---------------------------------------------------------------- sweep
def _frames_equal(rows, jrows):
    got, want = sweep.to_frame(rows), jsweep.to_frame(jrows)
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in WALL_KEYS:
            assert got[k] == want[k], k


def test_sweep_frames_equal_reference():
    variants = [sweep.Variant(name, n_datasets=40, scale=0.02, seed=seed)
                for name in ("paper-2022", "fault-storm") for seed in (0, 1)]
    jvariants = [jsweep.Variant(v.scenario, n_datasets=40, scale=0.02,
                                seed=v.seed) for v in variants]
    assert [v.label for v in variants] == [v.label for v in jvariants]
    _frames_equal(sweep.sweep(variants, processes=1),
                  jsweep.sweep(jvariants, processes=1))


def test_sweep_cli_writes_only_its_out(tmp_path, capsys, monkeypatch):
    bench = (REPO / "BENCH_scenarios.json").read_bytes()
    assert sweep.BENCH_PATH == jsweep.BENCH_PATH == "BENCH_scenarios.json"
    outs = {}
    for name, mod in (("torch", sweep), ("jax", jsweep)):
        outs[name] = tmp_path / f"{name}.json"
        (tmp_path / f"{name}.json").write_text(json.dumps({"keep": 1}))
        mod.main(["--scenarios", "paper-2022,fault-storm", "--seeds", "0,1",
                  "--datasets", "40", "--scale", "0.02", "--processes", "2",
                  "--out", str(outs[name])])
    assert (REPO / "BENCH_scenarios.json").read_bytes() == bench
    docs = {k: json.loads(p.read_text()) for k, p in outs.items()}
    assert docs["torch"]["keep"] == docs["jax"]["keep"] == 1   # merged
    _frames_equal(docs["torch"]["sweep"], docs["jax"]["sweep"])
    assert "4 variants -> " in capsys.readouterr().out
    # the default path is relative to the working directory
    monkeypatch.chdir(tmp_path)
    sweep.emit_bench(docs["torch"]["sweep"][:1])
    assert json.loads((tmp_path / "BENCH_scenarios.json").read_text())[
        "sweep"] == docs["torch"]["sweep"][:1]


# ------------------------------------------------------------ dashboard
def _renders(dmod, world, now):
    if hasattr(world, "runtimes"):
        return [dmod.render_federation_text(world, now)]
    dst = list(world.cfg.replicas)
    total = sum(d.bytes for d in world.catalog.values())
    out = [dmod.render_text(world.table, dst, total, now),
           dmod.render_json(world.table, dst, total, now),
           dmod.render_progress([("c", world.table, dst, total)], now)]
    for name, render in (("control", dmod.render_policy_text),
                         ("demand", dmod.render_demand_text),
                         ("scrub", dmod.render_scrub_text),
                         ("obs", dmod.render_obs_text)):
        part = getattr(world, name)
        if part is not None:
            out.append(render(part, now))
    return out


@pytest.mark.parametrize("scenario", [
    "corrupt-under-demand", "lossy-route-tuning", "harsh-faults",
    "federation-paper-and-topup"])
def test_dashboard_renderers_equal_reference(scenario):
    seen = {}
    for name, reg, ev, dmod in (("torch", registry, events, dash),
                                ("jax", jregistry, jevents, jdash)):
        world = reg.get_scenario(scenario).build(scale=0.02, seed=0,
                                                 n_datasets=40)
        got = []

        def hook(w, now, got=got, dmod=dmod):
            if len(got) < 3 and int(now) % 7 == 0 and now > 0:
                got.append(_renders(dmod, w, now))
        ev.run_world(world, on_iteration=hook)
        got.append(_renders(dmod, world, world.clock.now))
        seen[name] = got
    assert len(seen["torch"]) >= 2
    assert seen["torch"] == seen["jax"]
