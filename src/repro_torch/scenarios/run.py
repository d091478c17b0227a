"""Scenario CLI.

    PYTHONPATH=src python -m repro_torch.scenarios.run --scenario paper-2022 \
        [--engine events|step] [--datasets N] [--scale S] [--seed K] \
        [--checkpoint-dir DIR] [--checkpoint-every K] [--kill-after N] \
        [--json out.json] [--verbose]
    PYTHONPATH=src python -m repro_torch.scenarios.run --resume DIR [...]
    PYTHONPATH=src python -m repro_torch.scenarios.run --list

Operating a campaign: pass ``--checkpoint-dir`` to write durable snapshots
every ``--checkpoint-every`` iterations and on SIGTERM/SIGINT.  A killed run
exits with code 3; ``--resume DIR`` continues it from the latest snapshot
with a bit-identical trajectory (the report's ``trajectory`` block — digest
included — matches the uninterrupted run's).  ``--kill-after N`` kills the
run deterministically at iteration N (CI's crash-resume equivalence check).

Crash-resume family scenarios (``--scenario crash-resume-*``) run the whole
kill/resume experiment against an uninterrupted reference and exit non-zero
unless the trajectories match.

Federation scenarios (``--scenario federation-*``) run N campaigns over one
shared simulated world; every flag above — ``--engine``, ``--datasets``,
``--scale``, ``--checkpoint-dir``, ``--kill-after``, ``--resume`` — works
unchanged (checkpoints then carry one table copy per member campaign).

Observability: ``--obs RUN.ndjson`` streams the flight recorder (lifecycle
trace + metrics samples) to a file, force-enabling trace+metrics when the
scenario does not declare its own ``ObsSpec``; ``--obs-cadence DAYS``
overrides the metrics sample interval; ``python -m repro_torch.obs.report
RUN.ndjson`` renders the post-mortem.  ``--profile`` adds per-phase
wall-time buckets to the report.  Observation never changes the
trajectory — the report's ``trajectory`` block (digest included) is
bit-identical with or without these flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from typing import Optional, Sequence

from repro_torch.core.campaign import FederationReport
from repro_torch.core.snapshot import (CampaignKilled, Checkpointer, SnapshotError,
                                 federation_trajectory_summary, resume_world,
                                 trajectory_summary)
from repro_torch.scenarios.crash_resume import CrashResumeSpec, run_crash_resume
from repro_torch.scenarios.events import EngineStats, run_world
from repro_torch.scenarios.registry import (get_scenario, list_crash_scenarios,
                                      list_federations, list_scenarios,
                                      scenario_tags)

EXIT_KILLED = 3


def report_to_dict(rep, stats: EngineStats, wall_s: float) -> dict:
    return {
        "wall_s": round(wall_s, 3),
        "engine_iterations": stats.iterations,
        "duration_days": round(rep.duration_days, 3),
        "floor_days": round(rep.floor_days, 3),
        "total_tb": round(rep.total_bytes / 1024 ** 4, 3),
        "bytes_at": {k: int(v) for k, v in rep.bytes_at.items()},
        "complete_at_all": all(v >= rep.total_bytes * 0.999
                               for v in rep.bytes_at.values()),
        "per_route_gbps": {f"{a}->{b}": round(v, 3)
                           for (a, b), v in rep.per_route_gbps.items()},
        "per_route_transfers": {f"{a}->{b}": v
                                for (a, b), v in rep.per_route_transfers.items()},
        "faults_total": rep.faults_total,
        "faults_mean": round(rep.faults_per_transfer_mean, 3),
        "faults_max": rep.faults_per_transfer_max,
        "fault_histogram": {str(k): v
                            for k, v in sorted(rep.fault_histogram.items())},
        "quarantined": rep.quarantined,
        "notifications": len(rep.notifications),
    }


def _member_report_to_dict(rep) -> dict:
    """A member campaign's slice of the federation report (no wall clock or
    iteration counts — those are shared across the federation)."""
    return {
        "duration_days": round(rep.duration_days, 3),
        "floor_days": round(rep.floor_days, 3),
        "total_tb": round(rep.total_bytes / 1024 ** 4, 3),
        "bytes_at": {k: int(v) for k, v in rep.bytes_at.items()},
        "complete_at_all": all(v >= rep.total_bytes * 0.999
                               for v in rep.bytes_at.values()),
        "per_route_gbps": {f"{a}->{b}": round(v, 3)
                           for (a, b), v in rep.per_route_gbps.items()},
        "per_route_transfers": {f"{a}->{b}": v
                                for (a, b), v in rep.per_route_transfers.items()},
        "faults_total": rep.faults_total,
        "quarantined": rep.quarantined,
        "notifications": len(rep.notifications),
    }


def federation_report_to_dict(rep: FederationReport, stats: EngineStats,
                              wall_s: float) -> dict:
    return {
        "wall_s": round(wall_s, 3),
        "engine_iterations": stats.iterations,
        "span_days": round(rep.span_days, 3),
        "started_day": {k: round(v, 3) for k, v in rep.started_day.items()},
        "finished_day": {k: round(v, 3) for k, v in rep.finished_day.items()},
        "members": {label: _member_report_to_dict(m)
                    for label, m in rep.members.items()},
    }


def _emit(doc: dict, json_path: Optional[str]) -> None:
    print(json.dumps(doc, indent=2))
    if json_path:
        with open(json_path, "w") as f:
            json.dump(doc, f, indent=2)


def _apply_obs(spec, args):
    """The spec the obs flags ask for: force ``FULL_OBS`` onto a scenario
    (or every federation member) that declared none, and apply a cadence
    override onto whatever is enabled."""
    import dataclasses as _dc

    from repro_torch.obs.spec import FULL_OBS
    if hasattr(spec, "members"):                # FederationSpec
        base = spec.members[0].scenario.obs
        declared = any(m.scenario.obs.enabled for m in spec.members)
    else:
        base = spec.obs
        declared = spec.obs.enabled
    if args.obs and not declared:
        base = FULL_OBS
    if args.obs_cadence is not None:
        base = _dc.replace(base, sample_interval_days=args.obs_cadence)
    return spec.with_obs(base)


def _obs_runtimes(world):
    """Every observed campaign runtime of a (possibly federation) world."""
    runtimes = (world.runtimes if hasattr(world, "runtimes")
                else [world.runtime])
    return [rt for rt in runtimes if rt is not None and rt.obs is not None]


def _run_crash_family(spec: CrashResumeSpec, args) -> int:
    if args.engine and args.engine != spec.engine:
        spec = dataclasses.replace(spec, engine=args.engine)
    workdir = args.checkpoint_dir or tempfile.mkdtemp(prefix="crash-resume-")
    t0 = time.time()
    res = run_crash_resume(spec, workdir, scale=args.scale, seed=args.seed,
                           n_datasets=args.datasets,
                           policy_static=args.policy == "static")
    res["wall_s"] = round(time.time() - t0, 3)
    res["checkpoint_dir"] = workdir
    _emit(res, args.json)
    return 0 if res["match"] else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios.run",
        description="Run a named replication-campaign scenario.")
    ap.add_argument("--scenario", default=None,
                    help="scenario name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--engine", choices=("events", "step"), default=None,
                    help="run-loop engine (default: events, or the snapshot's "
                         "engine when resuming)")
    ap.add_argument("--datasets", type=int, default=None,
                    help="override the catalog's dataset count")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="byte/file-count scale factor (1.0 = full 7.3 PB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=("declared", "static"),
                    default="declared",
                    help="transfer policy: the scenario's declared control "
                         "plane, or 'static' to force the naive per-dataset "
                         "fixed-concurrency baseline")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from the latest snapshot in DIR (scenario, "
                         "seed, scale, and engine come from the snapshot)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write durable snapshots into DIR (created on "
                         "demand); also where SIGTERM/SIGINT checkpoints land")
    ap.add_argument("--checkpoint-every", type=int, default=200,
                    metavar="K", help="snapshot cadence in run-loop iterations "
                                      "(default 200; 0 = only on kill/signal)")
    ap.add_argument("--kill-after", type=int, default=None, metavar="N",
                    help="checkpoint and exit (code 3) once N iterations have "
                         "run — deterministic crash injection")
    ap.add_argument("--json", default=None, help="also write the report here")
    ap.add_argument("--obs", default=None, metavar="RUN.ndjson",
                    help="stream the flight recorder (trace + metrics) to "
                         "this NDJSON file; enables trace+metrics when the "
                         "scenario does not declare observability")
    ap.add_argument("--obs-cadence", type=float, default=None, metavar="DAYS",
                    help="metrics sample interval in sim days (with --obs, "
                         "or overriding a declared ObsSpec)")
    ap.add_argument("--profile", action="store_true",
                    help="instrument the hot-path seams and report per-phase "
                         "wall-time buckets")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for name in (list_scenarios() + list_federations()
                     + list_crash_scenarios()):
            spec = get_scenario(name)
            tags = scenario_tags(spec)
            annot = f" [{','.join(tags)}]" if tags else ""
            print(f"{name:32}{annot:28} {spec.description}")
        return 0
    if not args.scenario and not args.resume:
        ap.error("--scenario or --resume is required (or use --list)")
    if args.scenario and args.resume:
        ap.error("--scenario and --resume are mutually exclusive")
    if args.resume and (args.obs or args.obs_cadence is not None):
        ap.error("--obs/--obs-cadence cannot be combined with --resume "
                 "(a resumed world is rebuilt from the scenario "
                 "declaration; declare an ObsSpec in the registry spec "
                 "instead)")

    if not args.resume:
        try:
            spec = get_scenario(args.scenario)
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
        if isinstance(spec, CrashResumeSpec):
            return _run_crash_family(spec, args)
        if args.policy == "static" and hasattr(spec, "with_policy"):
            from repro_torch.control.policy import STATIC_POLICY
            spec = spec.with_policy(STATIC_POLICY)
        if (args.obs or args.obs_cadence is not None) \
                and hasattr(spec, "with_obs"):
            spec = _apply_obs(spec, args)

    # install signal routing BEFORE the (potentially slow) world build, so a
    # SIGTERM at any point after startup exits through the checkpoint path
    ckpt_dir = args.checkpoint_dir or args.resume
    checkpointer = None
    if ckpt_dir or args.kill_after is not None:
        checkpointer = Checkpointer(
            ckpt_dir or tempfile.mkdtemp(prefix="campaign-ckpt-"),
            every=args.checkpoint_every, kill_after=args.kill_after)
        checkpointer.install_signal_handlers()

    resumed_from = None
    if args.resume:
        try:
            world, snap, loop = resume_world(args.resume)
        except (SnapshotError, FileNotFoundError, KeyError) as e:
            print(f"error: cannot resume from {args.resume!r}: {e}",
                  file=sys.stderr)
            return 2
        engine = args.engine or snap.engine
        spec = world.spec
        resumed_from = {"dir": args.resume, "iterations": snap.iterations}
    else:
        world = spec.build(scale=args.scale, seed=args.seed,
                           n_datasets=args.datasets)
        loop = None
        engine = args.engine or "events"
    if args.verbose:
        print(f"# {spec.name}: {spec.description}", file=sys.stderr)

    sink = None
    if args.obs:
        from repro_torch.obs.sink import ObsSink
        sink = ObsSink(args.obs)
        for rt in _obs_runtimes(world):
            rt.obs.attach_sink(sink)
    prof = None
    if args.profile:
        from repro_torch.obs.profile import PhaseProfiler
        prof = PhaseProfiler().instrument_standard()

    stats = EngineStats()
    t0 = time.time()
    try:
        rep = run_world(world, engine=engine, stats=stats,
                        checkpointer=checkpointer, resume=loop)
    except CampaignKilled as killed:
        _emit({"scenario": spec.name, "engine": engine, "killed": True,
               "iterations": killed.iterations,
               "checkpoint_dir": killed.checkpoint_dir,
               "resume_with": f"python -m repro_torch.scenarios.run "
                              f"--resume {killed.checkpoint_dir}"},
              args.json)
        return EXIT_KILLED
    finally:
        if prof is not None:
            prof.restore()
        if sink is not None:
            sink.close()
    if isinstance(rep, FederationReport):
        out = federation_report_to_dict(rep, stats, time.time() - t0)
        out["trajectory"] = federation_trajectory_summary(rep, stats, world)
        demand = {rt.label: rt.demand.summary() for rt in world.runtimes
                  if rt.demand is not None}
        if demand:
            out["demand"] = demand
        scrub = {rt.label: rt.scrub.summary() for rt in world.runtimes
                 if rt.scrub is not None}
        if scrub:
            out["scrub"] = scrub
        obs = {rt.label: rt.obs.summary() for rt in world.runtimes
               if rt.obs is not None}
        if obs:
            out["obs"] = obs
    else:
        out = report_to_dict(rep, stats, time.time() - t0)
        out["trajectory"] = trajectory_summary(rep, stats, world.table)
        if world.demand is not None:
            out["demand"] = world.demand.summary()
        if world.scrub is not None:
            out["scrub"] = world.scrub.summary()
        if world.obs is not None:
            out["obs"] = world.obs.summary()
    out["scenario"] = spec.name
    out["engine"] = engine
    if prof is not None:
        out["profile"] = prof.report(time.time() - t0)
    if resumed_from is not None:
        out["resumed_from"] = resumed_from
    if checkpointer is not None:
        out["checkpoints_written"] = checkpointer.writes
    _emit(out, args.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
