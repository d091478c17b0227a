"""Crash-injection campaign scenarios: kill the world N times, resume, and
prove the trajectory is bit-identical to an uninterrupted run.

A ``CrashResumeSpec`` wraps a base registry scenario with a kill schedule
expressed as fractions of the uninterrupted run's iteration count.  Running
one is a three-act experiment:

  1. replay the base scenario uninterrupted and record its trajectory
     summary (iterations, simulated days, fault count, succeeded-set digest);
  2. replay it again, killing the process state at each scheduled iteration
     via ``Checkpointer(kill_after=...)`` — every kill leaves only the
     on-disk snapshot behind; the world object is discarded and rebuilt from
     the checkpoint with ``resume_world``;
  3. diff the resumed run's final trajectory summary against the reference —
     ``match`` must be exact, float equality included.

This is the operational property the paper's tool was built around
(progress in a database, the driver process disposable) turned into a
repeatable scenario family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.snapshot import (CampaignKilled, Checkpointer,
                                 federation_trajectory_summary, resume_world,
                                 trajectory_summary)
from repro_torch.scenarios.events import EngineStats, run_world


def summarize_trajectory(world, report, stats: EngineStats) -> Dict:
    """The bit-identity tuple for either world kind: per-member summaries
    for a federation, the single-campaign summary otherwise."""
    if hasattr(world, "runtimes"):
        return federation_trajectory_summary(report, stats, world)
    return trajectory_summary(report, stats, world.table)


@dataclass(frozen=True)
class CrashResumeSpec:
    """A named crash-injection scenario: ``base`` is a registry
    ``ScenarioSpec`` name; ``kill_fracs`` are kill points as fractions of the
    uninterrupted run's iteration count."""
    name: str
    description: str
    base: str
    kill_fracs: Tuple[float, ...] = (0.5,)
    engine: str = "events"


def run_crash_resume(spec: CrashResumeSpec, workdir: str,
                     scale: float = 1.0, seed: int = 0,
                     n_datasets: Optional[int] = None,
                     policy_static: bool = False) -> Dict:
    """Run the three-act kill/resume experiment; returns a report dict whose
    ``match`` field is the acceptance verdict.  ``policy_static`` forces the
    base scenario onto the naive static per-dataset policy (CLI ``--policy
    static``)."""
    from repro_torch.scenarios.registry import get_scenario
    base = get_scenario(spec.base)
    if isinstance(base, CrashResumeSpec):
        raise TypeError(f"{spec.name}: base scenario {spec.base!r} is itself "
                        "a crash-resume scenario")
    if policy_static and hasattr(base, "with_policy"):
        from repro_torch.control.policy import STATIC_POLICY
        base = base.with_policy(STATIC_POLICY)

    # act 1: the uninterrupted reference trajectory
    world = base.build(scale=scale, seed=seed, n_datasets=n_datasets)
    ref_stats = EngineStats()
    ref_report = run_world(world, engine=spec.engine, stats=ref_stats)
    reference = summarize_trajectory(world, ref_report, ref_stats)

    # the kill schedule in absolute iterations, strictly inside the run
    total = ref_stats.iterations
    kills = sorted({min(max(1, int(f * total)), total - 1)
                    for f in spec.kill_fracs})

    # act 2: kill at every scheduled point, resuming from disk each time
    world = base.build(scale=scale, seed=seed, n_datasets=n_datasets)
    stats = EngineStats()
    loop = None
    killed_at: List[int] = []
    report = None
    for k in kills:
        ck = Checkpointer(workdir, kill_after=k)
        try:
            report = run_world(world, engine=spec.engine, stats=stats,
                               checkpointer=ck, resume=loop)
            break                       # finished before this kill point
        except CampaignKilled as killed:
            killed_at.append(killed.iterations)
        world, _, loop = resume_world(workdir)
        stats = EngineStats()
    else:
        # act 3: final resume runs to completion
        report = run_world(world, engine=spec.engine, stats=stats, resume=loop)
    resumed = summarize_trajectory(world, report, stats)

    return {
        "scenario": spec.name,
        "base": spec.base,
        "engine": spec.engine,
        "kills": killed_at,
        "reference": reference,
        "resumed": resumed,
        "match": resumed == reference,
    }


# ------------------------------------------------------------ scenario family
CRASH_RESUME_PAPER = CrashResumeSpec(
    name="crash-resume-paper",
    description="Kill the paper-2022 replay at 35% and 70% of its "
                "iterations, resuming from the durable snapshot each time; "
                "the final trajectory must be bit-identical to an "
                "uninterrupted run.",
    base="paper-2022", kill_fracs=(0.35, 0.7))

CRASH_RESUME_STORM = CrashResumeSpec(
    name="crash-resume-storm",
    description="Three kills through the fault-storm scenario: heavy "
                "retry/backoff state and a hot fault-RNG stream must all "
                "survive resume.",
    base="fault-storm", kill_fracs=(0.25, 0.5, 0.75))

CRASH_RESUME_TOPUP = CrashResumeSpec(
    name="crash-resume-topup",
    description="Kill mid-campaign while incremental top-ups are still "
                "being published: the feed cursor, pending-publication set, "
                "and mid-run catalog additions must survive resume.",
    base="incremental-top-up", kill_fracs=(0.5,))

CRASH_RESUME_STEP = CrashResumeSpec(
    name="crash-resume-step",
    description="Kill/resume under the fixed-step driver — resume "
                "determinism must not depend on the event engine.",
    base="paper-2022", kill_fracs=(0.5,), engine="step")

CRASH_RESUME_FEDERATION = CrashResumeSpec(
    name="crash-resume-federation",
    description="Kill the overlapped two-campaign federation at ~50%: the "
                "shared clock/RNG/transport plus every member's scheduler "
                "and table must resume to identical per-member digests.",
    base="federation-paper-twice", kill_fracs=(0.5,))

CRASH_RESUME_POLICY = CrashResumeSpec(
    name="crash-resume-policy",
    description="Kill the adaptive small-file-storm campaign at ~50%: the "
                "bundle-composer cursor, already-cut bundles, controller "
                "internals, live route caps, and the policy ledger must "
                "all resume to a digest-identical trajectory.",
    base="small-file-storm", kill_fracs=(0.5,))

CRASH_RESUME_DEMAND = CrashResumeSpec(
    name="crash-resume-demand",
    description="Kill the esgf-serving campaign at ~50% with user traffic "
                "live: the request-workload RNG, popularity order, read "
                "caches, wave cursors, prioritized scheduler heaps, and the "
                "transport's read load must all resume to a digest-identical "
                "trajectory.",
    base="esgf-serving", kill_fracs=(0.5,))

CRASH_RESUME_SCRUB = CrashResumeSpec(
    name="crash-resume-scrub",
    description="Kill the scrub-and-repair campaign at ~50%, mid-scrub: the "
                "scrub anchor and cursor, at-risk/repairing ledgers, "
                "incarnation counters, and exposure accounting must all "
                "resume to a digest-identical corruption-free end state.",
    base="scrub-and-repair", kill_fracs=(0.5,))

CRASH_RESUME_SCENARIOS: Dict[str, CrashResumeSpec] = {
    s.name: s for s in (CRASH_RESUME_PAPER, CRASH_RESUME_STORM,
                        CRASH_RESUME_TOPUP, CRASH_RESUME_STEP,
                        CRASH_RESUME_FEDERATION, CRASH_RESUME_POLICY,
                        CRASH_RESUME_DEMAND, CRASH_RESUME_SCRUB)
}
