"""Event-driven simulation core: next-event time advance for N federated
campaigns over one shared world.

The seed campaign driver ticks a fixed 1800-second step for the whole
simulated campaign — thousands of scheduler passes where nothing changes.
This module instead advances the clock straight to the next *event*:

  * the next projected transfer completion / permission halt / scan finish
    (``SimulatedTransport.next_event_hint``, which folds pending fault-stall
    time into each estimate);
  * the next maintenance-window boundary of any site
    (``PauseManager.next_boundary``);
  * the next retry-backoff expiry (``ReplicationScheduler.next_backoff_expiry``)
    of any campaign;
  * the next scheduled human permission fix, incremental publication
    (top-up) check, or staggered campaign start.

``run_world`` drives either a single-campaign ``ScenarioWorld`` or a
``FederationWorld`` of N ``CampaignRuntime``s attached to one
``SharedWorld``: every runtime's candidates fold into one ``_next_event_dt``,
one clock advance, and one transport tick, so concurrent campaigns contend
through the shared fair-share rate allocator.  A 1-element federation
performs exactly the operations the single-campaign loop always performed —
the bit-identity anchor the determinism tests pin down.

Because ``SimulatedTransport._advance_mover`` is segment-exact (the transfer
trajectory is independent of how wall time is sliced into ticks), jumping
between events is behavior-preserving: the paper-2022 scenario reproduces the
step-driven duration and fault statistics within tolerance while replaying a
77-simulated-day campaign in a few hundred iterations instead of thousands.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.campaign import (CampaignReport, FederationReport, _bytes_at,
                                 aggregate_report, apply_human_fixes)
from repro_torch.core.pause import DAY
from repro_torch.core.snapshot import FederationLoopState, LoopState
from repro_torch.core.transport import SimClock
from repro_torch.scenarios.spec import FederationWorld

# guards: never advance by less than MIN_STEP_S (numerical safety), never by
# more than MAX_STEP_S (bounds drift if a hint source under-estimates)
MIN_STEP_S = 1.0
MAX_STEP_S = 12 * 3600.0


@dataclass
class EngineStats:
    """Driver telemetry: how many scheduler/transport iterations were spent."""
    iterations: int = 0
    sim_days: float = 0.0


def _next_event_dt(shared, runtimes, members, finished_at,
                   now: float) -> float:
    """Seconds until the next thing that can change scheduler-visible state
    in ANY attached campaign runtime."""
    cand = [shared.transport.next_event_hint()]
    cand.append(shared.pause.next_change(now) - now)
    for i, rt in enumerate(runtimes):
        if finished_at[i] is not None:
            continue
        if now < rt.start_s:
            cand.append(rt.start_s - now)  # staggered campaign start
            continue
        cand.append(rt.sched.next_backoff_expiry(now) - now)
        if rt.control is not None:
            cand.append(rt.control.next_action(now) - now)
        if rt.demand is not None:
            cand.append(rt.demand.next_wave(now) - now)
        if rt.scrub is not None:
            cand.append(rt.scrub.next_action(now) - now)
        if rt.obs is not None:
            cand.append(rt.obs.next_action(now) - now)
        for t in members[i].fix_at.values():
            if t > now:
                cand.append(t - now)
        if rt.incremental is not None:
            for t in rt.top_up_times:
                if t > now:
                    cand.append(t - now)
    dt = min((c for c in cand if c > 0), default=MAX_STEP_S)
    return max(MIN_STEP_S, min(dt, MAX_STEP_S))


def _outstanding_top_ups(rt) -> set:
    """Published datasets not yet admitted to the catalog (membership, not
    time comparison: the daily incremental check can lag an event that lands
    exactly on a publication timestamp).  Computed once per run; the driver
    shrinks the set as ``maybe_check`` admits paths, instead of rescanning
    the feed every iteration."""
    if rt.incremental is None:
        return set()
    return {d.path for _, d in rt.incremental.feed.all_events()
            if d.path not in rt.catalog}


def _fresh_loop_state(rt) -> LoopState:
    return LoopState(
        iterations=0, fix_at={},
        next_snap_day=float(int(rt.start_day)) + 1.0,
        timeline=[],
        pending_top_ups=_outstanding_top_ups(rt),
        feed_cursor=(rt.incremental.feed.count()
                     if rt.incremental is not None else 0))


def _copy_loop_state(ls: LoopState) -> LoopState:
    """Resume normalization: same copies the pre-federation loop made."""
    return LoopState(iterations=ls.iterations, fix_at=ls.fix_at,
                     next_snap_day=ls.next_snap_day, timeline=ls.timeline,
                     pending_top_ups=set(ls.pending_top_ups),
                     feed_cursor=ls.feed_cursor)


def run_world(world, engine: str = "events",
              stats: Optional[EngineStats] = None,
              on_iteration=None, checkpointer=None,
              resume=None):
    """Drive a compiled ``ScenarioWorld`` or ``FederationWorld`` to
    completion.

    ``engine="step"`` reproduces the seed driver (fixed ``cfg.step_s``
    cadence); ``engine="events"`` uses next-event time advance.  Both share
    the same transport/scheduler/human-fix code and the same aggregation.
    ``on_iteration(world, now)``, if given, is called once per driver
    iteration (after the scheduler passes, before the clock advances) — the
    observer hook the interactive example uses for progress display.

    ``checkpointer`` (a ``repro_torch.core.snapshot.Checkpointer``) is consulted at
    the top of every iteration — the loop's consistency boundary — and may
    write a durable snapshot and/or raise ``CampaignKilled`` after one.
    ``resume`` is the ``LoopState`` (single campaign) or
    ``FederationLoopState`` (federation) from
    ``repro_torch.core.snapshot.resume_world``; the loop then continues the killed
    campaign's trajectory bit-for-bit.

    Returns a ``CampaignReport`` for a ``ScenarioWorld`` and a
    ``FederationReport`` (one ``CampaignReport`` per member) for a
    ``FederationWorld``.  Federation members step only between their
    ``start_day`` and their own ``max_days`` deadline; a member that
    completes or times out is torn down (its in-flight transfers cancelled),
    releasing its fair-share slots to the surviving members.
    """
    if engine not in ("events", "step"):
        raise ValueError(f"unknown engine {engine!r}")
    fed = isinstance(world, FederationWorld)
    runtimes = world.runtimes if fed else [world.runtime]
    shared = world.shared
    clock, transport = shared.clock, shared.transport
    stats = stats if stats is not None else EngineStats()
    n = len(runtimes)
    if resume is not None:
        if fed:
            members = [_copy_loop_state(ls) for ls in resume.members]
            finished_at: List[Optional[float]] = list(resume.finished_at)
        else:
            members = [_copy_loop_state(resume)]
            finished_at = [None]
        stats.iterations = resume.iterations
    else:
        members = [_fresh_loop_state(rt) for rt in runtimes]
        finished_at = [None] * n
        stats.iterations = 0
    step_s = min(rt.cfg.step_s for rt in runtimes)
    horizon = max(rt.deadline_s for rt in runtimes)

    def _loop_state():
        if fed:
            return FederationLoopState(iterations=stats.iterations,
                                       members=members,
                                       finished_at=list(finished_at))
        ls = members[0]
        return LoopState(iterations=stats.iterations, fix_at=ls.fix_at,
                         next_snap_day=ls.next_snap_day,
                         timeline=ls.timeline,
                         pending_top_ups=ls.pending_top_ups,
                         feed_cursor=ls.feed_cursor)

    def _finish(i: int) -> None:
        finished_at[i] = clock.now
        # a finished campaign (done or timed out) releases whatever it still
        # holds in flight; trajectory-neutral for a lone campaign (the report
        # reads the table, not the transport archive)
        runtimes[i].sched.teardown()
        if runtimes[i].demand is not None:
            runtimes[i].demand.teardown()
        if runtimes[i].obs is not None:
            runtimes[i].obs.finalize(clock.now)

    while clock.now < horizon:
        # members past their own deadline time out and hand their capacity
        # back (a lone campaign's deadline IS the horizon — handled below)
        for i, rt in enumerate(runtimes):
            if finished_at[i] is None and clock.now >= rt.deadline_s:
                _finish(i)
        if all(f is not None for f in finished_at):
            break
        if checkpointer is not None:
            checkpointer.on_boundary(world, _loop_state(), engine)
        stats.iterations += 1
        active = [i for i, rt in enumerate(runtimes)
                  if finished_at[i] is None and clock.now >= rt.start_s]
        for i in active:
            # demand first: an admission wave re-keys priorities and updates
            # read load, then the control plane tops up the bundle feed and
            # tunes caps, so this pass's scheduler step sees both
            if runtimes[i].demand is not None:
                runtimes[i].demand.step(clock.now)
            if runtimes[i].control is not None:
                runtimes[i].control.step(clock.now)
            # scrub after the control plane, before the scheduler: a due
            # scan's repair flips land as FAILED rows this same pass, so the
            # scheduler step dispatches re-transfers alongside live work
            if runtimes[i].scrub is not None:
                runtimes[i].scrub.step(clock.now)
            runtimes[i].sched.step(clock.now)
            # observe last: the flight recorder samples the state this
            # pass produced, and never feeds anything back
            if runtimes[i].obs is not None:
                runtimes[i].obs.step(clock.now)
        for i in active:
            rt, ls = runtimes[i], members[i]
            apply_human_fixes(rt.notifier, ls.fix_at, clock.now,
                              rt.cfg.human_fix_days)
            if rt.incremental is not None:
                ls.pending_top_ups.difference_update(
                    rt.incremental.maybe_check(clock.now))
        if on_iteration is not None:
            on_iteration(world, clock.now)
        just_done: List[int] = []
        for i in active:
            rt, ls = runtimes[i], members[i]
            if rt.incremental is not None:
                feed = rt.incremental.feed
                if feed.count() > ls.feed_cursor:  # published mid-run (e.g.
                    ls.pending_top_ups.update(     # by the observer hook):
                        d.path                     # keep running
                        for _, d in feed.events_since(ls.feed_cursor)
                        if d.path not in rt.catalog)
                    ls.feed_cursor = feed.count()
            if (rt.sched.done() and not ls.pending_top_ups
                    and (rt.control is None or rt.control.exhausted())
                    and (rt.scrub is None or rt.scrub.exhausted())):
                _finish(i)
                just_done.append(i)
        done = all(f is not None for f in finished_at)
        if done and engine == "events":
            break           # stop exactly at the last event's timestamp
        dt = (step_s if engine == "step"
              else _next_event_dt(shared, runtimes, members, finished_at,
                                  clock.now))
        clock.advance(dt)
        transport.tick()
        if engine == "step":
            # the step driver advances once more after completion (seed
            # semantics); a member finishing this pass finishes at the
            # post-advance clock, exactly like the standalone loop
            for i in just_done:
                finished_at[i] = clock.now
        for i, rt in enumerate(runtimes):
            if finished_at[i] is not None and i not in just_done:
                continue    # long-finished members stop snapshotting
            if clock.now < rt.start_s:
                continue
            ls = members[i]
            if clock.now / DAY >= ls.next_snap_day:
                ls.timeline.append((clock.now / DAY,
                                    {r: _bytes_at(rt.table, r)
                                     for r in rt.cfg.replicas}))
                ls.next_snap_day = float(int(clock.now / DAY) + 1)
        if done:
            break           # step engine: mirror the seed driver's ordering
    for i in range(n):
        if finished_at[i] is None:
            _finish(i)      # horizon reached with work outstanding
    stats.sim_days = clock.now / DAY
    if not fed:
        rt, ls = runtimes[0], members[0]
        return aggregate_report(rt.cfg, shared.graph, rt.catalog, clock,
                                rt.table, rt.notifier, ls.timeline)
    reports: Dict[str, CampaignReport] = {}
    for i, rt in enumerate(runtimes):
        reports[rt.label] = aggregate_report(
            rt.cfg, shared.graph, rt.catalog, SimClock(finished_at[i]),
            rt.table, rt.notifier, members[i].timeline)
    return FederationReport(
        members=reports,
        started_day={rt.label: rt.start_day for rt in runtimes},
        finished_day={rt.label: finished_at[i] / DAY
                      for i, rt in enumerate(runtimes)},
        span_days=max(finished_at) / DAY)


def run_scenario(scenario, engine: str = "events", scale: float = 1.0,
                 seed: int = 0, n_datasets: Optional[int] = None,
                 stats: Optional[EngineStats] = None):
    """Build and run a scenario (or federation) by name or spec."""
    from repro_torch.scenarios.registry import get_scenario
    spec = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if not hasattr(spec, "build"):
        raise TypeError(
            f"{getattr(spec, 'name', spec)!r} is not a buildable scenario "
            "(crash-resume scenarios run via "
            "repro_torch.scenarios.crash_resume.run_crash_resume)")
    world = spec.build(scale=scale, seed=seed, n_datasets=n_datasets)
    return run_world(world, engine=engine, stats=stats)
