"""Durable campaign checkpoint/resume (paper §3: "restart and recover from a
variety of transient failures... largely automatically").

The paper's replication tool survived arbitrary process deaths because all
progress lived in a database.  Our ``TransferTable`` is already durable, but
the *driver* carries deterministic state only in memory: the simulation
clock, the fault-RNG stream position, the scheduler's pending/backoff heaps,
the transport's live-mover pool, and the run loop's cursors.  A
``CampaignSnapshot`` serializes all of it, versioned, next to an atomic copy
of the sqlite transfer table — so a campaign killed at ANY iteration resumes
from its last checkpoint and replays a **bit-identical** trajectory (same
iteration count, simulated days, fault sequence, and succeeded-set digest)
to an uninterrupted run.

Checkpoint directory layout (all writes are temp-file + ``os.replace``)::

    <dir>/snapshot-00001234.json   # CampaignSnapshot at iteration 1234
    <dir>/table-00001234.sqlite    # matching TransferTable copy
    <dir>/LATEST                   # name of the newest complete snapshot

``LATEST`` is renamed into place only after both files land, so a crash
mid-checkpoint leaves the previous snapshot authoritative.  Older epochs are
garbage-collected (``Checkpointer.keep``).

Determinism contract: every float round-trips exactly (``json`` emits
shortest-repr doubles), the RNG serializes its bit-generator state, heaps
serialize in heap order, and dicts preserve insertion order — so the resumed
process performs the same arithmetic in the same order as the killed one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.transfer_table import Status, TransferTable

# v2: adds the control-plane block (bundle-composer cursor + cut bundles,
# controller internals, live per-route caps, policy ledger) and the
# transport's per-route telemetry counters + per-task setup cursor
# v3: adds the demand block (request-workload RNG + popularity order, read
# caches, wave cursors, serving counters) and the transport's user read load
# v4: adds the scrub block (scan anchor/cursor, per-replica integrity ledger
# with incarnation counts, data-at-risk counters), so a kill mid-scrub
# resumes the scrub/repair campaign digest-identically
#
# The flight recorder (repro_torch.obs) is deliberately NOT snapshotted: observers
# are rebuilt fresh on resume, and snapshot bytes are identical with obs on
# or off — part of the obs bit-identity contract.
SNAPSHOT_VERSION = 4
FEDERATION_SNAPSHOT_VERSION = 4
FEDERATION_KIND = "federation"
SNAPSHOT_PREFIX = "snapshot-"
TABLE_PREFIX = "table-"
LATEST_FILE = "LATEST"


class SnapshotError(RuntimeError):
    """Malformed or inconsistent checkpoint state."""


class SnapshotVersionError(SnapshotError):
    """Snapshot written by an incompatible serialization version."""


class CampaignKilled(RuntimeError):
    """Raised by the run loop after a requested kill (signal or
    ``kill_after``) once a consistent snapshot has been written."""

    def __init__(self, checkpoint_dir: str, iterations: int):
        super().__init__(
            f"campaign killed at iteration {iterations}; resume with "
            f"--resume {checkpoint_dir}")
        self.checkpoint_dir = checkpoint_dir
        self.iterations = iterations


@dataclass
class LoopState:
    """The ``run_world`` loop's own mutable state, checkpointed alongside the
    world and handed back on resume."""
    iterations: int = 0
    fix_at: Dict[str, float] = field(default_factory=dict)
    next_snap_day: float = 1.0
    timeline: List[Tuple[float, Dict[str, int]]] = field(default_factory=list)
    pending_top_ups: Set[str] = field(default_factory=set)
    feed_cursor: int = 0


@dataclass
class FederationLoopState:
    """The federated run loop's mutable state: one ``LoopState`` per member
    runtime plus the shared iteration counter and each member's completion
    time (``None`` while it is still running)."""
    iterations: int = 0
    members: List[LoopState] = field(default_factory=list)
    finished_at: List[Optional[float]] = field(default_factory=list)


@dataclass
class CampaignSnapshot:
    """Versioned, JSON-serializable image of everything that determines the
    rest of a campaign's trajectory (the transfer table itself lives in the
    sibling sqlite file named by ``table_file``)."""
    version: int
    scenario: str                 # registry name used to rebuild the world
    engine: str                   # "events" | "step"
    scale: float
    seed: int
    n_datasets: Optional[int]
    table_file: str
    clock_now: float
    injector: dict                # FaultInjector.state_dict()
    notifier: dict                # Notifier.state_dict()
    scheduler: dict               # ReplicationScheduler.state_dict()
    transport: dict               # SimulatedTransport.state_dict()
    iterations: int
    fix_at: Dict[str, float]
    next_snap_day: float
    timeline: List[Tuple[float, Dict[str, int]]]
    pending_top_ups: List[str]
    feed_cursor: int
    incremental_last_check: float
    admitted_top_ups: List[str]
    control: Optional[dict]       # ControlPlane.state_dict(); None = static
    demand: Optional[dict]        # DemandEngine.state_dict(); None = no users
    scrub: Optional[dict]         # ScrubEngine.state_dict(); None = no rot
    # True when the run forced the static per-dataset baseline (CLI
    # --policy static): resume must re-apply the override instead of
    # rebuilding the registry scenario's declared (possibly adaptive) policy
    policy_static: bool

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dumps(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignSnapshot":
        version = d.get("version")
        if version != SNAPSHOT_VERSION:
            raise SnapshotVersionError(
                f"snapshot version {version!r} is not supported "
                f"(this build reads version {SNAPSHOT_VERSION}); "
                "re-run the campaign or use the writing build to resume")
        kw = dict(d)
        # canonicalize the JSON list-of-lists back to the in-memory shapes
        kw["timeline"] = [(float(t), {k: int(v) for k, v in b.items()})
                          for t, b in d["timeline"]]
        kw["pending_top_ups"] = list(d["pending_top_ups"])
        kw["admitted_top_ups"] = list(d["admitted_top_ups"])
        names = {f.name for f in dataclasses.fields(cls)}
        extra = set(kw) - names
        if extra:
            raise SnapshotError(f"unknown snapshot fields: {sorted(extra)}")
        missing = names - set(kw)
        if missing:
            raise SnapshotError(f"missing snapshot fields: {sorted(missing)}")
        return cls(**kw)

    @classmethod
    def loads(cls, text: str) -> "CampaignSnapshot":
        return cls.from_dict(json.loads(text))


@dataclass
class FederationSnapshot:
    """Versioned, JSON-serializable image of a federated run: the shared
    substrate's state (clock, fault RNG, transport) once, plus one runtime
    block per member campaign (scheduler queues, notifier, loop cursors, and
    the name of its sibling sqlite table copy).  Discriminated from a
    single-campaign ``CampaignSnapshot`` by ``kind == "federation"``."""
    version: int
    kind: str
    federation: str               # registry name used to rebuild the world
    engine: str                   # "events" | "step"
    scale: float
    seed: int
    n_datasets: Optional[int]
    clock_now: float
    iterations: int
    injector: dict                # FaultInjector.state_dict()
    transport: dict               # SimulatedTransport.state_dict()
    finished_at: List[Optional[float]]
    runtimes: List[dict]          # per-member blocks, member order
    policy_static: bool           # run forced the static per-dataset policy

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dumps(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "FederationSnapshot":
        if d.get("kind") != FEDERATION_KIND:
            raise SnapshotError(
                f"not a federation snapshot (kind={d.get('kind')!r})")
        version = d.get("version")
        if version != FEDERATION_SNAPSHOT_VERSION:
            raise SnapshotVersionError(
                f"federation snapshot version {version!r} is not supported "
                f"(this build reads version {FEDERATION_SNAPSHOT_VERSION}); "
                "re-run the campaign or use the writing build to resume")
        kw = dict(d)
        kw["finished_at"] = [None if f is None else float(f)
                             for f in d["finished_at"]]
        kw["runtimes"] = [dict(r) for r in d["runtimes"]]
        names = {f.name for f in dataclasses.fields(cls)}
        extra = set(kw) - names
        if extra:
            raise SnapshotError(f"unknown snapshot fields: {sorted(extra)}")
        missing = names - set(kw)
        if missing:
            raise SnapshotError(f"missing snapshot fields: {sorted(missing)}")
        _RUNTIME_KEYS = {"label", "scenario", "start_day", "table_file",
                         "scheduler", "notifier", "fix_at", "next_snap_day",
                         "timeline", "pending_top_ups", "feed_cursor",
                         "incremental_last_check", "admitted_top_ups",
                         "control", "demand", "scrub"}
        for r in kw["runtimes"]:
            if set(r) != _RUNTIME_KEYS:
                raise SnapshotError(
                    f"malformed runtime block for "
                    f"{r.get('label', '?')!r}: fields "
                    f"{sorted(set(r) ^ _RUNTIME_KEYS)} unexpected/missing")
        return cls(**kw)

    @classmethod
    def loads(cls, text: str) -> "FederationSnapshot":
        return cls.from_dict(json.loads(text))


# ---------------------------------------------------------------- capture/apply
def capture_snapshot(world, loop: LoopState, engine: str,
                     table_file: str) -> CampaignSnapshot:
    """Snapshot a ``ScenarioWorld`` at a run-loop boundary.  Read-only: the
    world's trajectory is unchanged whether or not a snapshot was taken."""
    feed_events = (world.incremental.feed.all_events()
                   if world.incremental is not None else [])
    # archive entries matter only while their row still occupies a slot (the
    # scheduler polls each terminal uid exactly once); serializing just those
    # keeps the snapshot O(active transfers), not O(campaign history)
    pollable = {rec.uuid
                for rec in world.table.by_status(Status.ACTIVE, Status.QUEUED,
                                                 Status.PAUSED)
                if rec.uuid is not None}
    return CampaignSnapshot(
        version=SNAPSHOT_VERSION,
        scenario=world.spec.name,
        engine=engine,
        scale=world.scale,
        seed=world.seed,
        n_datasets=world.n_datasets,
        table_file=table_file,
        clock_now=world.clock.now,
        injector=world.transport.injector.state_dict(),
        notifier=world.notifier.state_dict(),
        scheduler=world.sched.state_dict(),
        transport=world.transport.state_dict(archive_uids=pollable),
        iterations=loop.iterations,
        fix_at=dict(loop.fix_at),
        next_snap_day=loop.next_snap_day,
        timeline=[(t, dict(b)) for t, b in loop.timeline],
        pending_top_ups=sorted(loop.pending_top_ups),
        feed_cursor=loop.feed_cursor,
        incremental_last_check=(world.incremental._last_check
                                if world.incremental is not None else 0.0),
        admitted_top_ups=sorted(d.path for _, d in feed_events
                                if d.path in world.catalog),
        control=(world.control.state_dict()
                 if world.control is not None else None),
        demand=(world.demand.state_dict()
                if world.demand is not None else None),
        scrub=(world.scrub.state_dict()
               if world.scrub is not None else None),
        policy_static=not world.spec.policy.enabled,
    )


def apply_snapshot(world, snap: CampaignSnapshot) -> LoopState:
    """Overwrite a freshly built world's mutable state with the snapshot's.
    The world must have been built from the same spec/scale/seed (and over
    the snapshot's restored table).  Returns the loop state to resume with."""
    if snap.scenario != world.spec.name:
        raise SnapshotError(
            f"snapshot is for scenario {snap.scenario!r}, world is "
            f"{world.spec.name!r}")
    if world.incremental is not None:
        by_path = {d.path: d
                   for _, d in world.incremental.feed.all_events()}
        for p in snap.admitted_top_ups:
            world.catalog[p] = by_path[p]   # before live movers re-bind
        world.incremental._last_check = snap.incremental_last_check
    elif snap.admitted_top_ups:
        raise SnapshotError("snapshot has top-ups but the scenario has no "
                            "incremental feed")
    if (snap.control is None) != (world.control is None):
        raise SnapshotError(
            "snapshot and world disagree about the control plane — the "
            "scenario's transfer policy changed since the snapshot was "
            "written")
    if world.control is not None:
        # restore the composer cursor / cut bundles BEFORE re-binding the
        # transport's live movers: movers may reference bundle paths
        world.control.load_state_dict(snap.control)
    if (snap.demand is None) != (world.demand is None):
        raise SnapshotError(
            "snapshot and world disagree about the demand engine — the "
            "scenario's demand spec changed since the snapshot was written")
    world.clock.now = snap.clock_now
    world.transport.injector.load_state_dict(snap.injector)
    world.notifier.load_state_dict(snap.notifier)
    world.sched.load_state_dict(snap.scheduler)
    world.transport.load_state_dict(snap.transport,
                                    world.runtime.binding_catalog())
    if world.demand is not None:
        # after the scheduler: its restored direct heaps already carry the
        # killed run's priorities verbatim, and the replica catalog was
        # rebuilt by table-listener adoption at build time
        world.demand.load_state_dict(snap.demand)
    if (snap.scrub is None) != (world.scrub is None):
        raise SnapshotError(
            "snapshot and world disagree about the scrub engine — the "
            "scenario's scrub spec changed since the snapshot was written")
    if world.scrub is not None:
        # replaces the constructor's table-adoption ledger with the killed
        # run's exact incarnation counts, at-risk/repairing sets, and cursor
        world.scrub.load_state_dict(snap.scrub)
    return LoopState(
        iterations=snap.iterations,
        fix_at=dict(snap.fix_at),
        next_snap_day=snap.next_snap_day,
        timeline=[(t, dict(b)) for t, b in snap.timeline],
        pending_top_ups=set(snap.pending_top_ups),
        feed_cursor=snap.feed_cursor)


# -------------------------------------------------------- federation capture
def _capture_runtime(rt, ls: LoopState, table_file: str) -> dict:
    """One member campaign's snapshot block (the table itself lives in the
    sibling sqlite file named by ``table_file``)."""
    feed_events = (rt.incremental.feed.all_events()
                   if rt.incremental is not None else [])
    return {
        "label": rt.label,
        "scenario": rt.spec.name,
        "start_day": rt.start_day,
        "table_file": table_file,
        "scheduler": rt.sched.state_dict(),
        "notifier": rt.notifier.state_dict(),
        "fix_at": dict(ls.fix_at),
        "next_snap_day": ls.next_snap_day,
        "timeline": [(t, dict(b)) for t, b in ls.timeline],
        "pending_top_ups": sorted(ls.pending_top_ups),
        "feed_cursor": ls.feed_cursor,
        "incremental_last_check": (rt.incremental._last_check
                                   if rt.incremental is not None else 0.0),
        "admitted_top_ups": sorted(d.path for _, d in feed_events
                                   if d.path in rt.catalog),
        "control": (rt.control.state_dict()
                    if rt.control is not None else None),
        "demand": (rt.demand.state_dict()
                   if rt.demand is not None else None),
        "scrub": (rt.scrub.state_dict()
                  if rt.scrub is not None else None),
    }


def capture_federation_snapshot(world, loop: "FederationLoopState",
                                engine: str,
                                table_files: Sequence[str]
                                ) -> FederationSnapshot:
    """Snapshot a ``FederationWorld`` at a run-loop boundary: the shared
    clock/RNG/transport once, one block per member runtime."""
    pollable = set()
    for rt in world.runtimes:
        pollable.update(
            rec.uuid
            for rec in rt.table.by_status(Status.ACTIVE, Status.QUEUED,
                                          Status.PAUSED)
            if rec.uuid is not None)
    return FederationSnapshot(
        version=FEDERATION_SNAPSHOT_VERSION,
        kind=FEDERATION_KIND,
        federation=world.spec.name,
        engine=engine,
        scale=world.scale,
        seed=world.seed,
        n_datasets=world.n_datasets,
        clock_now=world.shared.clock.now,
        iterations=loop.iterations,
        injector=world.shared.transport.injector.state_dict(),
        transport=world.shared.transport.state_dict(archive_uids=pollable),
        finished_at=list(loop.finished_at),
        runtimes=[_capture_runtime(rt, ls, tf)
                  for rt, ls, tf in zip(world.runtimes, loop.members,
                                        table_files)],
        policy_static=(world.spec.policy is not None
                       and not world.spec.policy.enabled),
    )


def _apply_runtime(rt, block: dict) -> LoopState:
    """Overwrite one freshly built member runtime's mutable state with its
    snapshot block; returns the member's loop state."""
    if block["scenario"] != rt.spec.name or block["label"] != rt.label:
        raise SnapshotError(
            f"snapshot member {block['label']!r} ({block['scenario']!r}) "
            f"does not match built runtime {rt.label!r} ({rt.spec.name!r})")
    if rt.incremental is not None:
        by_path = {d.path: d for _, d in rt.incremental.feed.all_events()}
        for p in block["admitted_top_ups"]:
            rt.catalog[p] = by_path[p]   # before live movers re-bind
        rt.incremental._last_check = block["incremental_last_check"]
    elif block["admitted_top_ups"]:
        raise SnapshotError(f"member {rt.label!r} snapshot has top-ups but "
                            "the scenario has no incremental feed")
    if (block["control"] is None) != (rt.control is None):
        raise SnapshotError(
            f"member {rt.label!r}: snapshot and world disagree about the "
            "control plane — the member's transfer policy changed")
    if rt.control is not None:
        rt.control.load_state_dict(block["control"])
    if (block["demand"] is None) != (rt.demand is None):
        raise SnapshotError(
            f"member {rt.label!r}: snapshot and world disagree about the "
            "demand engine — the member's demand spec changed")
    rt.notifier.load_state_dict(block["notifier"])
    rt.sched.load_state_dict(block["scheduler"])
    if rt.demand is not None:
        rt.demand.load_state_dict(block["demand"])
    if (block["scrub"] is None) != (rt.scrub is None):
        raise SnapshotError(
            f"member {rt.label!r}: snapshot and world disagree about the "
            "scrub engine — the member's scrub spec changed")
    if rt.scrub is not None:
        rt.scrub.load_state_dict(block["scrub"])
    return LoopState(
        iterations=0,
        fix_at=dict(block["fix_at"]),
        next_snap_day=block["next_snap_day"],
        timeline=[(float(t), {k: int(v) for k, v in b.items()})
                  for t, b in block["timeline"]],
        pending_top_ups=set(block["pending_top_ups"]),
        feed_cursor=block["feed_cursor"])


def apply_federation_snapshot(world, snap: FederationSnapshot
                              ) -> "FederationLoopState":
    """Overwrite a freshly built ``FederationWorld``'s mutable state with the
    snapshot's.  Returns the loop state to resume with."""
    if snap.federation != world.spec.name:
        raise SnapshotError(
            f"snapshot is for federation {snap.federation!r}, world is "
            f"{world.spec.name!r}")
    if len(snap.runtimes) != len(world.runtimes):
        raise SnapshotError(
            f"snapshot has {len(snap.runtimes)} member runtimes, world has "
            f"{len(world.runtimes)}")
    members = [_apply_runtime(rt, block)
               for rt, block in zip(world.runtimes, snap.runtimes)]
    world.shared.clock.now = snap.clock_now
    world.shared.transport.injector.load_state_dict(snap.injector)
    world.shared.transport.load_state_dict(snap.transport,
                                           world.merged_catalog())
    return FederationLoopState(
        iterations=snap.iterations,
        members=members,
        finished_at=[None if f is None else float(f)
                     for f in snap.finished_at])


# --------------------------------------------------------------------- loading
def _reapply_static_policy(spec, snap):
    """A run launched with the static-policy override (CLI ``--policy
    static``) must resume under that same override — the registry scenario's
    declared policy may be adaptive, and rebuilding with it would leave the
    world with a control plane the snapshot never had.  Idempotent for
    scenarios whose declared policy is already static."""
    if not snap.policy_static or not hasattr(spec, "with_policy"):
        return spec
    from repro_torch.control.policy import STATIC_POLICY
    return spec.with_policy(STATIC_POLICY)


def load_snapshot(ckpt_dir: str):
    """The newest complete snapshot in ``ckpt_dir`` (via ``LATEST``): a
    ``CampaignSnapshot`` or, for federated runs, a ``FederationSnapshot``
    (discriminated by the JSON ``kind`` field)."""
    latest = os.path.join(ckpt_dir, LATEST_FILE)
    if not os.path.exists(latest):
        raise SnapshotError(f"no {LATEST_FILE} in {ckpt_dir!r} — not a "
                            "checkpoint directory, or no snapshot completed")
    with open(latest) as f:
        name = f.read().strip()
    with open(os.path.join(ckpt_dir, name)) as f:
        d = json.loads(f.read())
    if d.get("kind") == FEDERATION_KIND:
        return FederationSnapshot.from_dict(d)
    return CampaignSnapshot.from_dict(d)


def resume_world(ckpt_dir: str, spec=None):
    """Rebuild a runnable world from the newest snapshot in ``ckpt_dir``.

    Returns ``(world, snapshot, loop_state)``; continue with
    ``run_world(world, engine=snapshot.engine, resume=loop_state)``.  The
    checkpoint files are read, never mutated — resume as many times as you
    like.  ``spec`` overrides registry lookup (tests with ad-hoc specs).
    Federation snapshots rebuild a ``FederationWorld`` over every member's
    restored table.
    """
    snap = load_snapshot(ckpt_dir)
    if isinstance(snap, FederationSnapshot):
        if spec is None:
            from repro_torch.scenarios.registry import get_scenario
            spec = get_scenario(snap.federation)
        spec = _reapply_static_policy(spec, snap)
        tables = [TransferTable.load(os.path.join(ckpt_dir, r["table_file"]))
                  for r in snap.runtimes]
        world = spec.build(scale=snap.scale, seed=snap.seed,
                           n_datasets=snap.n_datasets, tables=tables)
        loop = apply_federation_snapshot(world, snap)
        return world, snap, loop
    if spec is None:
        from repro_torch.scenarios.registry import get_scenario
        spec = get_scenario(snap.scenario)
    spec = _reapply_static_policy(spec, snap)
    table = TransferTable.load(os.path.join(ckpt_dir, snap.table_file))
    world = spec.build(scale=snap.scale, seed=snap.seed,
                       n_datasets=snap.n_datasets, table=table)
    loop = apply_snapshot(world, snap)
    return world, snap, loop


# ----------------------------------------------------------------- checkpointer
def _atomic_write_text(path: str, text: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Checkpointer:
    """Writes snapshots at run-loop boundaries: every ``every`` iterations,
    and unconditionally when a kill was requested (``kill_after`` iteration
    budget, or a SIGTERM/SIGINT routed through ``install_signal_handlers`` /
    ``request_kill``) — after which ``CampaignKilled`` is raised so the
    process can exit knowing a consistent checkpoint exists."""

    def __init__(self, directory: str, every: int = 0,
                 kill_after: Optional[int] = None, keep: int = 2):
        self.directory = directory
        self.every = int(every)
        self.kill_after = kill_after
        self.keep = max(1, int(keep))
        self._anchor: Optional[int] = None  # iterations at last write/run start
        self._kill = False
        # telemetry (benchmarks/campaign_replay.py --checkpoint-bench)
        self.writes = 0
        self.write_s = 0.0
        self.last_bytes = 0

    # ------------------------------------------------------------------ kills
    def request_kill(self) -> None:
        self._kill = True

    def _on_signal(self, signum, frame) -> None:  # pragma: no cover - trivial
        self._kill = True

    def install_signal_handlers(
            self, signums: Sequence[int] = (signal.SIGTERM, signal.SIGINT)
    ) -> None:
        """Route termination signals into a checkpoint-then-exit at the next
        loop boundary (main thread only, as the signal module requires)."""
        for s in signums:
            signal.signal(s, self._on_signal)

    # --------------------------------------------------------------- boundary
    def on_boundary(self, world, loop: LoopState, engine: str) -> None:
        """Called by ``run_world`` at the top of every iteration (state is
        consistent there: ``loop.iterations`` iterations fully applied)."""
        it = loop.iterations
        if self._anchor is None:
            self._anchor = it           # cadence counts from run/resume start
        kill = self._kill or (self.kill_after is not None
                              and it >= self.kill_after)
        if kill or (self.every > 0 and it - self._anchor >= self.every):
            self.write(world, loop, engine)
        if kill:
            raise CampaignKilled(self.directory, it)

    def write(self, world, loop, engine: str) -> str:
        """One atomic checkpoint epoch; returns the snapshot filename.
        Accepts a single-campaign world (``LoopState``) or a federation
        (``FederationLoopState``); a federation epoch dumps one sqlite table
        copy per member runtime next to one shared snapshot."""
        t0 = time.time()
        os.makedirs(self.directory, exist_ok=True)
        it = loop.iterations
        if hasattr(world, "runtimes"):      # federation
            table_files = []
            for i, rt in enumerate(world.runtimes):
                tf = f"{TABLE_PREFIX}{it:08d}-m{i}.sqlite"
                rt.table.dump(os.path.join(self.directory, tf))
                table_files.append(tf)
            snap = capture_federation_snapshot(world, loop, engine,
                                               table_files)
        else:
            table_files = [f"{TABLE_PREFIX}{it:08d}.sqlite"]
            world.table.dump(os.path.join(self.directory, table_files[0]))
            snap = capture_snapshot(world, loop, engine, table_files[0])
        text = snap.dumps()
        snap_file = f"{SNAPSHOT_PREFIX}{it:08d}.json"
        _atomic_write_text(os.path.join(self.directory, snap_file), text)
        # LATEST lands last: a crash before this line leaves the previous
        # epoch authoritative and this one orphaned (GC'd next time)
        _atomic_write_text(os.path.join(self.directory, LATEST_FILE),
                           snap_file + "\n")
        self._anchor = it
        self._gc()
        self.writes += 1
        self.write_s += time.time() - t0
        self.last_bytes = len(text) + sum(
            os.path.getsize(os.path.join(self.directory, tf))
            for tf in table_files)
        return snap_file

    def _gc(self) -> None:
        """Drop all but the newest ``keep`` complete epochs (every table
        copy of an epoch shares the snapshot's iteration stem)."""
        entries = os.listdir(self.directory)
        snaps = sorted(f for f in entries
                       if f.startswith(SNAPSHOT_PREFIX) and f.endswith(".json"))
        for old in snaps[:-self.keep]:
            stem = old[len(SNAPSHOT_PREFIX):-len(".json")]
            victims = [old] + [f for f in entries
                               if f.startswith(f"{TABLE_PREFIX}{stem}")]
            for victim in victims:
                try:
                    os.remove(os.path.join(self.directory, victim))
                except OSError:  # pragma: no cover - best-effort cleanup
                    pass


# --------------------------------------------------------------- trajectory id
def succeeded_digest(table: TransferTable) -> str:
    """Order-independent digest of the succeeded set: every SUCCEEDED row's
    identity and outcome columns, hashed in canonical (dataset, destination)
    order.  Two campaigns with the same digest moved the same datasets over
    the same final routes with the same fault/retry/byte outcomes."""
    h = hashlib.sha256()
    for rec in table.all():                       # sorted by (dataset, dest)
        if rec.status is not Status.SUCCEEDED:
            continue
        h.update((f"{rec.dataset}|{rec.destination}|{rec.source}|"
                  f"{rec.faults}|{rec.retries}|{rec.bytes_transferred}|"
                  f"{rec.rate!r}\n").encode())
    return h.hexdigest()


def replica_set_digest(table: TransferTable) -> str:
    """Order-independent digest of WHICH replicas exist: every SUCCEEDED
    (dataset, destination) pair, nothing else.  Scrub repairs re-transfer
    replicas — changing retries, rates, and possibly the final source — so
    the scrub acceptance invariant ("a completed scrub/repair campaign ends
    in the corruption-free run's end state") compares this digest, not
    ``succeeded_digest``."""
    h = hashlib.sha256()
    for rec in table.all():                       # sorted by (dataset, dest)
        if rec.status is Status.SUCCEEDED:
            h.update(f"{rec.dataset}|{rec.destination}\n".encode())
    return h.hexdigest()


def trajectory_summary(report, stats, table: TransferTable) -> dict:
    """The bit-identity acceptance tuple: a resumed campaign must reproduce
    this dict *exactly* (float equality included) vs an uninterrupted run."""
    return {
        "iterations": stats.iterations,
        "sim_days": report.duration_days,
        "faults_total": report.faults_total,
        "quarantined": report.quarantined,
        "bytes_at": {k: int(v) for k, v in report.bytes_at.items()},
        "succeeded_digest": succeeded_digest(table),
    }


def federation_trajectory_summary(report, stats, world) -> dict:
    """The federated bit-identity tuple: shared iteration count and span plus
    every member campaign's own trajectory summary (digest included)."""
    return {
        "iterations": stats.iterations,
        "span_days": report.span_days,
        "members": {
            rt.label: {
                "sim_days": report.members[rt.label].duration_days,
                "faults_total": report.members[rt.label].faults_total,
                "quarantined": report.members[rt.label].quarantined,
                "bytes_at": {k: int(v) for k, v in
                             report.members[rt.label].bytes_at.items()},
                "succeeded_digest": succeeded_digest(rt.table),
            }
            for rt in world.runtimes
        },
    }
