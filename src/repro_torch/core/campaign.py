"""End-to-end replication campaign driver (paper §4) under a simulated clock.

Reconstructs the 2022 campaign: 2291 ESGF paths, 7.3 PB / 29 M files, three
sites, Table-3 bandwidths, ALCF weekly maintenance, OLCF coming online late,
the CMIP5 permission/GPFS incident around day 60, and termination when every
dataset lives at both LCFs.  EXPERIMENTS.md validates the simulated duration
(~77 days vs the 58-day single-path floor) and fault statistics against the
paper.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.faults import FaultInjector, Notifier, RetryPolicy
from repro_torch.core.pause import DAY, PauseManager
from repro_torch.core.routes import (GB, PB, Dataset, RouteGraph, make_catalog,
                               paper_route_graph, split_oversized)
from repro_torch.core.scheduler import ReplicationPolicy, ReplicationScheduler
from repro_torch.core.transfer_table import Status, TransferTable
from repro_torch.core.transport import SimClock, SimulatedTransport


@dataclass
class CampaignConfig:
    n_datasets: int = 2291
    total_bytes: int = int(7.3 * PB)
    total_files: int = 28_907_532
    source: str = "LLNL"
    replicas: Tuple[str, ...] = ("ALCF", "OLCF")
    step_s: float = 1800.0               # scheduler cadence
    max_days: float = 200.0
    seed: int = 0
    # incidents (paper Fig. 5 phases)
    olcf_online_day: float = 5.0         # phase 1: OLCF DTN not yet online
    alcf_weekly_maint_day: float = 5.0   # phase 2: first ALCF maintenance start
    alcf_maint_hours: float = 12.0
    unreadable_fraction: float = 0.01    # phase 4: CMIP5 permission incident
    human_fix_days: float = 3.0          # time for admins to fix permissions
    scale: float = 1.0                   # 1.0 = full 7.3 PB; tests use less
    task_setup_s: float = 0.0            # fixed dispatch cost per transfer task
    # retention horizon (days) for the transport's per-(day, route) flow
    # telemetry; None keeps the whole campaign (seed behaviour)
    flow_horizon_days: Optional[float] = None


@dataclass
class CampaignReport:
    duration_days: float
    floor_days: float                    # single-path theoretical minimum
    total_bytes: int
    bytes_at: Dict[str, int]
    per_route_gbps: Dict[Tuple[str, str], float]
    per_route_transfers: Dict[Tuple[str, str], int]
    faults_total: int
    faults_per_transfer_mean: float
    faults_per_transfer_max: int
    fault_histogram: Dict[int, int]
    timeline: List[Tuple[float, Dict[str, int]]]   # (day, bytes at each replica)
    notifications: List[str]
    quarantined: int


@dataclass
class FederationReport:
    """Aggregate outcome of N concurrent campaigns driven over one shared
    simulated world (``repro.scenarios.spec.FederationSpec``).  ``members``
    preserves member order; each member's ``duration_days`` is the absolute
    simulation day it finished (stagger included)."""
    members: Dict[str, CampaignReport]       # label -> per-campaign report
    started_day: Dict[str, float]            # label -> scheduled start day
    finished_day: Dict[str, float]           # label -> completion/timeout day
    span_days: float                         # last member's finish day


def build_catalog(cfg: CampaignConfig,
                  graph: RouteGraph) -> Dict[str, Dataset]:
    """The campaign's dataset catalog: synthesized ESGF-like paths,
    oversized requests pre-split to fit the source's scan memory (paper §5),
    and the permission incident's unreadable fraction marked.  Pure function
    of (cfg, graph) — callers may build it ahead of ``build_campaign`` (the
    control plane does, to bundle it) without perturbing the trajectory."""
    raw = make_catalog(
        n_datasets=cfg.n_datasets,
        total_bytes=int(cfg.total_bytes * cfg.scale),
        total_files=int(cfg.total_files * cfg.scale),
        seed=cfg.seed)
    catalog: Dict[str, Dataset] = {}
    limit = graph.sites[cfg.source].scan_mem_limit_files
    rng = np.random.default_rng(cfg.seed + 1)
    for ds in raw:
        for part in split_oversized(ds, limit):
            catalog[part.path] = part
    # permission incident: a fraction of (CMIP5-ish) datasets unreadable
    paths = sorted(catalog)
    n_bad = int(len(paths) * cfg.unreadable_fraction)
    for p in rng.choice(paths, size=n_bad, replace=False):
        catalog[p].unreadable = True
    return catalog


def build_campaign(cfg: CampaignConfig, *,
                   graph: Optional[RouteGraph] = None,
                   pause: Optional[PauseManager] = None,
                   injector: Optional[FaultInjector] = None,
                   retry: Optional[RetryPolicy] = None,
                   max_active_per_route: int = 2,
                   table: Optional[TransferTable] = None,
                   transport: Optional[SimulatedTransport] = None,
                   notifier: Optional[Notifier] = None,
                   catalog: Optional[Dict[str, Dataset]] = None):
    """Wire up catalog, sites, calendar, transport, table, scheduler.

    The keyword overrides let a ``repro.scenarios.spec.ScenarioSpec`` compile
    its own topology, maintenance calendar, and fault profile onto the same
    wiring; with no overrides this reproduces the paper's 2022 campaign.
    ``table`` accepts a pre-populated transfer table (checkpoint resume); the
    populate pass then inserts nothing, because every row already exists.

    ``transport`` attaches this campaign to an existing (shared) transport
    instead of constructing its own — the federation path, where N campaign
    runtimes contend through one ``SimulatedTransport``'s fair-share rate
    allocator.  The shared transport's clock/pause/injector are then
    authoritative; ``notifier`` is the *campaign's* notifier (the scheduler's
    quarantine notifications go there), which may differ from the transport's
    routing notifier.

    ``catalog`` overrides the internally built catalog — the control plane's
    bundling path, where the scheduler's work items are composed *bundles*
    (possibly a live, growing dict) rather than raw catalog datasets.
    """
    if graph is None:
        graph = paper_route_graph()
    if catalog is None:
        catalog = build_catalog(cfg, graph)

    clock = transport.clock if transport is not None else SimClock(0.0)
    if pause is None and transport is not None:
        pause = transport.pause
    if pause is None:
        pause = PauseManager()
        # OLCF offline until its DTN comes up (phase 1)
        pause.add_window("OLCF", 0.0, cfg.olcf_online_day * DAY, planned=False)
        # phase 2: the first ALCF maintenance was an extended multi-day window
        # (paper Feb 20-25), then a weekly occurrence
        pause.add_window("ALCF", cfg.alcf_weekly_maint_day * DAY,
                         (cfg.alcf_weekly_maint_day + 5) * DAY)
        pause.add_weekly("ALCF", (cfg.alcf_weekly_maint_day + 12) * DAY,
                         cfg.alcf_maint_hours * 3600.0, cfg.max_days * DAY)
        # occasional OLCF maintenance
        pause.add_weekly("OLCF", 40 * DAY, 12 * 3600.0, cfg.max_days * DAY)

    if injector is None and transport is None:
        injector = FaultInjector(seed=cfg.seed)
    if notifier is None:
        notifier = Notifier()
    if retry is None:
        retry = RetryPolicy(max_retries=8, backoff_s=3600.0)
    if transport is None:
        transport = SimulatedTransport(graph, clock, pause, injector,
                                       notifier, retry,
                                       task_setup_s=cfg.task_setup_s,
                                       flow_horizon_days=cfg.flow_horizon_days)
    if table is None:
        table = TransferTable()
    sched = ReplicationScheduler(
        table, transport, catalog,
        ReplicationPolicy(cfg.source, cfg.replicas, max_active_per_route),
        retry, notifier)
    sched.populate()
    return graph, catalog, clock, pause, transport, table, sched, notifier


def apply_human_fixes(notifier: Notifier, fix_at: Dict[str, float],
                      now: float, human_fix_days: float) -> None:
    """Human-in-the-loop: permission fixes land ``human_fix_days`` after
    notification (paper phase 4→5).  ``fix_at`` is the caller's pending-fix
    schedule, mutated in place; shared by the step and event drivers."""
    for ds_path, fixed in list(notifier.fixed.items()):
        if not fixed and ds_path not in fix_at:
            fix_at[ds_path] = now + human_fix_days * DAY
    for ds_path, t in list(fix_at.items()):
        if now >= t and not notifier.is_fixed(ds_path):
            notifier.fix(ds_path)


def aggregate_report(cfg: CampaignConfig, graph: RouteGraph,
                     catalog: Dict[str, Dataset], clock: SimClock,
                     table: TransferTable, notifier: Notifier,
                     timeline: List[Tuple[float, Dict[str, int]]]
                     ) -> CampaignReport:
    """Campaign statistics from a finished (or timed-out) table — per-route
    achieved rates over *active* time only (Table 3 semantics), the Fig. 6
    fault histogram, and final per-replica byte counts."""
    total = sum(d.bytes for d in catalog.values())
    per_route_rates: Dict[Tuple[str, str], list] = {}
    per_route_n: Dict[Tuple[str, str], int] = {}
    faults = []
    for rec in table.all():
        if rec.status != Status.SUCCEEDED:
            continue
        route = (rec.source, rec.destination)
        per_route_n[route] = per_route_n.get(route, 0) + 1
        if rec.rate:
            per_route_rates.setdefault(route, []).append(rec.rate)
        faults.append(rec.faults)
    per_route_gbps = {
        r: float(np.mean(v)) / GB for r, v in per_route_rates.items()}
    hist: Dict[int, int] = {}
    for f in faults:
        hist[f] = hist.get(f, 0) + 1
    return CampaignReport(
        duration_days=clock.now / DAY,
        floor_days=total / graph.sites[cfg.source].read_bw / DAY,
        total_bytes=total,
        bytes_at={r: _bytes_at(table, r) for r in cfg.replicas},
        per_route_gbps=per_route_gbps,
        per_route_transfers=per_route_n,
        faults_total=int(np.sum(faults)) if faults else 0,
        faults_per_transfer_mean=float(np.mean(faults)) if faults else 0.0,
        faults_per_transfer_max=int(np.max(faults)) if faults else 0,
        fault_histogram=hist,
        timeline=timeline,
        notifications=list(notifier.notifications),
        quarantined=table.count_status(Status.QUARANTINED),
    )


def run_campaign(cfg: CampaignConfig, verbose: bool = False) -> CampaignReport:
    (graph, catalog, clock, pause, transport, table, sched,
     notifier) = build_campaign(cfg)
    timeline: List[Tuple[float, Dict[str, int]]] = []
    fix_at: Dict[str, float] = {}
    while clock.now < cfg.max_days * DAY:
        sched.step(clock.now)
        apply_human_fixes(notifier, fix_at, clock.now, cfg.human_fix_days)
        clock.advance(cfg.step_s)
        transport.tick()
        if int(clock.now) % int(DAY) < cfg.step_s:
            snap = {r: _bytes_at(table, r) for r in cfg.replicas}
            timeline.append((clock.now / DAY, snap))
        if sched.done():
            break
    return aggregate_report(cfg, graph, catalog, clock, table, notifier,
                            timeline)


def _bytes_at(table: TransferTable, replica: str) -> int:
    return table.bytes_at(replica)
