"""Declarative scenario specifications.

A ``ScenarioSpec`` is a complete, human-readable description of a replication
campaign — site capabilities, route bandwidths, maintenance calendars, fault
profiles, catalog shape, and incidents — in natural units (GB/s, days,
hours).  ``build()`` compiles it onto the existing campaign wiring
(``CampaignConfig`` + ``RouteGraph`` + ``PauseManager`` + scheduler/transport
construction in ``repro_torch.core.campaign.build_campaign``), so every scenario
runs through exactly the code path the paper-2022 reproduction uses.

Capacity-planning questions ("what if the source were slower?  what if
maintenance doubled?  what if a fourth site joined?") become one-line edits
to a spec or entries in ``repro_torch.scenarios.registry``.

Determinism invariants (what makes ``(spec, scale, seed, n_datasets)`` a
complete trajectory key, relied on by snapshots, the engine-equivalence
tests, and the ensemble lanes engine):

* ``build()`` is a pure function of its arguments: same spec + same
  ``(scale, seed, n_datasets)`` always wires the same world.  Specs are
  frozen dataclasses; ``vary()`` copies, never mutates.
* Exactly three RNG streams exist, all derived from ``seed``:
  the **catalog** stream (``make_catalog(seed)`` sizes + the
  ``default_rng(seed + 1)`` unreadable-marking draw in ``build_catalog``),
  the **fault** stream (``FaultInjector(seed)`` — consumed only at transfer
  submission, in submission order, via ``transient_marks``; plus the
  per-replica pure ``latent_corrupt_offsets`` draws which consume nothing),
  and the **demand** stream (``DemandEngine``'s arrival process, seeded
  ``default_rng([seed, 0x44454D44])`` so it can never interleave with the
  fault stream — absent under ``NO_DEMAND``).
* Everything else is derived: pause calendars come from the spec's outage
  list, control-plane decisions from observed state, scrub schedules from
  the spec.  No component reads the wall clock or an unseeded RNG.
"""
from __future__ import annotations

import dataclasses
from collections import ChainMap
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.control.bundles import BundleComposer
from repro_torch.control.plane import ControlPlane
from repro_torch.control.policy import STATIC_POLICY, TransferPolicySpec
from repro_torch.core.campaign import (CampaignConfig, build_campaign,
                                 build_catalog)
from repro_torch.core.faults import (FaultInjector, FederationNotifier, Notifier,
                               RetryPolicy)
from repro_torch.core.incremental import IncrementalReplicator, PublishFeed
from repro_torch.core.pause import DAY, PauseManager
from repro_torch.core.routes import GB, PB, Dataset, Route, RouteGraph, Site
from repro_torch.core.scrub import NO_SCRUB, ScrubEngine, ScrubSpec
from repro_torch.core.transport import SimClock, SimulatedTransport
from repro_torch.demand.engine import DemandEngine
from repro_torch.demand.spec import NO_DEMAND, DemandSpec
from repro_torch.obs.spec import NO_OBS, ObsSpec

HOUR = 3600.0


@dataclass(frozen=True)
class SiteSpec:
    """One storage site: aggregate read/write caps and scan behavior."""
    name: str
    read_gbps: float                       # GB/s (binary GB, as paper Table 3)
    write_gbps: float
    scan_files_per_s: float = 50_000.0
    scan_mem_limit_files: int = 5_000_000
    # DTN contention knee: concurrent transfers beyond this degrade the
    # site's aggregate throughput (None = ideal fair share)
    concurrency_knee: Optional[int] = None


@dataclass(frozen=True)
class RouteSpec:
    """One directed WAN route with its per-route bandwidth cap (GB/s)."""
    source: str
    destination: str
    gbps: float


@dataclass(frozen=True)
class OutageSpec:
    """A maintenance-calendar entry: one-off or weekly recurring."""
    site: str
    start_day: float
    duration_h: float
    weekly: bool = False
    until_day: Optional[float] = None      # default: campaign max_days
    planned: bool = True


@dataclass(frozen=True)
class FaultProfileSpec:
    """Transient-fault intensity and the retry policy responding to it."""
    transient_per_tb: float = 0.15
    fragility_tail: float = 2.5
    max_retries: int = 8
    backoff_s: float = 3600.0
    fault_retry_cost_s: float = 30.0


@dataclass(frozen=True)
class CatalogSpec:
    """Shape of the dataset catalog (paper: 2291 paths / 7.3 PB / 29 M files)."""
    n_datasets: int = 2291
    total_bytes: int = int(7.3 * PB)
    total_files: int = 28_907_532
    unreadable_fraction: float = 0.01      # CMIP5 permission incident


@dataclass(frozen=True)
class TopUpSpec:
    """Datasets published mid-campaign (paper C7, incremental replication)."""
    publish_day: float
    n_datasets: int
    bytes_each: int = int(2 * GB)
    files_each: int = 200


@dataclass
class SharedWorld:
    """The substrate N campaign runtimes attach to: one simulation clock, one
    route graph, one transport (whose fair-share ``_route_rates`` is where
    concurrent campaigns contend for route and site caps), one maintenance
    calendar, and — through the transport — one fault-RNG stream."""
    graph: RouteGraph
    clock: SimClock
    pause: PauseManager
    transport: SimulatedTransport


@dataclass
class CampaignRuntime:
    """One campaign's private runtime: its transfer table, Figure-4
    scheduler, notifier, optional incremental feed, and report identity —
    everything the driver steps per campaign, extracted from the old
    single-campaign ``ScenarioWorld``/``run_world`` so a federation can hold
    N of them over one ``SharedWorld``."""
    spec: "ScenarioSpec"
    cfg: CampaignConfig
    catalog: Dict[str, Dataset]
    table: object
    sched: object
    notifier: Notifier
    label: str = ""
    start_day: float = 0.0
    incremental: Optional[IncrementalReplicator] = None
    top_up_times: Tuple[float, ...] = ()
    # the campaign's control plane (bundling + online tuning); None for the
    # default static per-dataset policy
    control: Optional[ControlPlane] = None
    # the campaign's demand engine (user traffic + replica serving); None
    # for the default replication-only campaign
    demand: Optional[DemandEngine] = None
    # the campaign's scrub engine (silent corruption + re-verification +
    # repair); None for the default corruption-free campaign
    scrub: Optional[ScrubEngine] = None
    # the campaign's flight recorder (trace + metrics); None for the default
    # unobserved campaign.  Never snapshotted: a resumed campaign rebuilds
    # observability fresh, and the trajectory is identical either way.
    obs: Optional[object] = None

    @property
    def start_s(self) -> float:
        return self.start_day * DAY

    @property
    def deadline_s(self) -> float:
        """Absolute sim time at which this campaign times out."""
        return self.start_day * DAY + self.cfg.max_days * DAY

    def binding_catalog(self) -> Dict[str, Dataset]:
        """Every dataset a live transfer of this campaign may reference:
        the raw catalog plus any composed bundles — what the transport
        re-binds mover rows against on resume."""
        merged = dict(self.catalog)
        if self.control is not None and self.control.composer is not None:
            merged.update(self.control.composer.bundle_catalog)
        return merged


@dataclass
class ScenarioWorld:
    """A compiled, runnable scenario: the campaign wiring plus (optionally)
    an incremental-replication feed for mid-campaign top-ups.

    Structurally this is now a 1-element federation — ``shared`` +
    ``runtime`` are the primary objects and the flat fields alias into them —
    but the flat layout is kept as the single-campaign API."""
    spec: "ScenarioSpec"
    cfg: CampaignConfig
    graph: RouteGraph
    catalog: Dict[str, Dataset]
    clock: object
    pause: PauseManager
    transport: object
    table: object
    sched: object
    notifier: object
    incremental: Optional[IncrementalReplicator] = None
    top_up_times: Tuple[float, ...] = ()
    # build provenance, recorded so a campaign checkpoint can rebuild an
    # identical world (repro_torch.core.snapshot)
    scale: float = 1.0
    seed: int = 0
    n_datasets: Optional[int] = None
    shared: Optional[SharedWorld] = None
    runtime: Optional[CampaignRuntime] = None

    @property
    def control(self) -> Optional[ControlPlane]:
        return self.runtime.control if self.runtime is not None else None

    @property
    def demand(self) -> Optional[DemandEngine]:
        return self.runtime.demand if self.runtime is not None else None

    @property
    def scrub(self) -> Optional[ScrubEngine]:
        return self.runtime.scrub if self.runtime is not None else None

    @property
    def obs(self):
        return self.runtime.obs if self.runtime is not None else None


@dataclass(frozen=True)
class ScenarioSpec:
    """A full declarative campaign scenario."""
    name: str
    description: str
    source: str
    replicas: Tuple[str, ...]
    sites: Tuple[SiteSpec, ...]
    routes: Tuple[RouteSpec, ...]
    outages: Tuple[OutageSpec, ...] = ()
    faults: FaultProfileSpec = FaultProfileSpec()
    catalog: CatalogSpec = CatalogSpec()
    top_ups: Tuple[TopUpSpec, ...] = ()
    human_fix_days: float = 3.0
    max_days: float = 200.0
    step_s: float = 1800.0                 # fixed-step engine cadence
    max_active_per_route: int = 2
    # control plane: bundling + online tuning.  The default (per-dataset
    # tasks, static caps) compiles to NO control plane and replays the
    # pre-control-plane trajectory bit-identically.
    policy: TransferPolicySpec = STATIC_POLICY
    # fixed dispatch cost per transfer task (Globus task setup/queueing);
    # the term bundling amortizes.  0.0 = the seed model.
    task_setup_s: float = 0.0
    # user-traffic demand over the replicated catalog ("ESGF-as-a-service").
    # The default (zero users) compiles to NO demand engine and replays the
    # replication-only trajectory bit-identically.
    demand: DemandSpec = NO_DEMAND
    # silent corruption + scrub/repair campaigns.  The default (zero latent
    # corruption) compiles to NO scrub engine and replays the corruption-free
    # trajectory bit-identically.
    scrub: ScrubSpec = NO_SCRUB
    # flight recorder (lifecycle trace + metrics time-series).  The default
    # (``NO_OBS``) compiles to NO engine and zero hooks; an enabled spec
    # observes without perturbing — trajectories and snapshots stay
    # bit-identical with obs on or off (CI-gated).
    obs: ObsSpec = NO_OBS
    # retention horizon (days) for the transport's per-(day, route) flow
    # telemetry; None keeps every bucket for the whole campaign
    flow_horizon_days: Optional[float] = None

    # ------------------------------------------------------------- compilers
    def to_campaign_config(self, scale: float = 1.0, seed: int = 0,
                           n_datasets: Optional[int] = None) -> CampaignConfig:
        return CampaignConfig(
            n_datasets=n_datasets if n_datasets is not None
            else self.catalog.n_datasets,
            total_bytes=self.catalog.total_bytes,
            total_files=self.catalog.total_files,
            source=self.source,
            replicas=tuple(self.replicas),
            step_s=self.step_s,
            max_days=self.max_days,
            seed=seed,
            unreadable_fraction=self.catalog.unreadable_fraction,
            human_fix_days=self.human_fix_days,
            scale=scale,
            task_setup_s=self.task_setup_s,
            flow_horizon_days=self.flow_horizon_days)

    def build_graph(self) -> RouteGraph:
        sites = [Site(s.name, read_bw=s.read_gbps * GB,
                      write_bw=s.write_gbps * GB,
                      scan_files_per_s=s.scan_files_per_s,
                      scan_mem_limit_files=s.scan_mem_limit_files,
                      concurrency_knee=s.concurrency_knee)
                 for s in self.sites]
        routes = [Route(r.source, r.destination, r.gbps * GB)
                  for r in self.routes]
        return RouteGraph(sites, routes)

    def build_pause(self) -> PauseManager:
        pause = PauseManager()
        for o in self.outages:
            start = o.start_day * DAY
            if o.weekly:
                until = (o.until_day if o.until_day is not None
                         else self.max_days) * DAY
                pause.add_weekly(o.site, start, o.duration_h * HOUR, until,
                                 planned=o.planned)
            else:
                pause.add_window(o.site, start, start + o.duration_h * HOUR,
                                 planned=o.planned)
        return pause

    def build_retry(self) -> RetryPolicy:
        return RetryPolicy(max_retries=self.faults.max_retries,
                           backoff_s=self.faults.backoff_s,
                           fault_retry_cost_s=self.faults.fault_retry_cost_s)

    def _attach_top_ups(self, runtime: CampaignRuntime, scale: float) -> None:
        """Compile the spec's top-up schedule into a publish feed wired to
        the runtime's scheduler."""
        if not self.top_ups:
            return
        feed = PublishFeed()
        times: List[float] = []
        for i, tu in enumerate(self.top_ups):
            t = tu.publish_day * DAY
            times.append(t)
            for j in range(tu.n_datasets):
                feed.publish(t, Dataset(
                    path=f"/css03_data/CMIP6/TOPUP/batch-{i}/ds-{j:04d}",
                    bytes=int(tu.bytes_each * scale) or tu.bytes_each,
                    files=tu.files_each,
                    directories=max(1, tu.files_each // 10)))
        runtime.incremental = IncrementalReplicator(feed, runtime.sched,
                                                    check_interval=DAY)
        runtime.top_up_times = tuple(times)

    def _compose_bundles(self, catalog: Dict[str, Dataset], seed: int,
                         fresh: bool,
                         namespace: Optional[str] = None
                         ) -> Optional[BundleComposer]:
        """The policy's bundle composer over ``catalog`` (None when the
        policy keeps per-dataset tasks).  ``fresh`` cuts the initial
        lookahead; a resume skips it — the restored cursor and already-cut
        bundles come from the snapshot instead.  ``namespace`` disambiguates
        bundle paths (federation members pass their unique label)."""
        pol = self.policy
        if not pol.enabled or pol.bundling == "dataset":
            return None
        if self.top_ups:
            raise ValueError(
                f"scenario {self.name!r}: bundling policies and incremental "
                "top-ups cannot be combined (the composer's item stream is "
                "fixed at build time)")
        composer = BundleComposer(catalog, pol, seed=seed,
                                  namespace=namespace or self.name)
        if fresh:
            while (not composer.done
                   and len(composer.bundle_catalog) < max(1, pol.lookahead)):
                composer.cut_next()
        return composer

    def _build_demand(self, catalog: Dict[str, Dataset], table, sched,
                      transport, seed: int, label: str
                      ) -> Optional[DemandEngine]:
        """The spec's demand engine over the built campaign (None when no
        users are declared).  Users request the *raw* catalog, so demand
        cannot be combined with bundling policies (bundle rows would
        materialize paths no user ever asks for)."""
        if not self.demand.enabled:
            return None
        if self.policy.enabled and self.policy.bundling != "dataset":
            raise ValueError(
                f"scenario {self.name!r}: demand traffic and bundling "
                "policies cannot be combined (the replica catalog tracks "
                "per-dataset rows, bundles materialize composite paths)")
        return DemandEngine(self.demand, catalog, table, sched, transport,
                            self.source, self.replicas, seed=seed,
                            label=label)

    def _build_scrub(self, catalog: Dict[str, Dataset], table, injector,
                     label: str) -> Optional[ScrubEngine]:
        """The spec's scrub engine over the built campaign (None when latent
        corruption is off).  Corruption draws key off raw dataset paths, so
        scrub cannot be combined with bundling policies (bundle rows would
        never map back to the per-dataset integrity ledger)."""
        if not self.scrub.enabled:
            return None
        if self.policy.enabled and self.policy.bundling != "dataset":
            raise ValueError(
                f"scenario {self.name!r}: scrub campaigns and bundling "
                "policies cannot be combined (the integrity ledger tracks "
                "per-dataset replicas, bundles materialize composite paths)")
        return ScrubEngine(self.scrub, catalog, table, injector,
                           self.source, self.replicas, label=label)

    def _build_obs(self, label: str):
        """The flight recorder, or None when the spec does not opt in —
        ``NO_OBS`` must compile to zero hooks (engine imported lazily so an
        unobserved build never touches the obs package)."""
        if not self.obs.enabled:
            return None
        from repro_torch.obs.engine import Observability
        return Observability(self.obs, label=label)

    def build(self, scale: float = 1.0, seed: int = 0,
              n_datasets: Optional[int] = None, table=None) -> ScenarioWorld:
        """Compile the spec onto the campaign wiring, ready to run under
        either the fixed-step or the event-driven engine.  ``table`` accepts
        a restored ``TransferTable`` when resuming from a checkpoint."""
        self.policy.validate()
        self.demand.validate()
        self.scrub.validate()
        self.obs.validate()
        cfg = self.to_campaign_config(scale=scale, seed=seed,
                                      n_datasets=n_datasets)
        injector = FaultInjector(seed=seed,
                                 transient_per_tb=self.faults.transient_per_tb,
                                 fragility_tail=self.faults.fragility_tail)
        graph = self.build_graph()
        catalog = build_catalog(cfg, graph)
        composer = self._compose_bundles(catalog, seed, fresh=table is None)
        (graph, sched_catalog, clock, pause, transport, table, sched,
         notifier) = build_campaign(
            cfg, graph=graph, pause=self.build_pause(),
            injector=injector, retry=self.build_retry(),
            max_active_per_route=self.max_active_per_route, table=table,
            catalog=(composer.bundle_catalog if composer is not None
                     else catalog))
        control = None
        if self.policy.enabled:
            control = ControlPlane(self.policy, sched, transport,
                                   self.source, self.replicas,
                                   composer=composer, label=self.name)
        demand = self._build_demand(catalog, table, sched, transport,
                                    seed, label=self.name)
        scrub = self._build_scrub(catalog, table, injector, label=self.name)
        runtime = CampaignRuntime(self, cfg, catalog, table, sched, notifier,
                                  label=self.name, control=control,
                                  demand=demand, scrub=scrub)
        self._attach_top_ups(runtime, scale)
        shared = SharedWorld(graph, clock, pause, transport)
        obs = self._build_obs(label=self.name)
        if obs is not None:
            runtime.obs = obs
            obs.attach(runtime, shared)
        return ScenarioWorld(self, cfg, graph, catalog, clock, pause,
                             transport, table, sched, notifier,
                             incremental=runtime.incremental,
                             top_up_times=runtime.top_up_times,
                             scale=scale, seed=seed, n_datasets=n_datasets,
                             shared=shared, runtime=runtime)

    # --------------------------------------------------------------- helpers
    def vary(self, **changes) -> "ScenarioSpec":
        """A copy with top-level fields replaced (sweep convenience)."""
        return dataclasses.replace(self, **changes)

    def with_catalog(self, **changes) -> "ScenarioSpec":
        return dataclasses.replace(
            self, catalog=dataclasses.replace(self.catalog, **changes))

    def with_faults(self, **changes) -> "ScenarioSpec":
        return dataclasses.replace(
            self, faults=dataclasses.replace(self.faults, **changes))

    def with_policy(self, policy: Optional[TransferPolicySpec] = None,
                    **changes) -> "ScenarioSpec":
        """A copy with a different transfer policy: pass a whole
        ``TransferPolicySpec`` or field overrides on the current one.
        ``with_policy(STATIC_POLICY)`` is the naive per-dataset baseline."""
        base = policy if policy is not None else self.policy
        if changes:
            base = dataclasses.replace(base, **changes)
        return dataclasses.replace(self, policy=base)

    def with_demand(self, demand: Optional[DemandSpec] = None,
                    **changes) -> "ScenarioSpec":
        """A copy with a different demand (user-traffic) spec: pass a whole
        ``DemandSpec`` or field overrides on the current one.
        ``with_demand(NO_DEMAND)`` is the replication-only baseline."""
        base = demand if demand is not None else self.demand
        if changes:
            base = dataclasses.replace(base, **changes)
        return dataclasses.replace(self, demand=base)

    def with_scrub(self, scrub: Optional[ScrubSpec] = None,
                   **changes) -> "ScenarioSpec":
        """A copy with a different scrub (silent-corruption) spec: pass a
        whole ``ScrubSpec`` or field overrides on the current one.
        ``with_scrub(NO_SCRUB)`` is the corruption-free baseline."""
        base = scrub if scrub is not None else self.scrub
        if changes:
            base = dataclasses.replace(base, **changes)
        return dataclasses.replace(self, scrub=base)

    def with_obs(self, obs: Optional[ObsSpec] = None,
                 **changes) -> "ScenarioSpec":
        """A copy with a different observability spec: pass a whole
        ``ObsSpec`` or field overrides on the current one.
        ``with_obs(NO_OBS)`` is the unobserved baseline."""
        base = obs if obs is not None else self.obs
        if changes:
            base = dataclasses.replace(base, **changes)
        return dataclasses.replace(self, obs=base)


# ================================================================ federation
@dataclass(frozen=True)
class FederationMemberSpec:
    """One campaign of a federation: a full ``ScenarioSpec`` plus the day it
    starts (staggered starts model overlapping real-world campaigns)."""
    scenario: ScenarioSpec
    start_day: float = 0.0
    label: Optional[str] = None


@dataclass
class FederationWorld:
    """N compiled campaign runtimes attached to one shared substrate.  Built
    by ``FederationSpec.build``; driven by ``repro_torch.scenarios.events.run_world``
    (which folds every runtime's next-event candidates into one clock
    advance); checkpointed as a ``repro_torch.core.snapshot.FederationSnapshot``."""
    spec: "FederationSpec"
    shared: SharedWorld
    runtimes: List[CampaignRuntime]
    scale: float = 1.0
    seed: int = 0
    n_datasets: Optional[int] = None

    # convenience passthroughs (CLI / dashboard / tests)
    @property
    def clock(self):
        return self.shared.clock

    @property
    def transport(self):
        return self.shared.transport

    @property
    def graph(self):
        return self.shared.graph

    @property
    def pause(self):
        return self.shared.pause

    def runtime_by_label(self, label: str) -> CampaignRuntime:
        for rt in self.runtimes:
            if rt.label == label:
                return rt
        raise KeyError(label)

    def merged_catalog(self) -> Dict[str, Dataset]:
        """Union of member catalogs plus every member's composed bundles
        (bundle paths are namespaced per member, so they never collide;
        shared raw-path collisions were validated identical at build time)
        — the transport's dataset re-binding map on resume."""
        merged: Dict[str, Dataset] = {}
        for rt in self.runtimes:
            merged.update(rt.binding_catalog())
        return merged


@dataclass(frozen=True)
class FederationSpec:
    """N declarative campaigns sharing one simulated world.

    Compiles to a ``FederationWorld``: one clock / route graph / maintenance
    calendar / ``SimulatedTransport`` (one fault-RNG stream), with a private
    ``CampaignRuntime`` (table + scheduler + notifier + feed) per member.
    Concurrent members contend naturally through the transport's fair-share
    allocator — a member route's achievable rate shrinks whenever another
    member's movers touch the same site, which is exactly the paper's regime
    of two overlapping campaigns reading one ~1.5 GB/s source file system.

    ``shared_sites`` declares which sites are intentionally shared: every
    site named by more than one member must be listed here, and all members
    must describe it (and any shared route) with identical capabilities.
    A 1-element federation is the degenerate case and runs bit-identically
    to the member scenario built standalone.
    """
    name: str
    description: str
    members: Tuple[FederationMemberSpec, ...]
    shared_sites: Tuple[str, ...] = ()
    # when set, every member campaign runs under THIS transfer policy
    # (each member still gets its own control plane, tuning its own
    # scheduler's caps against the shared transport's telemetry)
    policy: Optional[TransferPolicySpec] = None

    # --------------------------------------------------------------- helpers
    def with_policy(self, policy: TransferPolicySpec) -> "FederationSpec":
        """A copy running every member under ``policy``."""
        return dataclasses.replace(self, policy=policy)

    def with_obs(self, obs: ObsSpec) -> "FederationSpec":
        """A copy with every member campaign observed under ``obs`` (each
        member gets its own flight recorder; one shared sink tells their
        streams apart by the per-record ``campaign`` label)."""
        members = tuple(
            dataclasses.replace(m, scenario=m.scenario.with_obs(obs))
            for m in self.members)
        return dataclasses.replace(self, members=members)

    def member_labels(self) -> List[str]:
        labels = []
        for i, m in enumerate(self.members):
            label = m.label or m.scenario.name
            if label in labels:
                label = f"{label}#{i}"
            labels.append(label)
        return labels

    def _validate(self) -> None:
        if not self.members:
            raise ValueError(f"federation {self.name!r} has no members")
        site_owner: Dict[str, Tuple[SiteSpec, str]] = {}
        route_owner: Dict[Tuple[str, str], Tuple[RouteSpec, str]] = {}
        faults = self.members[0].scenario.faults
        setup = self.members[0].scenario.task_setup_s
        horizon = self.members[0].scenario.flow_horizon_days
        for m in self.members:
            spec = m.scenario
            if spec.faults != faults:
                raise ValueError(
                    f"federation {self.name!r}: member {spec.name!r} declares "
                    "a different fault/retry profile; the shared transport "
                    "has one fault injector and one in-transfer retry cost")
            if spec.task_setup_s != setup:
                raise ValueError(
                    f"federation {self.name!r}: member {spec.name!r} declares "
                    f"task_setup_s={spec.task_setup_s}, the shared transport "
                    f"has one task dispatch cost ({setup})")
            if spec.flow_horizon_days != horizon:
                raise ValueError(
                    f"federation {self.name!r}: member {spec.name!r} declares "
                    f"flow_horizon_days={spec.flow_horizon_days}, the shared "
                    f"transport has one telemetry horizon ({horizon})")
            for s in spec.sites:
                seen = site_owner.get(s.name)
                if seen is None:
                    site_owner[s.name] = (s, spec.name)
                    continue
                if seen[0] != s:
                    raise ValueError(
                        f"federation {self.name!r}: site {s.name!r} declared "
                        f"with different capabilities by {seen[1]!r} and "
                        f"{spec.name!r}")
                if s.name not in self.shared_sites:
                    raise ValueError(
                        f"federation {self.name!r}: site {s.name!r} is used "
                        f"by {seen[1]!r} and {spec.name!r} but not declared "
                        "in shared_sites")
            for r in spec.routes:
                key = (r.source, r.destination)
                seen = route_owner.get(key)
                if seen is None:
                    route_owner[key] = (r, spec.name)
                elif seen[0] != r:
                    raise ValueError(
                        f"federation {self.name!r}: route {key} declared "
                        f"with different bandwidth by {seen[1]!r} and "
                        f"{spec.name!r}")

    def build_graph(self) -> RouteGraph:
        """Union of the member topologies (validated consistent)."""
        sites: Dict[str, Site] = {}
        routes: Dict[Tuple[str, str], Route] = {}
        for m in self.members:
            g = m.scenario.build_graph()
            sites.update(g.sites)
            routes.update(g.routes)
        return RouteGraph(list(sites.values()), list(routes.values()))

    def build_pause(self) -> PauseManager:
        """Union maintenance calendar: identical outage declarations from
        several members collapse to one window (site maintenance is a fact
        about the site, not about who is transferring)."""
        pause = PauseManager()
        seen = set()
        for m in self.members:
            for o in m.scenario.outages:
                key = (o.site, o.start_day, o.duration_h, o.weekly,
                       o.until_day, o.planned, m.scenario.max_days)
                if key in seen:
                    continue
                seen.add(key)
                start = o.start_day * DAY
                if o.weekly:
                    until = (o.until_day if o.until_day is not None
                             else m.scenario.max_days) * DAY
                    pause.add_weekly(o.site, start, o.duration_h * HOUR,
                                     until, planned=o.planned)
                else:
                    pause.add_window(o.site, start,
                                     start + o.duration_h * HOUR,
                                     planned=o.planned)
        return pause

    # ----------------------------------------------------------------- build
    def build(self, scale: float = 1.0, seed: int = 0,
              n_datasets: Optional[int] = None,
              tables: Optional[List] = None) -> FederationWorld:
        """Compile every member onto one shared substrate.  ``tables``
        accepts restored per-member ``TransferTable``s (checkpoint resume),
        in member order."""
        self._validate()
        if tables is not None and len(tables) != len(self.members):
            raise ValueError(
                f"federation {self.name!r}: {len(tables)} restored tables "
                f"for {len(self.members)} members")
        graph = self.build_graph()
        pause = self.build_pause()
        base = self.members[0].scenario
        injector = FaultInjector(
            seed=seed,
            transient_per_tb=base.faults.transient_per_tb,
            fragility_tail=base.faults.fragility_tail)
        fed_notifier = FederationNotifier()
        transport = SimulatedTransport(graph, SimClock(0.0), pause, injector,
                                       fed_notifier, base.build_retry(),
                                       task_setup_s=base.task_setup_s,
                                       flow_horizon_days=base.flow_horizon_days)
        shared = SharedWorld(graph, transport.clock, pause, transport)
        runtimes: List[CampaignRuntime] = []
        merged: Dict[str, Dataset] = {}
        labels = self.member_labels()
        for i, m in enumerate(self.members):
            spec = m.scenario
            if self.policy is not None:
                spec = spec.with_policy(self.policy)
            spec.policy.validate()
            spec.demand.validate()
            spec.scrub.validate()
            spec.obs.validate()
            cfg = spec.to_campaign_config(scale=scale, seed=seed,
                                          n_datasets=n_datasets)
            notifier = Notifier()
            member_table = tables[i] if tables is not None else None
            catalog = build_catalog(cfg, graph)
            composer = spec._compose_bundles(catalog, seed,
                                             fresh=member_table is None,
                                             namespace=labels[i])
            (_, _, _, _, _, table, sched, _) = build_campaign(
                cfg, graph=graph, retry=spec.build_retry(),
                max_active_per_route=spec.max_active_per_route,
                table=member_table,
                transport=transport, notifier=notifier,
                catalog=(composer.bundle_catalog if composer is not None
                         else catalog))
            control = None
            if spec.policy.enabled:
                control = ControlPlane(spec.policy, sched, transport,
                                       spec.source, spec.replicas,
                                       composer=composer, label=labels[i])
            for path, ds in catalog.items():
                other = merged.get(path)
                if other is None:
                    merged[path] = ds
                elif (other.bytes, other.files, other.directories,
                      other.unreadable) != (ds.bytes, ds.files,
                                            ds.directories, ds.unreadable):
                    raise ValueError(
                        f"federation {self.name!r}: dataset {path!r} differs "
                        "between members — shared paths must describe the "
                        "same data")
            demand = spec._build_demand(catalog, table, sched, transport,
                                        seed, label=labels[i])
            scrub = spec._build_scrub(catalog, table, injector,
                                      label=labels[i])
            rt = CampaignRuntime(spec, cfg, catalog, table, sched, notifier,
                                 label=labels[i], start_day=m.start_day,
                                 control=control, demand=demand, scrub=scrub)
            # route transport notifications (scan OOM, permission halts) by
            # everything this member may have in flight — bundles included.
            # ChainMap is a LIVE view: bundles cut mid-campaign route too.
            route_map = (ChainMap(catalog, composer.bundle_catalog)
                         if composer is not None else catalog)
            fed_notifier.attach(route_map, notifier)
            spec._attach_top_ups(rt, scale)
            obs = spec._build_obs(label=labels[i])
            if obs is not None:
                rt.obs = obs
                obs.attach(rt, shared)
            runtimes.append(rt)
        return FederationWorld(self, shared, runtimes, scale=scale,
                               seed=seed, n_datasets=n_datasets)
