"""Named campaign scenarios.

Each entry is a complete ``ScenarioSpec``.  ``paper-2022`` reproduces the
campaign wiring of ``repro_torch.core.campaign.build_campaign`` exactly (same
topology, same calendar, same fault profile); the rest are the what-if
studies the paper's capacity-planning discussion calls for — degraded
source, storms of transient faults, flaky networking, a fourth site, a
mid-campaign top-up, and a cold start where relays carry almost everything.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.control.policy import TransferPolicySpec
from repro_torch.core.routes import GB, TB
from repro_torch.core.scrub import ScrubSpec
from repro_torch.ensemble.spec import AxisSpec, EnsembleSpec
from repro_torch.scenarios.crash_resume import (CRASH_RESUME_SCENARIOS,
                                          CrashResumeSpec)
from repro_torch.demand.spec import DemandSpec
from repro_torch.obs.spec import ObsSpec
from repro_torch.scenarios.spec import (CatalogSpec, FaultProfileSpec,
                                  FederationMemberSpec, FederationSpec,
                                  OutageSpec, RouteSpec, ScenarioSpec,
                                  SiteSpec, TopUpSpec)

# --------------------------------------------------------------- paper sites
_LLNL = SiteSpec("LLNL", read_gbps=1.5, write_gbps=1.5,
                 scan_files_per_s=20_000, scan_mem_limit_files=2_000_000)
_ALCF = SiteSpec("ALCF", read_gbps=10.0, write_gbps=10.0)
_OLCF = SiteSpec("OLCF", read_gbps=10.0, write_gbps=10.0)
_NERSC = SiteSpec("NERSC", read_gbps=10.0, write_gbps=10.0)

_PAPER_ROUTES = (
    RouteSpec("LLNL", "ALCF", 2 * 0.648),
    RouteSpec("LLNL", "OLCF", 2 * 0.662),
    RouteSpec("ALCF", "OLCF", 2 * 1.706),
    RouteSpec("OLCF", "ALCF", 2 * 2.352),
)

# paper Fig. 5 calendar: OLCF DTN online day 5; ALCF extended maintenance
# days 5-10 then weekly 12 h from day 17; OLCF weekly 12 h from day 40.
_PAPER_OUTAGES = (
    OutageSpec("OLCF", start_day=0.0, duration_h=5 * 24.0, planned=False),
    OutageSpec("ALCF", start_day=5.0, duration_h=5 * 24.0),
    OutageSpec("ALCF", start_day=17.0, duration_h=12.0, weekly=True),
    OutageSpec("OLCF", start_day=40.0, duration_h=12.0, weekly=True),
)

PAPER_2022 = ScenarioSpec(
    name="paper-2022",
    description="The 2022 campaign as published: LLNL sources 7.3 PB to "
                "ALCF and OLCF over Table-3 routes with the Fig.-5 "
                "maintenance calendar and the CMIP5 permission incident.",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF), routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES)

FOUR_SITE_MESH = ScenarioSpec(
    name="four-site-mesh",
    description="A fourth LCF (NERSC) joins: three replicas on a full "
                "inter-LCF relay mesh — does the slow source still bound "
                "the campaign?",
    source="LLNL", replicas=("ALCF", "OLCF", "NERSC"),
    sites=(_LLNL, _ALCF, _OLCF, _NERSC),
    routes=_PAPER_ROUTES + (
        RouteSpec("LLNL", "NERSC", 2 * 0.650),
        RouteSpec("ALCF", "NERSC", 2 * 1.800),
        RouteSpec("NERSC", "ALCF", 2 * 1.800),
        RouteSpec("OLCF", "NERSC", 2 * 2.000),
        RouteSpec("NERSC", "OLCF", 2 * 2.000),
    ),
    outages=_PAPER_OUTAGES)

DEGRADED_SOURCE = ScenarioSpec(
    name="degraded-source",
    description="The source file system at half health: LLNL reads at "
                "0.75 GB/s and scans at half speed — how much does the "
                "58-day floor stretch?",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(SiteSpec("LLNL", read_gbps=0.75, write_gbps=0.75,
                    scan_files_per_s=10_000,
                    scan_mem_limit_files=2_000_000),
           _ALCF, _OLCF),
    routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES,
    max_days=400.0)

FAULT_STORM = ScenarioSpec(
    name="fault-storm",
    description="20x the transient-fault intensity with a heavier fragility "
                "tail: does bounded retry + quarantine still converge?",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF), routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES,
    faults=FaultProfileSpec(transient_per_tb=3.0, fragility_tail=1.8,
                            max_retries=10, backoff_s=1800.0))

HARSH_FAULTS = ScenarioSpec(
    name="harsh-faults",
    description="The fault-storm profile compounded by unplanned multi-day "
                "DTN outages, with the flight recorder on: the post-mortem "
                "walkthrough scenario (EXPERIMENTS.md) — read the outage "
                "timeline back out of the recorded stream.",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF), routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES + (
        # unplanned mid-campaign DTN failures on top of the Fig.-5 calendar
        OutageSpec("ALCF", start_day=9.0, duration_h=36.0, planned=False),
        OutageSpec("OLCF", start_day=21.0, duration_h=60.0, planned=False),
        OutageSpec("ALCF", start_day=33.5, duration_h=6.0, weekly=True),
    ),
    faults=FaultProfileSpec(transient_per_tb=3.0, fragility_tail=1.8,
                            max_retries=10, backoff_s=1800.0),
    obs=ObsSpec(trace=True, metrics=True),
    max_days=400.0)

FLAKY_NETWORK = ScenarioSpec(
    name="flaky-network",
    description="Routes at 60% of Table-3 bandwidth plus short unplanned "
                "outages every few days at both replicas.",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF),
    routes=tuple(RouteSpec(r.source, r.destination, 0.6 * r.gbps)
                 for r in _PAPER_ROUTES),
    outages=_PAPER_OUTAGES + (
        OutageSpec("ALCF", start_day=3.0, duration_h=3.0, weekly=True,
                   planned=False),
        OutageSpec("OLCF", start_day=8.5, duration_h=4.0, weekly=True,
                   planned=False),
        OutageSpec("ALCF", start_day=11.25, duration_h=2.0, weekly=True,
                   planned=False),
    ),
    faults=FaultProfileSpec(transient_per_tb=0.6),
    max_days=400.0)

INCREMENTAL_TOP_UP = ScenarioSpec(
    name="incremental-top-up",
    description="New ESGF publications land mid-campaign (paper C7): the "
                "daily incremental check folds them into the same table "
                "and the campaign absorbs them.",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF), routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES,
    top_ups=(TopUpSpec(publish_day=12.0, n_datasets=6),
             TopUpSpec(publish_day=20.0, n_datasets=4)))

COLD_START_RELAY = ScenarioSpec(
    name="cold-start-relay",
    description="Cold start at four sites with thin source egress beyond "
                "the primary: every replica but ALCF is fed almost "
                "entirely by replica-to-replica relays.",
    source="LLNL", replicas=("ALCF", "OLCF", "NERSC"),
    sites=(_LLNL, _ALCF, _OLCF, _NERSC),
    routes=(
        RouteSpec("LLNL", "ALCF", 2 * 0.648),
        # thin direct paths: usable during primary maintenance, otherwise
        # relays dominate
        RouteSpec("LLNL", "OLCF", 0.10),
        RouteSpec("LLNL", "NERSC", 0.10),
        RouteSpec("ALCF", "OLCF", 2 * 1.706),
        RouteSpec("OLCF", "ALCF", 2 * 2.352),
        RouteSpec("ALCF", "NERSC", 2 * 1.800),
        RouteSpec("NERSC", "ALCF", 2 * 1.800),
        RouteSpec("OLCF", "NERSC", 2 * 2.000),
        RouteSpec("NERSC", "OLCF", 2 * 2.000),
    ),
    outages=(OutageSpec("ALCF", start_day=20.0, duration_h=12.0,
                        weekly=True),),
    max_days=400.0)


MEGA_CAMPAIGN = ScenarioSpec(
    name="mega-campaign",
    description="Production-scale stress: the same 7.3 PB sliced into "
                "20,480 datasets replicated to three LCFs over the "
                "four-site mesh — ~61k table rows, the regime where "
                "per-iteration cost must stay O(active), not O(catalog).",
    source="LLNL", replicas=("ALCF", "OLCF", "NERSC"),
    sites=(_LLNL, _ALCF, _OLCF, _NERSC),
    routes=_PAPER_ROUTES + (
        RouteSpec("LLNL", "NERSC", 2 * 0.650),
        RouteSpec("ALCF", "NERSC", 2 * 1.800),
        RouteSpec("NERSC", "ALCF", 2 * 1.800),
        RouteSpec("OLCF", "NERSC", 2 * 2.000),
        RouteSpec("NERSC", "OLCF", 2 * 2.000),
    ),
    outages=_PAPER_OUTAGES,
    catalog=CatalogSpec(n_datasets=20_480),
    max_days=400.0)


# -------------------------------------------------- control-plane scenarios
# The paper's tool moved 28.9 M files by packing them into large Globus
# tasks; Globus itself tuned concurrency under the covers.  These scenarios
# make that control plane load-bearing: each declares a TransferPolicySpec
# and a per-task dispatch cost (``task_setup_s``) that naive one-task-per-
# dataset scheduling cannot amortize.
SMALL_FILE_STORM = ScenarioSpec(
    name="small-file-storm",
    description="500k tiny files across 2,000 small datasets with a 45 s "
                "per-task dispatch cost: one task per dataset drowns in "
                "dispatch overhead; the declared policy bundles the "
                "catalog into large tasks and AIMD-tunes route concurrency "
                "(the regime where Globus bundling beat scripted scp).",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF), routes=_PAPER_ROUTES,
    catalog=CatalogSpec(n_datasets=2000, total_bytes=2 * TB,
                        total_files=500_000, unreadable_fraction=0.0),
    task_setup_s=45.0,
    policy=TransferPolicySpec(
        bundling="greedy", controller="aimd",
        target_files=25_000, target_bytes=200 * GB,
        max_files=100_000, max_bytes=1 * TB,
        control_interval_s=3600.0,
        max_active_per_route=6),
    max_days=50.0)

MIXED_BUNDLE_PAPER = ScenarioSpec(
    name="mixed-bundle-paper",
    description="paper-2022 with per-dataset file manifests: the composer "
                "packs individual files into size-balanced bundles that "
                "may span datasets, and the gradient tuner steers future "
                "bundle sizing from observed throughput.",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL, _ALCF, _OLCF), routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES,
    task_setup_s=30.0,
    policy=TransferPolicySpec(
        bundling="balanced", granularity="file", controller="gradient",
        target_files=500_000, target_bytes=100 * TB,
        max_files=1_500_000, max_bytes=400 * TB,
        balance_batch=4,
        control_interval_s=12 * 3600.0),
    max_days=400.0)

# contention-kneed DTNs: aggregate throughput degrades beyond the knee, so
# concurrency has a real optimum for the AIMD tuner to find
_LLNL_KNEE = SiteSpec("LLNL", read_gbps=1.5, write_gbps=1.5,
                      scan_files_per_s=20_000,
                      scan_mem_limit_files=2_000_000, concurrency_knee=4)
_ALCF_KNEE = SiteSpec("ALCF", read_gbps=10.0, write_gbps=10.0,
                      concurrency_knee=6)
_OLCF_KNEE = SiteSpec("OLCF", read_gbps=10.0, write_gbps=10.0,
                      concurrency_knee=6)

LOSSY_ROUTE_TUNING = ScenarioSpec(
    name="lossy-route-tuning",
    description="Elevated NETWORK fault intensity over contention-kneed "
                "DTNs, launched over-parallel (6 transfers/route against a "
                "source knee of 4): the static baseline thrashes the DTNs "
                "for the whole campaign; the AIMD tuner observes the "
                "fault/throughput signal and backs concurrency off toward "
                "the knee.",
    source="LLNL", replicas=("ALCF", "OLCF"),
    sites=(_LLNL_KNEE, _ALCF_KNEE, _OLCF_KNEE), routes=_PAPER_ROUTES,
    outages=_PAPER_OUTAGES,
    faults=FaultProfileSpec(transient_per_tb=2.0, fragility_tail=1.9,
                            max_retries=10, backoff_s=1800.0),
    max_active_per_route=6,
    policy=TransferPolicySpec(
        controller="aimd", control_interval_s=6 * 3600.0,
        max_active_per_route=8),
    max_days=400.0)


# ---------------------------------------------------------- demand scenarios
# The point of the 7.3 PB was never the bytes: it was serving ESGF users
# from replicas near their compute.  These scenarios add a synthetic user
# population reading the catalog WHILE it replicates — requests served from
# whichever replica holds the dataset (else redirected to the slow source),
# user reads contending with movers for the site read caps, and popularity
# feeding back into replication order.
_ESGF_DEMAND = DemandSpec(
    users=2_000_000,                 # ~ESGF registered-user order of magnitude
    requests_per_user_day=0.01,      # ~20k dataset reads/day across the fleet
    zipf_s=1.1,
    wave_interval_s=6 * 3600.0,
    request_bytes=4 * GB,
    cache_bytes=int(1.5 * TB),
    eviction="lru",
    prioritize=True)

ESGF_SERVING = PAPER_2022.vary(
    name="esgf-serving",
    description="paper-2022 while 2M ESGF users read the catalog: requests "
                "land on whichever replica holds a dataset (else redirect "
                "to the slow source), user reads contend with movers for "
                "the site read caps, and popularity re-orders replication "
                "popular-first.",
    demand=_ESGF_DEMAND)

POPULAR_FIRST_VS_CATALOG_ORDER = PAPER_2022.vary(
    name="popular-first-vs-catalog-order",
    description="The esgf-serving ablation: identical traffic but "
                "replication keeps catalog order (no popularity feedback) "
                "— the comparator that shows what popular-first buys in "
                "time-to-90%-hit-rate.",
    demand=dataclasses.replace(_ESGF_DEMAND, prioritize=False))

CACHE_PRESSURE = PAPER_2022.vary(
    name="cache-pressure",
    description="Serving under cache pressure: 6M users, 64 GB replica "
                "caches, popularity-weighted eviction, demand-driven "
                "warm-ups, and popularity drifting every 20 days.",
    demand=DemandSpec(
        users=6_000_000,
        requests_per_user_day=0.01,
        zipf_s=1.1,
        drift_interval_days=20.0,
        drift_fraction=0.25,
        wave_interval_s=6 * 3600.0,
        request_bytes=4 * GB,
        cache_bytes=64 * GB,
        eviction="popularity",
        warm_per_wave=2,
        prioritize=True))


# --------------------------------------------------------- integrity scenarios
# Silent corruption: a small fraction of landed bytes are bad on arrival
# (undetected by the in-flight INTEGRITY faults, which fire and retry during
# the transfer).  The scrub engine periodically re-verifies landed replicas
# in size-bounded passes and routes detected replicas back through the
# ordinary retry/relay machinery as repairs.  The rate is accelerated
# (~25 bad replicas/PB landed, vs real-world fractions of one) so that
# reduced-shape CI replays still draw a handful of corruptions.
_SCRUB = ScrubSpec(latent_per_pb=25.0, interval_days=5.0,
                   scan_tb_per_pass=2000.0)

SCRUB_AND_REPAIR = PAPER_2022.vary(
    name="scrub-and-repair",
    description="paper-2022 with accelerated latent corruption (~25 bad "
                "replicas/PB landed) and a 5-day scrub cadence at 2 PB/pass: "
                "detected replicas are re-transferred through the normal "
                "retry path, contending with live replication, until the "
                "campaign ends corruption-free.",
    scrub=_SCRUB)

BIT_ROT_PAPER = PAPER_2022.vary(
    name="bit-rot-paper",
    description="The no-scrub ablation: identical latent-corruption draws "
                "but no re-verification ever runs — the campaign 'succeeds' "
                "while silently corrupt replicas survive to the end, "
                "measurable in the integrity summary.",
    scrub=dataclasses.replace(_SCRUB, interval_days=0.0))

CORRUPT_UNDER_DEMAND = ESGF_SERVING.vary(
    name="corrupt-under-demand",
    description="esgf-serving with latent corruption and scrubbing: "
                "detected replicas drop out of the serveable set (hit rate "
                "dips), repairs contend with user traffic for the read "
                "caps, and the serveable set recovers as repairs land.",
    scrub=_SCRUB)


# ------------------------------------------------------ federation scenarios
# The paper's actual regime: the 29M-file catalog was moved TWICE — to ANL
# and to ORNL — as two overlapping campaigns contending for the same
# ~1.5 GB/s source file system.  Each half below is a complete
# single-destination campaign; the federation family runs them over one
# shared world (one clock/transport/LLNL read cap).
PAPER_TO_ALCF = ScenarioSpec(
    name="paper-to-alcf",
    description="The ALCF half of the 2022 campaign as its own campaign: "
                "LLNL sources 7.3 PB to ALCF over the direct route only "
                "(no inter-LCF relay), with the ALCF maintenance calendar.",
    source="LLNL", replicas=("ALCF",),
    sites=(_LLNL, _ALCF),
    routes=(RouteSpec("LLNL", "ALCF", 2 * 0.648),),
    outages=(OutageSpec("ALCF", start_day=5.0, duration_h=5 * 24.0),
             OutageSpec("ALCF", start_day=17.0, duration_h=12.0,
                        weekly=True)),
    max_days=400.0)

PAPER_TO_OLCF = ScenarioSpec(
    name="paper-to-olcf",
    description="The OLCF half of the 2022 campaign as its own campaign: "
                "LLNL sources 7.3 PB to OLCF direct, with OLCF's late DTN "
                "start and maintenance calendar.",
    source="LLNL", replicas=("OLCF",),
    sites=(_LLNL, _OLCF),
    routes=(RouteSpec("LLNL", "OLCF", 2 * 0.662),),
    outages=(OutageSpec("OLCF", start_day=0.0, duration_h=5 * 24.0,
                        planned=False),
             OutageSpec("OLCF", start_day=40.0, duration_h=12.0,
                        weekly=True)),
    max_days=400.0)

FEDERATION_PAPER_TWICE = FederationSpec(
    name="federation-paper-twice",
    description="The paper moved the catalog twice: the ALCF and OLCF "
                "pulls as two OVERLAPPED independent campaigns contending "
                "for the shared 1.5 GB/s LLNL source — aggregate LLNL "
                "egress stays capped at read_bw while both make progress.",
    members=(FederationMemberSpec(PAPER_TO_ALCF, start_day=0.0,
                                  label="alcf"),
             FederationMemberSpec(PAPER_TO_OLCF, start_day=0.0,
                                  label="olcf")),
    shared_sites=("LLNL",))

# the paper's headline regime end-to-end: all 28.9 M files moved TWICE, at
# file granularity.  Both members run the mixed-bundle-paper control plane —
# the composer synthesizes each dataset's file manifest and packs file runs
# into size-balanced bundles — so the simulator's unit of work is the same
# as the tool's (Globus tasks over file batches), not a per-dataset proxy.
# This is the scale point the array-native hot path is gated on: the full
# two-destination replay must stay O(active bundles) in memory and complete
# in minutes on one core (see benchmarks/check_regression.py check_scaling).
_PAPER_29M_POLICY = TransferPolicySpec(
    bundling="balanced", granularity="file", controller="gradient",
    target_files=500_000, target_bytes=100 * TB,
    max_files=1_500_000, max_bytes=400 * TB,
    balance_batch=4,
    control_interval_s=12 * 3600.0)

PAPER_29M_TWICE = dataclasses.replace(
    FEDERATION_PAPER_TWICE.with_policy(_PAPER_29M_POLICY),
    name="paper-29m-twice",
    description="The catalog's 28.9 M files moved twice at file "
                "granularity: the ALCF and OLCF pulls as overlapped "
                "campaigns whose control planes pack file runs into "
                "size-balanced bundles — the paper-scale stress point for "
                "the O(active) hot path.")

FEDERATION_PAPER_SERIAL = FederationSpec(
    name="federation-paper-serial",
    description="The serial comparator: the same two pulls back to back "
                "(OLCF starts only after the ALCF campaign's window), so "
                "LLNL egress is never shared — total campaign days must "
                "LOSE to federation-paper-twice.",
    members=(FederationMemberSpec(PAPER_TO_ALCF, start_day=0.0,
                                  label="alcf"),
             FederationMemberSpec(PAPER_TO_OLCF, start_day=100.0,
                                  label="olcf")),
    shared_sites=("LLNL",))

FEDERATION_PAPER_AND_TOPUP = FederationSpec(
    name="federation-paper-and-topup",
    description="Mixed federation: the relay-assisted two-destination "
                "paper campaign and an incremental top-up campaign share "
                "one world — every site and route is contended.",
    members=(FederationMemberSpec(PAPER_2022, start_day=0.0,
                                  label="paper"),
             FederationMemberSpec(INCREMENTAL_TOP_UP, start_day=2.0,
                                  label="topup")),
    shared_sites=("LLNL", "ALCF", "OLCF"))


# ------------------------------------------------------ ensemble scenarios
# Batched what-if studies over the specs above: a base scenario plus
# perturbation axes, run as N lanes in lockstep by repro_torch.ensemble (or as N
# scalar replays when the base needs an event-driven subsystem).

ENSEMBLE_PAPER_BANDS = EnsembleSpec(
    name="ensemble-paper-bands",
    base=PAPER_2022,
    n_lanes=256)                     # pure seed sweep; lane 0 == paper-2022
"""Confidence bands for the headline result: the 2022 campaign replayed
across 256 world seeds (catalog draw + fault stream), reduced to
p5/p50/p95 campaign days.  Lane 0 is the unperturbed paper-2022 world the
bit-identity gate replays against the scalar engine."""

AIMD_SEARCH = EnsembleSpec(
    name="aimd-search",
    base=LOSSY_ROUTE_TUNING,
    axes=(AxisSpec("policy.fault_budget", (4, 8, 16)),
          AxisSpec("policy.drop_fraction", (0.10, 0.15, 0.25)),
          AxisSpec("policy.control_interval_s",
                   (3 * 3600.0, 6 * 3600.0, 12 * 3600.0))),
    n_lanes=27, mode="grid")
"""Grid search over the AIMD tuner's constants on the lossy-route scenario
(3 x 3 x 3 = 27 lanes).  Policy axes compile to a control plane, so this
ensemble runs on the scalar fallback; the search driver checkpoints
progress between chunks."""

SEED_SWEEP_FEDERATION = EnsembleSpec(
    name="seed-sweep-federation",
    base=FEDERATION_PAPER_TWICE,
    n_lanes=8)
"""Seed sweep over the overlapped two-campaign federation — federations
need the shared-transport scalar path, so every lane is an independent
event-engine replay reduced to one row (span days, summed counters)."""

_ENSEMBLE_REGISTRY: Dict[str, EnsembleSpec] = {
    s.name: s for s in (ENSEMBLE_PAPER_BANDS, AIMD_SEARCH,
                        SEED_SWEEP_FEDERATION)
}


_REGISTRY: Dict[str, ScenarioSpec] = {
    s.name: s for s in (
        PAPER_2022, FOUR_SITE_MESH, DEGRADED_SOURCE, FAULT_STORM,
        HARSH_FAULTS,
        FLAKY_NETWORK, INCREMENTAL_TOP_UP, COLD_START_RELAY, MEGA_CAMPAIGN,
        PAPER_TO_ALCF, PAPER_TO_OLCF,
        SMALL_FILE_STORM, MIXED_BUNDLE_PAPER, LOSSY_ROUTE_TUNING,
        ESGF_SERVING, POPULAR_FIRST_VS_CATALOG_ORDER, CACHE_PRESSURE,
        SCRUB_AND_REPAIR, BIT_ROT_PAPER, CORRUPT_UNDER_DEMAND)
}

_FEDERATION_REGISTRY: Dict[str, FederationSpec] = {
    s.name: s for s in (FEDERATION_PAPER_TWICE, FEDERATION_PAPER_SERIAL,
                        FEDERATION_PAPER_AND_TOPUP, PAPER_29M_TWICE)
}

# the crash-injection family: kill/resume meta-scenarios wrapping the specs
# above (run via repro_torch.scenarios.crash_resume.run_crash_resume, not build())
_CRASH_REGISTRY: Dict[str, "CrashResumeSpec"] = dict(CRASH_RESUME_SCENARIOS)


def list_scenarios() -> List[str]:
    """Names of the plain (buildable) ``ScenarioSpec`` scenarios."""
    return sorted(_REGISTRY)


def list_federations() -> List[str]:
    """Names of the federated (N concurrent campaigns) scenario family."""
    return sorted(_FEDERATION_REGISTRY)


def list_crash_scenarios() -> List[str]:
    """Names of the crash-resume (kill/resume) scenario family."""
    return sorted(_CRASH_REGISTRY)


def list_ensembles() -> List[str]:
    """Names of the ensemble (batched what-if) scenario family."""
    return sorted(_ENSEMBLE_REGISTRY)


def scenario_tags(spec) -> List[str]:
    """Feature tags for a registry entry (``--list`` annotations): which
    opt-in subsystems the scenario exercises."""
    tags: List[str] = []
    if isinstance(spec, CrashResumeSpec):
        tags.append("crash-resume")
        spec = get_scenario(spec.base)   # tag by the wrapped base scenario
    if isinstance(spec, EnsembleSpec):
        tags.append("ensemble")
        tags.extend(scenario_tags(spec.base))   # tag by the base scenario
        return tags
    if isinstance(spec, FederationSpec):
        tags.append("federation")
        if any(m.scenario.policy.enabled for m in spec.members) or (
                spec.policy is not None and spec.policy.enabled):
            tags.append("policy")
        if any(m.scenario.demand.enabled for m in spec.members):
            tags.append("demand")
        if any(m.scenario.scrub.enabled for m in spec.members):
            tags.append("scrub")
        if any(m.scenario.obs.enabled for m in spec.members):
            tags.append("obs")
        return tags
    if getattr(spec, "policy", None) is not None and spec.policy.enabled:
        tags.append("policy")
    if getattr(spec, "demand", None) is not None and spec.demand.enabled:
        tags.append("demand")
    if getattr(spec, "scrub", None) is not None and spec.scrub.enabled:
        tags.append("scrub")
    if getattr(spec, "obs", None) is not None and spec.obs.enabled:
        tags.append("obs")
    if getattr(spec, "top_ups", ()):
        tags.append("top-ups")
    return tags


def get_scenario(name: str):
    """Look up a scenario by name: a ``ScenarioSpec``, a ``FederationSpec``
    for the federation family, a ``CrashResumeSpec`` for the crash-resume
    family, or an ``EnsembleSpec`` for the ensemble family."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _FEDERATION_REGISTRY:
        return _FEDERATION_REGISTRY[name]
    if name in _CRASH_REGISTRY:
        return _CRASH_REGISTRY[name]
    if name in _ENSEMBLE_REGISTRY:
        return _ENSEMBLE_REGISTRY[name]
    known = (sorted(_REGISTRY) + sorted(_FEDERATION_REGISTRY)
             + sorted(_CRASH_REGISTRY) + sorted(_ENSEMBLE_REGISTRY))
    raise KeyError(
        f"unknown scenario {name!r}; available: {', '.join(known)}")


def register(spec):
    """Add a custom scenario (tests and downstream configs); federation and
    crash-resume specs go into their own family registries."""
    if isinstance(spec, CrashResumeSpec):
        _CRASH_REGISTRY[spec.name] = spec
    elif isinstance(spec, FederationSpec):
        _FEDERATION_REGISTRY[spec.name] = spec
    elif isinstance(spec, EnsembleSpec):
        _ENSEMBLE_REGISTRY[spec.name] = spec
    else:
        _REGISTRY[spec.name] = spec
    return spec
