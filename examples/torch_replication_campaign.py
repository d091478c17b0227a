"""The paper, end to end, on the PyTorch port: replicate a catalog from a
slow source to replica sites with the Figure-4 scheduler, driven through a
*named scenario* from ``repro_torch.scenarios`` (simulated WAN + live
dashboard).  Federation names run N campaigns over one shared world.  The
counterpart of ``examples/replication_campaign.py``, with its flags and
output line for line; the campaign is host numpy and launches no kernel,
so it runs the same with or without a card.

    PYTHONPATH=src python examples/torch_replication_campaign.py
        [--scenario paper-2022 | --scenario federation-paper-twice]
        [--datasets 120] [--scale 0.05]
        [--engine events|step] [--dashboard]

Watch for the paper's phases: LLNL->ALCF primary flow, re-route to OLCF
during ALCF maintenance, ALCF->OLCF relay traffic, permission-failure
quarantine + human fix, and termination with all replicas complete — or,
for a federation, two campaigns contending for the same source egress.
Demand scenarios (``--scenario esgf-serving``) additionally report the
serving hit-rate and p99 read latency as user traffic rides the campaign.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.campaign import FederationReport
from repro_torch.core.dashboard import (render_demand_text,
                                        render_federation_text, render_text)
from repro_torch.core.pause import DAY
from repro_torch.scenarios.events import run_world
from repro_torch.scenarios.registry import (get_scenario, list_federations,
                                            list_scenarios)
from repro_torch.scenarios.spec import FederationWorld


def _observer(world, args, total, state):
    """Single-campaign progress printer (the original example view)."""
    def observer(world, now):
        for ds, ok in world.notifier.fixed.items():
            if ok and ds not in state["fixed_seen"]:
                state["fixed_seen"].add(ds)
                print(f"[day {now/DAY:5.1f}] admin fixed {ds}")
        day = int(now / DAY)
        if day == state["day_printed"] or day % 2:
            return
        state["day_printed"] = day
        if args.dashboard:
            print(render_text(world.table, list(world.cfg.replicas), total,
                              now, campaign=world.spec.name))
            if world.demand is not None:
                print(render_demand_text(world.demand, now))
            return
        done_by = {r: len(world.table.succeeded_set(r))
                   for r in world.cfg.replicas}
        paused = " ".join(
            f"{s}:{'P' if world.pause.paused(s, now) else '-'}"
            for s in world.graph.sites)
        serving = ""
        if world.demand is not None:
            s = world.demand.summary()
            serving = (f"  hit={s['hit_rate']*100:.0f}%"
                       f" p99={s['p99_s']:.1f}s")
        print(f"[day {day:3d}] "
              + "  ".join(f"{r} {n}/{len(world.catalog)}"
                          for r, n in done_by.items())
              + f"  [{paused}]"
              f"  notifications={len(world.notifier.notifications)}"
              + serving)
    return observer


def _federation_observer(args, state):
    """Per-member progress rows, side by side."""
    def observer(world, now):
        day = int(now / DAY)
        if day == state["day_printed"] or day % 2:
            return
        state["day_printed"] = day
        if args.dashboard:
            print(render_federation_text(world, now))
            return
        parts = []
        for rt in world.runtimes:
            done = {r: len(rt.table.succeeded_set(r))
                    for r in rt.cfg.replicas}
            parts.append(f"{rt.label} " + "/".join(
                f"{r}:{n}" for r, n in done.items()))
        print(f"[day {day:3d}] " + "  ".join(parts))
    return observer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="paper-2022",
                    help="one of: "
                         f"{', '.join(list_scenarios() + list_federations())}")
    ap.add_argument("--datasets", type=int, default=120)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--engine", choices=("events", "step"), default="events")
    ap.add_argument("--dashboard", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    spec = get_scenario(args.scenario)
    print(f"# {spec.name}: {spec.description}\n")
    world = spec.build(scale=args.scale, seed=args.seed,
                       n_datasets=args.datasets)
    state = {"day_printed": -1, "fixed_seen": set()}
    if isinstance(world, FederationWorld):
        observer = _federation_observer(args, state)
    else:
        total = sum(d.bytes for d in world.catalog.values())
        observer = _observer(world, args, total, state)

    rep = run_world(world, engine=args.engine, on_iteration=observer)
    if isinstance(rep, FederationReport):
        print(f"\nfederation finished: span {rep.span_days:.1f} simulated "
              "days")
        for label, m in rep.members.items():
            print(f"  {label:12} started day {rep.started_day[label]:6.1f}  "
                  f"finished day {rep.finished_day[label]:6.1f}  "
                  f"faults={m.faults_total}")
    else:
        print(f"\ncampaign finished in {rep.duration_days:.1f} simulated "
              f"days (floor {rep.floor_days:.1f} d); "
              f"done={world.sched.done()}")
        if world.demand is not None:
            s = world.demand.summary()
            day90 = "-" if s["day90"] is None else f"day {s['day90']}"
            print(f"served {s['requests']:,} user requests: "
                  f"hit-rate {s['hit_rate']*100:.1f}% "
                  f"(90% reached {day90}), p99 {s['p99_s']:.1f}s, "
                  f"{s['bytes_served_tb']:.1f} TB from replicas")

    return 0

if __name__ == "__main__":
    sys.exit(main())
