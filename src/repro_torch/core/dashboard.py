"""Replication dashboard (paper Fig. 7): live view of the transfer tables.

Renders a progress table with one row per (campaign, destination) —
complete fraction, bytes, files, faults, live transfer count, aggregate
rate, and ETA — side by side across however many campaigns share the world,
followed (in the detailed view) by the ACTIVE / PAUSED transfers and the
most recent SUCCEEDED ones per destination.  The paper notes such a
dashboard was "relatively easy to create" and valuable for progress
communication and spotting failures; here it is a first-class feature that
covers federated campaigns too.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.transfer_table import Status, TransferRecord, TransferTable

# one campaign's dashboard identity: (label, table, destinations, total bytes)
CampaignEntry = Tuple[str, TransferTable, List[str], int]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if n < 1024 or unit == "PB":
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PB"


def _fmt_rate(bps: float) -> str:
    return _fmt_bytes(bps) + "/s"


def _fmt_eta(days: Optional[float]) -> str:
    if days == 0.0:
        return "done"
    if days is None or days != days or days == float("inf"):
        return "stalled"
    return f"{days:.1f} d"


# ------------------------------------------------------------- progress rows
def progress_rows(campaigns: Sequence[CampaignEntry]) -> List[Dict]:
    """One row per (campaign, destination): landed bytes/files/faults, the
    live transfer count, the current aggregate achieved rate, and the ETA at
    that rate.  This is the side-by-side federation view — pass one entry
    per campaign sharing the world."""
    rows: List[Dict] = []
    for label, table, destinations, total_bytes in campaigns:
        for dst in destinations:
            done = table.by_status(Status.SUCCEEDED, destination=dst)
            live = table.by_status(Status.ACTIVE, Status.QUEUED,
                                   Status.PAUSED, destination=dst)
            # faults count every row's accumulated faults — including rows
            # waiting out a retry backoff or quarantined — so the column is
            # monotonic and ends equal to the report's faults_total
            other = table.by_status(Status.FAILED, Status.QUARANTINED,
                                    destination=dst)
            got = table.bytes_at(dst)
            files = sum(r.files for r in done)
            faults = sum(r.faults for r in done + live + other)
            # a freshly resumed campaign's first tick can report rows with
            # zero elapsed active time: drop non-finite per-row rates so the
            # aggregate (and the ETA below) never goes inf/nan
            rate = sum(r.rate for r in live
                       if r.status == Status.ACTIVE
                       and r.rate == r.rate and r.rate != float("inf"))
            remaining = max(0, total_bytes - got)
            if remaining == 0:
                eta_days = 0.0
            elif rate > 0:
                eta_days = remaining / rate / 86400.0
            else:
                eta_days = None     # stalled: no JSON-hostile inf/nan
            rows.append({
                "campaign": label,
                "destination": dst,
                "complete_fraction": (got / total_bytes
                                      if total_bytes else 0.0),
                "bytes": got,
                "files": files,
                "faults": faults,
                "active": len(live),
                "rate": rate,
                "eta_days": eta_days,
            })
    return rows


def _render_rows(rows: Sequence[Dict], now: float) -> str:
    lines = [f"=== Replication progress @ t={now/86400:.2f} d ===",
             f"{'Campaign':16} {'Dest':6} {'Done':>6} {'Bytes':>10} "
             f"{'Files':>9} {'Faults':>6} {'Live':>4} {'Rate':>12} {'ETA':>8}"]
    for r in rows:
        lines.append(
            f"{r['campaign'][:16]:16} {r['destination']:6} "
            f"{r['complete_fraction']*100:5.1f}% "
            f"{_fmt_bytes(r['bytes']):>10} {r['files']:>9} "
            f"{r['faults']:>6} {r['active']:>4} "
            f"{_fmt_rate(r['rate']):>12} {_fmt_eta(r['eta_days']):>8}")
    return "\n".join(lines)


def render_progress(campaigns: Sequence[CampaignEntry], now: float) -> str:
    """The progress table as text: campaigns/destinations side by side."""
    return _render_rows(progress_rows(campaigns), now)


def render_federation_text(world, now: float) -> str:
    """Progress table for a compiled ``FederationWorld``: one row per
    (member campaign, destination), plus each member's control-plane state
    when one is attached."""
    campaigns = [(rt.label, rt.table, list(rt.cfg.replicas),
                  sum(d.bytes for d in rt.catalog.values()))
                 for rt in world.runtimes]
    lines = [render_progress(campaigns, now)]
    for rt in world.runtimes:
        if rt.control is not None:
            lines.append(render_policy_text(rt.control, now))
        if rt.demand is not None:
            lines.append(render_demand_text(rt.demand, now))
        if rt.scrub is not None:
            lines.append(render_scrub_text(rt.scrub, now))
        if rt.obs is not None:
            lines.append(render_obs_text(rt.obs, now))
    return "\n".join(lines)


# ------------------------------------------------------- control-plane view
def policy_rows(control) -> List[Dict]:
    """The control plane's live state as dashboard rows: current per-route
    concurrency caps, the composer's cut progress and current targets, and
    the most recent ledger decisions."""
    rows: List[Dict] = [{
        "campaign": control.label,
        "kind": "caps",
        "route_caps": {f"{s}->{d}": c
                       for (s, d), c in
                       sorted(control.sched.policy.route_caps.items())},
        "default_cap": control.sched.policy.max_active_per_route,
    }]
    comp = control.composer
    if comp is not None:
        rows.append({
            "campaign": control.label,
            "kind": "composer",
            "bundles_cut": len(comp.bundle_catalog),
            "exhausted": comp.done,
            "target_files": comp.target_files,
            "target_bytes": comp.target_bytes,
        })
    for e in control.ledger.entries[-8:]:
        rows.append(dict(e, campaign=control.label, kind="decision"))
    return rows


def render_policy_text(control, now: float) -> str:
    """The policy view as text: caps line, composer line, recent decisions."""
    lines = [f"--- policy [{control.label}] @ t={now/86400:.2f} d ---"]
    for r in policy_rows(control):
        if r["kind"] == "caps":
            caps = ", ".join(f"{k}:{v}" for k, v in r["route_caps"].items())
            lines.append(f"caps  default={r['default_cap']} "
                         f"{caps or '(all default)'}")
        elif r["kind"] == "composer":
            lines.append(
                f"bundles cut={r['bundles_cut']} "
                f"target={r['target_files']} files/"
                f"{_fmt_bytes(r['target_bytes'])} "
                f"{'EXHAUSTED' if r['exhausted'] else 'composing'}")
        else:
            what = (f"{'->'.join(r['route'])} cap {r['prev_cap']}->{r['cap']}"
                    if "route" in r else
                    f"target {r['target_files']} files/"
                    f"{_fmt_bytes(r['target_bytes'])}")
            lines.append(f"t={r['t_day']:.2f}d {r['controller']:8} {what} "
                         f"({r['gbps']:.3f} GB/s)")
    return "\n".join(lines)


# ------------------------------------------------------- demand-engine view
def demand_rows(demand) -> List[Dict]:
    """The demand engine's serving SLOs as dashboard rows: the hit-rate /
    latency / bytes-served headline, then one cache row per replica site."""
    s = demand.summary()
    rows: List[Dict] = [{
        "campaign": demand.label,
        "kind": "serving",
        "users": s["users"],
        "requests": s["requests"],
        "hit_rate": s["hit_rate"],
        "cache_hit_rate": s["cache_hit_rate"],
        "p50_s": s["p50_s"],
        "p99_s": s["p99_s"],
        "bytes_served_tb": s["bytes_served_tb"],
        "day90": s["day90"],
    }]
    for site, c in s["caches"].items():
        rows.append(dict(c, campaign=demand.label, kind="cache", site=site))
    return rows


def render_demand_text(demand, now: float) -> str:
    """The serving view as text: SLO line, one cache line per replica."""
    lines = [f"--- serving [{demand.label}] @ t={now/86400:.2f} d ---"]
    for r in demand_rows(demand):
        if r["kind"] == "serving":
            day90 = "-" if r["day90"] is None else f"{r['day90']}d"
            lines.append(
                f"users={r['users']:,} requests={r['requests']:,} "
                f"hit={r['hit_rate']*100:.1f}% "
                f"(cache {r['cache_hit_rate']*100:.1f}%) "
                f"p50={r['p50_s']:.3f}s p99={r['p99_s']:.1f}s "
                f"served={r['bytes_served_tb']:.1f} TB day90={day90}")
        else:
            lines.append(
                f"cache {r['site']:6} {r['entries']} entries "
                f"{_fmt_bytes(r['used_bytes'])} hits={r['hits']:,} "
                f"misses={r['misses']:,} evictions={r['evictions']:,}")
    return "\n".join(lines)


# -------------------------------------------------------- scrub-engine view
def scrub_rows(scrub) -> List[Dict]:
    """The scrub engine's integrity state as dashboard rows: one headline
    row — scan progress, detections/repairs, and the data currently at
    risk (landed but carrying undetected or unrepaired corruption)."""
    s = scrub.summary()
    return [{
        "campaign": scrub.label,
        "kind": "integrity",
        "scans": s["scans"],
        "scanned_replicas": s["scanned_replicas"],
        "scanned_bytes": s["scanned_bytes"],
        "detected": s["detected"],
        "repaired": s["repaired"],
        "at_risk_replicas": s["at_risk_replicas"],
        "repairing_replicas": s["repairing_replicas"],
        "data_at_risk_bytes": s["data_at_risk_bytes"],
        "corrupt_files": s["corrupt_files"],
        "corrupt_bytes": s["corrupt_bytes"],
        "exposure_days": s["exposure_days"],
        "clean": s["clean"],
    }]


def render_scrub_text(scrub, now: float) -> str:
    """The integrity view as text: one scrub/repair status line."""
    lines = [f"--- integrity [{scrub.label}] @ t={now/86400:.2f} d ---"]
    for r in scrub_rows(scrub):
        state = "CLEAN" if r["clean"] else (
            f"AT RISK {_fmt_bytes(r['data_at_risk_bytes'])} "
            f"({r['at_risk_replicas']} undetected, "
            f"{r['repairing_replicas']} repairing)")
        lines.append(
            f"scans={r['scans']} scanned={_fmt_bytes(r['scanned_bytes'])} "
            f"detected={r['detected']} repaired={r['repaired']} "
            f"exposure={r['exposure_days']:.2f} replica-days {state}")
    return "\n".join(lines)


# ------------------------------------------------------ flight-recorder view
def obs_rows(obs) -> List[Dict]:
    """The flight recorder's own health as dashboard rows: trace volume and
    ring retention, sample count, and the latest metrics sample headline."""
    rows: List[Dict] = []
    if obs.trace is not None:
        t = obs.trace.summary()
        rows.append(dict(t, campaign=obs.label, kind="trace"))
    if obs.metrics is not None:
        row = {"campaign": obs.label, "kind": "metrics",
               "samples": len(obs.samples)}
        if obs.samples:
            last = obs.samples[-1]
            row["t_day"] = last["t_day"]
            row["queue_depth"] = last["queue_depth"]
            row["backoff_depth"] = last["backoff_depth"]
        rows.append(row)
    return rows


def render_obs_text(obs, now: float) -> str:
    """The flight-recorder view as text: one line per stream."""
    lines = [f"--- obs [{obs.label}] @ t={now/86400:.2f} d ---"]
    for r in obs_rows(obs):
        if r["kind"] == "trace":
            lines.append(
                f"trace events={r['events']:,} retained={r['retained']:,} "
                f"dropped={r['dropped']:,} "
                f"ring={_fmt_bytes(r['ring_bytes'])}/"
                f"{_fmt_bytes(r['budget_bytes'])}")
        else:
            at = (f" last@d{r['t_day']:.2f} queue={r['queue_depth']} "
                  f"backoff={r['backoff_depth']}" if "t_day" in r else "")
            lines.append(f"metrics samples={r['samples']}{at}")
    return "\n".join(lines)


# ----------------------------------------------------------- detailed views
def snapshot(table: TransferTable, destinations: List[str],
             total_bytes: int, now: float, n_recent: int = 4,
             campaign: str = "campaign") -> Dict:
    out: Dict = {"now": now, "destinations": {},
                 "progress": progress_rows(
                     [(campaign, table, destinations, total_bytes)])}
    for dst in destinations:
        live = table.by_status(Status.ACTIVE, Status.PAUSED, destination=dst)
        done = table.by_status(Status.SUCCEEDED, destination=dst)
        done.sort(key=lambda r: r.completed or 0.0, reverse=True)
        got = sum(r.bytes_transferred for r in done)
        out["destinations"][dst] = {
            "complete_fraction": got / total_bytes if total_bytes else 0.0,
            "bytes": got,
            "succeeded": len(done),
            "rows": [_row(r) for r in live + done[:n_recent]],
        }
    return out


def row_dict(r: TransferRecord) -> Dict:
    """One transfer row as a JSON-clean dict — the single function shared by
    ``snapshot``/``render_json`` and the flight recorder's NDJSON sink.
    Non-finite rates (a resumed row's first tick) become None: the output
    must survive ``json.dumps(allow_nan=False)`` byte-stably."""
    rate = r.rate
    if rate != rate or rate in (float("inf"), float("-inf")):
        rate = None
    return {
        "dataset": r.dataset, "from": r.source, "requested": r.requested,
        "completed": r.completed, "status": r.status.value,
        "directories": r.directories, "files": r.files,
        "bytes_transferred": r.bytes_transferred, "faults": r.faults,
        "rate": rate,
    }


# backwards-compatible alias (the pre-obs private name)
_row = row_dict


def render_text(table: TransferTable, destinations: List[str],
                total_bytes: int, now: float,
                campaign: str = "campaign") -> str:
    snap = snapshot(table, destinations, total_bytes, now, campaign=campaign)
    by_dst = {r["destination"]: r for r in snap["progress"]}
    lines = [_render_rows(snap["progress"], now)]
    for dst, info in snap["destinations"].items():
        prog = by_dst[dst]
        lines.append(f"\nReplication to {dst}  "
                     f"[{info['complete_fraction']*100:5.1f}% — "
                     f"{_fmt_bytes(info['bytes'])} | "
                     f"{info['succeeded']} datasets | "
                     f"ETA {_fmt_eta(prog['eta_days'])}]")
        lines.append(f"{'No':>3} {'Dataset':54} {'From':5} {'Status':12} "
                     f"{'Files':>9} {'Bytes':>10} {'Faults':>6} {'Rate':>12}")
        for i, r in enumerate(info["rows"], 1):
            lines.append(
                f"{i:>3} {r['dataset'][:54]:54} {r['from']:5} "
                f"{r['status']:12} {r['files']:>9} "
                f"{_fmt_bytes(r['bytes_transferred']):>10} {r['faults']:>6} "
                f"{_fmt_rate(r['rate'] or 0.0):>12}")
    return "\n".join(lines)


def render_json(table: TransferTable, destinations: List[str],
                total_bytes: int, now: float) -> str:
    return json.dumps(snapshot(table, destinations, total_bytes, now), indent=2)
