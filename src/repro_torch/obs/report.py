"""Campaign post-mortem reports from a recorded flight-recorder stream.

    python -m repro_torch.obs.report RUN.ndjson [--top 5] [--perfetto OUT.json]

Reads the NDJSON stream a run wrote via ``--obs`` (or an ``ObsSpec`` with a
sink) and renders what an operator wants after a campaign: the days-vs-bytes
curve per destination, the fault/outage timeline (per-interval fault counts
and paused transfers), the top-N slowest routes by achieved throughput, and
the most-retried datasets.  ``--perfetto`` additionally converts the trace
records to Chrome trace-event JSON for https://ui.perfetto.dev.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List

from repro_torch.obs.trace import to_chrome

PB = 1e15
TB = 1e12


def load_stream(path: str) -> Dict[str, List[dict]]:
    """Split one NDJSON stream into its record kinds."""
    out: Dict[str, List[dict]] = {"meta": [], "metrics": [], "trace": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.setdefault(rec.get("k", "?"), []).append(rec)
    return out


def _fmt_bytes(n: float) -> str:
    if n >= PB:
        return f"{n / PB:.2f} PB"
    if n >= TB:
        return f"{n / TB:.2f} TB"
    return f"{n / 1e9:.1f} GB"


def _bar(frac: float, width: int = 40) -> str:
    frac = min(max(frac, 0.0), 1.0)
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _thin(rows: List, limit: int) -> List:
    """At most ``limit`` rows, evenly spaced, always keeping the last."""
    if len(rows) <= limit:
        return rows
    step = (len(rows) - 1) / (limit - 1)
    return [rows[round(i * step)] for i in range(limit)]


def progress_curve(metrics: List[dict], width: int = 40,
                   rows: int = 20) -> List[str]:
    """Days-vs-bytes: one bar per sampled day, summed over destinations
    (federations render per-campaign curves separately)."""
    by_campaign: Dict[str, List[dict]] = defaultdict(list)
    for m in metrics:
        by_campaign[m.get("campaign", "")].append(m)
    lines: List[str] = []
    for camp in sorted(by_campaign):
        samples = by_campaign[camp]
        total = [(m["t_day"], sum(m.get("bytes_at", {}).values()))
                 for m in samples]
        peak = max((b for _, b in total), default=0) or 1
        lines.append(f"[{camp}] days vs bytes landed "
                     f"(peak {_fmt_bytes(peak)})")
        for t, b in _thin(total, rows):
            lines.append(f"  d{t:8.2f} |{_bar(b / peak, width)}| "
                         f"{_fmt_bytes(b)}")
    return lines


def fault_timeline(metrics: List[dict], trace: List[dict],
                   rows: int = 30) -> List[str]:
    """Per-interval fault counts from the metrics stream, merged with
    pause/quarantine instants from the trace — the outage view."""
    lines: List[str] = ["fault / outage timeline"]
    ticks: List[tuple] = []
    for m in metrics:
        faults = sum(r.get("faults", 0) for r in m.get("routes", {}).values())
        paused = m.get("status", {}).get("PAUSED", 0)
        if faults or paused:
            ticks.append((m["t_day"], m.get("campaign", ""), faults, paused))
    if not ticks:
        lines.append("  (no faults or paused transfers recorded)")
    peak = max((f for _, _, f, _ in ticks), default=0) or 1
    for t, camp, faults, paused in _thin(ticks, rows):
        tag = f" paused={paused}" if paused else ""
        lines.append(f"  d{t:8.2f} [{camp}] |{_bar(faults / peak, 20)}| "
                     f"{faults} faults{tag}")
    quarantined = [e for e in trace if e.get("event") == "quarantined"]
    if quarantined:
        lines.append(f"  quarantined datasets ({len(quarantined)}):")
        for e in quarantined[:10]:
            lines.append(f"    d{e['t'] / 86400.0:8.2f} {e.get('dataset')} "
                         f"-> {e.get('dest')} after "
                         f"{e.get('faults', '?')} faults")
    return lines


def slowest_routes(metrics: List[dict], top: int = 5) -> List[str]:
    """Mean achieved Gb/s per route over the intervals it was moving."""
    acc: Dict[str, List[float]] = defaultdict(list)
    for m in metrics:
        for route, r in m.get("routes", {}).items():
            if r.get("gbps", 0.0) > 0.0:
                acc[route].append(r["gbps"])
    ranked = sorted(((sum(v) / len(v), route) for route, v in acc.items()))
    lines = [f"top {top} slowest routes (mean active Gb/s)"]
    if not ranked:
        lines.append("  (no route throughput recorded)")
    for gbps, route in ranked[:top]:
        lines.append(f"  {route:24s} {gbps:8.3f} Gb/s "
                     f"over {len(acc[route])} active intervals")
    return lines


def most_retried(trace: List[dict], top: int = 5) -> List[str]:
    """Datasets by failed-attempt count (from trace ``failed`` events)."""
    fails: Dict[str, int] = defaultdict(int)
    for e in trace:
        if e.get("event") == "failed" and e.get("dataset"):
            fails[e["dataset"]] += 1
    ranked = sorted(fails.items(), key=lambda kv: (-kv[1], kv[0]))
    lines = [f"top {top} most-retried datasets"]
    if not ranked:
        lines.append("  (no failures recorded in trace window)")
    for ds, n in ranked[:top]:
        lines.append(f"  {ds:32s} {n} failed attempts")
    return lines


def render(stream: Dict[str, List[dict]], top: int = 5) -> str:
    metrics, trace = stream.get("metrics", []), stream.get("trace", [])
    meta = stream.get("meta", [])
    head = ["campaign post-mortem"]
    for m in meta:
        if "scenario" in m:
            head.append(f"  scenario={m.get('scenario')} "
                        f"campaign={m.get('campaign')} "
                        f"trace={m.get('trace')} metrics={m.get('metrics')}")
        elif "end_day" in m:
            head.append(f"  [{m.get('campaign')}] "
                        f"ended day {m['end_day']:.2f}")
    head.append(f"  records: {len(metrics)} metrics samples, "
                f"{len(trace)} trace events")
    sections = [head,
                progress_curve(metrics),
                fault_timeline(metrics, trace),
                slowest_routes(metrics, top=top),
                most_retried(trace, top=top)]
    return "\n".join("\n".join(s) for s in sections if s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a campaign post-mortem from an obs NDJSON "
                    "stream.")
    ap.add_argument("stream", help="NDJSON file written via --obs")
    ap.add_argument("--top", type=int, default=5,
                    help="rows in the slowest-routes / most-retried tables")
    ap.add_argument("--perfetto", metavar="OUT.json", default=None,
                    help="also write Chrome trace-event JSON for Perfetto")
    ap.add_argument("--json", action="store_true",
                    help="emit the parsed stream stats as JSON instead of "
                         "text")
    args = ap.parse_args(argv)
    stream = load_stream(args.stream)
    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump(to_chrome(stream.get("trace", [])), f)
        print(f"wrote Perfetto trace: {args.perfetto} "
              f"({len(stream.get('trace', []))} trace records)",
              file=sys.stderr)
    if args.json:
        print(json.dumps({k: len(v) for k, v in stream.items()},
                         sort_keys=True))
    else:
        print(render(stream, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
