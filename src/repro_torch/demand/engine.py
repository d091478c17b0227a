"""The demand engine: ESGF-as-a-service over a running campaign.

Per admission wave (``DemandSpec.wave_interval_s`` of sim time, anchored on
the first ``step`` exactly like ``ControlPlane``'s control interval):

  1. optionally drift the popularity permutation (then re-key the
     scheduler's priority heaps);
  2. sample the wave's request counts (Poisson total, multinomial Zipf
     split — O(catalog), not O(requests));
  3. serve each requested dataset: a cache hit at its serving replica costs
     only the hit overhead; a cached-out replica read streams the request
     bytes at the reader's fair-share rate and admits the dataset to the
     cache; an unmaterialized dataset is redirected to the source (a *miss*
     for the hit-rate SLO) and pays the redirect penalty on top of the
     source-side stream rate;
  4. optionally warm the caches with the hottest materialized-but-uncached
     datasets (demand-driven top-ups; evictions fall out of cache pressure);
  5. register the wave's aggregate read traffic as concurrent reader
     streams on the transport (``set_read_load``), where it contends with
     replication movers for the site read caps until the next wave.

Latency percentiles come from a fixed log-scale histogram (quarter-decade
buckets), so p50/p99 are deterministic and resume bit-identically; hit-rate
is accumulated per sim day, giving the time-to-90%-hit-rate headline metric
(``day90``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.pause import DAY
from repro_torch.core.routes import Dataset, TB
from repro_torch.demand.cache import ReadCache
from repro_torch.demand.catalog import ReplicaCatalog
from repro_torch.demand.spec import DemandSpec
from repro_torch.demand.workload import RequestWorkload

# quarter-decade latency buckets from 1 ms: deterministic percentile math
_LAT_BASE_S = 1e-3
_LAT_BUCKETS = 64


def _lat_bucket(latency_s: float) -> int:
    if latency_s <= _LAT_BASE_S:
        return 0
    return min(_LAT_BUCKETS - 1,
               int(4.0 * math.log10(latency_s / _LAT_BASE_S)))


def _bucket_latency(idx: int) -> float:
    return _LAT_BASE_S * 10.0 ** ((idx + 0.5) / 4.0)


class DemandEngine:
    def __init__(self, spec: DemandSpec, catalog: Dict[str, Dataset],
                 table, sched, transport, source: str,
                 replicas: Sequence[str], seed: int = 0,
                 label: str = "campaign"):
        spec.validate()
        self.spec = spec
        self.sched = sched
        self.transport = transport
        self.source = source
        self.replicas = tuple(replicas)
        self.label = label
        self.replica_catalog = ReplicaCatalog(table, source, replicas)
        paths = sorted(catalog)
        self.workload = RequestWorkload(spec, paths, seed=seed)
        # a read serves the requested slice, never more than the dataset
        self._req_bytes = {p: max(1, min(int(spec.request_bytes),
                                         int(catalog[p].bytes)))
                           for p in paths}
        self.caches = {r: ReadCache(r, spec.cache_bytes, spec.eviction)
                       for r in self.replicas}
        self._next_wave: Optional[float] = None
        self._last_wave: Optional[float] = None
        self.waves = 0
        self.requests_total = 0
        self.hits_total = 0
        self.cache_hits_total = 0
        self.source_reads_total = 0
        self.bytes_served = 0
        self.warmups = 0
        self._daily: Dict[int, List[int]] = {}        # day -> [requests, hits]
        self._latency_hist: Dict[int, int] = {}
        # flight-recorder seam: called after each admission wave with (t1,
        # wave stats); plain attribute, None compiles to no observation
        self.obs_hook = None
        if spec.prioritize:
            sched.set_priority(self.workload.rank_of)

    # ----------------------------------------------------------------- step
    def step(self, now: float) -> None:
        """Driver hook, called once per active iteration.  The first call
        anchors the wave boundary (ControlPlane's interval anchoring); each
        later call at or past the boundary processes one admission wave."""
        if self._next_wave is None:
            self._last_wave = now
            self._next_wave = now + self.spec.wave_interval_s
            return
        if now + 1e-9 < self._next_wave:
            return
        self._process_wave(self._last_wave, now)
        self._last_wave = now
        self._next_wave = now + self.spec.wave_interval_s

    def next_wave(self, now: float) -> float:
        """Absolute sim time of the next admission wave (event-engine
        hint); ``now`` before the first step has anchored the cadence."""
        return now if self._next_wave is None else self._next_wave

    def teardown(self) -> None:
        """The campaign is over: user traffic stops consuming the site read
        caps (federation members keep running on the shared transport)."""
        self.transport.set_read_load(self.label, {})

    # ----------------------------------------------------------------- wave
    def _process_wave(self, t0: float, t1: float) -> None:
        if self.workload.maybe_drift(t1) and self.spec.prioritize:
            self.sched.reprioritize()
        counts = self.workload.sample_wave(t0, t1)
        self.waves += 1
        day = self._daily.setdefault(int(t1 // DAY), [0, 0])
        read_bytes: Dict[str, int] = {}
        rate_memo: Dict[str, float] = {}

        def stream_rate(site: str) -> float:
            r = rate_memo.get(site)
            if r is None:
                r = rate_memo[site] = max(
                    1.0, self.transport.user_read_rate(site))
            return r

        for r in np.flatnonzero(counts):
            rank = int(r)
            c = int(counts[rank])
            path = self.workload.path_at_rank(rank)
            nbytes = self._req_bytes[path]
            site = self.replica_catalog.serving_site(path)
            if site is None:
                # not materialized anywhere: redirected to the slow source
                latency = (self.spec.miss_penalty_s
                           + nbytes / stream_rate(self.source))
                self.source_reads_total += c
                read_bytes[self.source] = (read_bytes.get(self.source, 0)
                                           + c * nbytes)
                hit = False
            else:
                cache = self.caches[site]
                if cache.touch(path, now=t1, count=c):
                    latency = self.spec.hit_overhead_s
                    self.cache_hits_total += c
                else:
                    latency = (self.spec.hit_overhead_s
                               + nbytes / stream_rate(site))
                    read_bytes[site] = read_bytes.get(site, 0) + c * nbytes
                    cache.admit(path, nbytes, rank=rank, now=t1)
                hit = True
            self.requests_total += c
            self.bytes_served += c * nbytes
            day[0] += c
            if hit:
                self.hits_total += c
                day[1] += c
            b = _lat_bucket(latency)
            self._latency_hist[b] = self._latency_hist.get(b, 0) + c

        # demand-driven cache top-ups: pre-stage the hottest materialized
        # datasets that are not cached at their serving replica yet
        warmed = 0
        if self.spec.warm_per_wave > 0:
            for rank in range(self.workload.n):
                if warmed >= self.spec.warm_per_wave:
                    break
                path = self.workload.path_at_rank(rank)
                site = self.replica_catalog.serving_site(path)
                if site is None or self.caches[site].contains(path):
                    continue
                nbytes = self._req_bytes[path]
                if self.caches[site].admit(path, nbytes, rank=rank, now=t1):
                    read_bytes[site] = read_bytes.get(site, 0) + nbytes
                    warmed += 1
            self.warmups += warmed

        # the wave's aggregate read traffic becomes concurrent reader
        # streams on each serving site until the next wave
        dt = max(1.0, t1 - t0)
        load = {}
        for site, nb in sorted(read_bytes.items()):
            streams = int(math.ceil(nb / (dt * self.spec.stream_bps)))
            if streams > 0:
                load[site] = streams
        self.transport.set_read_load(self.label, load)
        if self.obs_hook is not None:
            self.obs_hook(t1, {"wave": self.waves,
                               "requests": self.requests_total,
                               "hits": self.hits_total,
                               "cache_hits": self.cache_hits_total,
                               "source_reads": self.source_reads_total,
                               "warmed": warmed})

    # -------------------------------------------------------------- metrics
    def latency_quantile(self, q: float) -> float:
        total = sum(self._latency_hist.values())
        if total == 0:
            return 0.0
        target = q * total
        acc = 0
        for idx in sorted(self._latency_hist):
            acc += self._latency_hist[idx]
            if acc >= target:
                return round(_bucket_latency(idx), 4)
        return round(_bucket_latency(_LAT_BUCKETS - 1), 4)

    def day90(self, threshold: float = 0.9) -> Optional[int]:
        """First sim day whose daily hit-rate reaches ``threshold`` — the
        time-to-90%-hit-rate headline metric; None if never reached."""
        for d in sorted(self._daily):
            req, hits = self._daily[d]
            if req > 0 and hits / req >= threshold:
                return d
        return None

    def final_day_hit_rate(self) -> float:
        if not self._daily:
            return 0.0
        req, hits = self._daily[max(self._daily)]
        return hits / req if req else 0.0

    def summary(self) -> dict:
        req = self.requests_total
        return {
            "users": self.spec.users,
            "waves": self.waves,
            "requests": req,
            "hits": self.hits_total,
            "hit_rate": round(self.hits_total / req, 4) if req else 0.0,
            "cache_hits": self.cache_hits_total,
            "cache_hit_rate": (round(self.cache_hits_total / req, 4)
                               if req else 0.0),
            "source_reads": self.source_reads_total,
            "bytes_served_tb": round(self.bytes_served / TB, 3),
            "p50_s": self.latency_quantile(0.5),
            "p99_s": self.latency_quantile(0.99),
            "day90": self.day90(),
            "final_day_hit_rate": round(self.final_day_hit_rate(), 4),
            "drifts": self.workload.drifts,
            "warmups": self.warmups,
            "caches": {s: c.summary()
                       for s, c in sorted(self.caches.items())},
        }

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {
            "workload": self.workload.state_dict(),
            "caches": {s: c.state_dict()
                       for s, c in sorted(self.caches.items())},
            "next_wave": self._next_wave,
            "last_wave": self._last_wave,
            "waves": self.waves,
            "requests_total": self.requests_total,
            "hits_total": self.hits_total,
            "cache_hits_total": self.cache_hits_total,
            "source_reads_total": self.source_reads_total,
            "bytes_served": self.bytes_served,
            "warmups": self.warmups,
            "daily": [[d, req, hits]
                      for d, (req, hits) in sorted(self._daily.items())],
            "latency_hist": [[i, c]
                             for i, c in sorted(self._latency_hist.items())],
        }

    def load_state_dict(self, d: dict) -> None:
        if set(d["caches"]) != set(self.caches):
            raise ValueError(
                f"demand snapshot caches {sorted(d['caches'])} do not match "
                f"the scenario's replicas {sorted(self.caches)}")
        self.workload.load_state_dict(d["workload"])
        for s, st in d["caches"].items():
            self.caches[s].load_state_dict(st)
        self._next_wave = d["next_wave"]
        self._last_wave = d["last_wave"]
        self.waves = int(d["waves"])
        self.requests_total = int(d["requests_total"])
        self.hits_total = int(d["hits_total"])
        self.cache_hits_total = int(d["cache_hits_total"])
        self.source_reads_total = int(d["source_reads_total"])
        self.bytes_served = int(d["bytes_served"])
        self.warmups = int(d["warmups"])
        self._daily = {int(day): [int(req), int(hits)]
                       for day, req, hits in d["daily"]}
        self._latency_hist = {int(i): int(c) for i, c in d["latency_hist"]}
