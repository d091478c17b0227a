"""The array lanes engine: N perturbed campaign worlds in lockstep.

One ``LanesEngine`` holds L independent campaign worlds as dense
``[lane, row]`` numpy arrays (rows are the transfer table's (dataset,
destination) pairs in canonical sorted order — exactly ``TransferTable.all()``
order) and advances all of them together: one lockstep outer iteration of the
engine performs, for every live lane, precisely the work one iteration of the
scalar event-driven driver (``repro_torch.scenarios.events.run_world``) performs for
one world.  Each lane advances by its OWN next-event ``dt`` on its own clock,
so lane ``l``'s iteration count, event times, and trajectory equal a solo
scalar run of the same spec/seed — the lockstep is over iteration *index*,
not simulated time.

Bit-identity by construction: every arithmetic expression in the hot path is
the SAME code the scalar engine runs —

* ``consume_stall`` / ``advance_segment`` (``core.transport``) advance the
  mover pool;
* ``fair_share_rates`` (``core.routes``) prices routes (here over
  ``[lane, route]`` arrays instead of scalars);
* ``FaultInjector.transient_marks`` (``core.faults``) is called on a real
  per-lane injector at each submission, in the exact submission order the
  scalar scheduler produces;
* ``retry_disposition`` (``core.scheduler``) maps FAILED polls to
  retry-vs-quarantine.

The scalar scheduler's lazily-validated heaps are replaced by eligibility
masks + prefix-sum first-k selection over the sorted row order — equivalent
because heap pops are validated against the live row and (with ≤ 2 replicas)
relay donors are pure functions of table state.  The engine therefore
*refuses* specs it cannot reproduce exactly (see ``lane_capable``): control
plane, demand, scrub, top-ups, or > 2 replicas fall back to scalar replays
in ``repro_torch.ensemble.engine``.

Deliberate omissions (documented, trajectory-neutral): per-day timeline
snapshots, notification message lists, and flow telemetry are not maintained
— none of them feed the trajectory, the bit-identity tuple, or the band
metrics.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultInjector
from repro_torch.core.campaign import build_catalog
from repro_torch.core.pause import DAY
from repro_torch.core.routes import fair_share_rates
from repro_torch.core.scheduler import retry_disposition
from repro_torch.core.snapshot import trajectory_summary  # noqa: F401  (format ref)
from repro_torch.core.transport import (UNREADABLE_HALT_FRACTION, advance_segment,
                                  consume_stall)
from repro_torch.scenarios.events import MAX_STEP_S, MIN_STEP_S

import hashlib

# row / transfer status codes (array-friendly mirror of transfer_table.Status)
NULL, QUEUED, ACTIVE, PAUSED, SUCCEEDED, FAILED, QUARANTINED, PAD = range(8)
_STATUS_NAME = {NULL: "NULL", QUEUED: "QUEUED", ACTIVE: "ACTIVE",
                PAUSED: "PAUSED", SUCCEEDED: "SUCCEEDED", FAILED: "FAILED",
                QUARANTINED: "QUARANTINED", PAD: "PAD"}
_OUTSTANDING = (NULL, QUEUED, ACTIVE, PAUSED, FAILED)
_OCCUPYING = (ACTIVE, QUEUED, PAUSED)
_RETRYABLE = (NULL, FAILED)
_TERMINAL = (SUCCEEDED, FAILED)


def _status_lut(codes) -> np.ndarray:
    """[8] bool lookup table: ``lut[status]`` == ``status in codes`` — the
    hot-path replacement for ``np.isin`` over the tiny status alphabet."""
    lut = np.zeros(8, dtype=bool)
    lut[list(codes)] = True
    return lut


_OUTSTANDING_LUT = _status_lut(_OUTSTANDING)
_OCCUPYING_LUT = _status_lut(_OCCUPYING)
_RETRYABLE_LUT = _status_lut(_RETRYABLE)
_TERMINAL_LUT = _status_lut(_TERMINAL)

_BIG = np.int64(2 ** 62)


def lane_capable(spec) -> Tuple[bool, str]:
    """Can ``spec`` run on the array lanes engine bit-identically?  Returns
    ``(ok, reason)``; the reason names the first disqualifying feature.

    The limits are exactness limits, not laziness: the control plane, demand
    and scrub engines mutate scheduling state through event-driven Python
    the array engine does not model, and with > 2 replicas the scalar
    scheduler's relay-donor bucketing is historical (donor chosen at enqueue
    time), not a pure function of table state."""
    if not hasattr(spec, "replicas"):
        return False, "not a single-campaign ScenarioSpec"
    if getattr(spec, "members", None) is not None:
        return False, "federations need the shared-transport scalar path"
    if len(spec.replicas) != 2:
        return False, "relay donor bucketing is only pure for 2 replicas"
    if spec.policy.enabled:
        return False, "control plane (bundling/tuning) is event-driven"
    if spec.demand.enabled:
        return False, "demand engine is event-driven"
    if spec.scrub.enabled:
        return False, "scrub engine is event-driven"
    if spec.obs.enabled:
        return False, "flight recorder traces scalar row transitions"
    if spec.top_ups:
        return False, "incremental top-ups mutate the catalog mid-run"
    return True, ""


# A segment-step backend: (t, bytes_done, rate, bound) -> (t_left, new_bytes,
# adv, moved, hit) over [lane, row] float64 host arrays.  numpy default is the
# bit-exact reference; repro_torch.ensemble.batch provides the torch backend
# (the CUDA lane-step kernel on a card, the plain PyTorch version on the
# CPU), bit-equal to it.
SegmentFn = Callable[[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
                     Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray]]


def numpy_segment(t, bytes_done, rate, bound):
    return advance_segment(t, bytes_done, rate, bound)


@dataclass
class LaneResult:
    """One lane's outcome in the scalar report vocabulary."""
    seed: int
    label: Dict[str, object]
    iterations: int
    sim_days: float
    faults_total: int
    quarantined: int
    bytes_at: Dict[str, int]
    succeeded_digest: str
    timed_out: bool

    def trajectory(self) -> dict:
        """The bit-identity tuple, field-for-field the dict
        ``repro_torch.core.snapshot.trajectory_summary`` produces."""
        return {"iterations": self.iterations, "sim_days": self.sim_days,
                "faults_total": self.faults_total,
                "quarantined": self.quarantined,
                "bytes_at": dict(self.bytes_at),
                "succeeded_digest": self.succeeded_digest}


class LanesEngine:
    """Build L worlds from ``(spec, seed)`` pairs and run them in lockstep.

    ``lane_specs`` is a sequence of ``(ScenarioSpec, seed, label)`` tuples;
    every spec must share the base spec's topology (site names, route pairs,
    source, replicas) — perturbation axes change *numbers*, never shape.
    """

    def __init__(self, lane_specs: Sequence[Tuple[object, int, dict]],
                 scale: float = 1.0, n_datasets: Optional[int] = None,
                 segment_fn: SegmentFn = numpy_segment):
        if not lane_specs:
            raise ValueError("no lanes")
        for spec, _, _ in lane_specs:
            ok, why = lane_capable(spec)
            if not ok:
                raise ValueError(f"spec {spec.name!r} not lane-capable: {why}")
        self.segment_fn = segment_fn
        self.lane_specs = list(lane_specs)
        base = lane_specs[0][0]
        self.site_names = [s.name for s in base.sites]
        self.site_id = {n: i for i, n in enumerate(self.site_names)}
        self.route_pairs = [(r.source, r.destination) for r in base.routes]
        self.source_name = base.source
        self.replicas = tuple(base.replicas)          # policy priority order
        self.dst_names = sorted(self.replicas)        # row (table) order
        for spec, _, _ in lane_specs:
            if ([s.name for s in spec.sites] != self.site_names
                    or [(r.source, r.destination) for r in spec.routes]
                    != self.route_pairs
                    or spec.source != self.source_name
                    or tuple(spec.replicas) != self.replicas):
                raise ValueError("lane specs must share the base topology")
        self._build(scale, n_datasets)

    # ------------------------------------------------------------------ build
    def _build(self, scale: float, n_datasets: Optional[int]) -> None:
        L = len(self.lane_specs)
        nS, nRt = len(self.site_names), len(self.route_pairs)
        src_id = self.site_id[self.source_name]
        n_rep = 2

        # per-lane worlds: catalogs (jagged), graph numbers, calendars
        self.injectors: List[FaultInjector] = []
        self.row_paths: List[List[str]] = []          # [L][R_l]
        self.ds_paths: List[List[str]] = []           # [L][D_l]
        lane_rows: List[list] = []
        self.seeds = np.empty(L, dtype=np.int64)
        self.max_retries = np.empty(L, dtype=np.int64)
        self.backoff_s = np.empty(L)
        self.fault_cost = np.empty(L)
        self.human_fix_s = np.empty(L)
        self.task_setup = np.empty(L)
        self.deadline = np.empty(L)
        self.max_active = np.empty(L, dtype=np.int64)
        self.route_bw = np.empty((L, nRt))
        self.read_bw = np.empty((L, nS))
        self.write_bw = np.empty((L, nS))
        self.knee = np.full((L, nS), np.inf)
        self.scan_rate_site = np.empty((L, nS))
        self.scan_limit = np.empty((L, nS), dtype=np.int64)
        win_s: List[List[List[float]]] = []           # [L][site][window]
        win_e: List[List[List[float]]] = []

        # seed sweeps reuse ONE spec across every lane: build its graph and
        # maintenance calendar once, not per lane (pure functions of the spec)
        graph_cache: Dict[int, object] = {}
        wins_cache: Dict[int, Tuple[list, list]] = {}

        for l, (spec, seed, _) in enumerate(self.lane_specs):
            self.seeds[l] = seed
            f = spec.faults
            self.injectors.append(FaultInjector(
                seed, transient_per_tb=f.transient_per_tb,
                fragility_tail=f.fragility_tail))
            self.max_retries[l] = f.max_retries
            self.backoff_s[l] = f.backoff_s
            self.fault_cost[l] = f.fault_retry_cost_s
            self.human_fix_s[l] = spec.human_fix_days * DAY
            self.task_setup[l] = float(spec.task_setup_s)
            self.deadline[l] = spec.max_days * DAY
            self.max_active[l] = spec.max_active_per_route
            graph = graph_cache.get(id(spec))
            if graph is None:
                graph = graph_cache[id(spec)] = spec.build_graph()
            for j, name in enumerate(self.site_names):
                s = graph.sites[name]
                self.read_bw[l, j] = s.read_bw
                self.write_bw[l, j] = s.write_bw
                if s.concurrency_knee is not None:
                    self.knee[l, j] = s.concurrency_knee
                self.scan_rate_site[l, j] = s.scan_files_per_s
                self.scan_limit[l, j] = s.scan_mem_limit_files
            for j, pair in enumerate(self.route_pairs):
                self.route_bw[l, j] = graph.routes[pair].bandwidth
            cfg = spec.to_campaign_config(scale=scale, seed=seed,
                                          n_datasets=n_datasets)
            catalog = build_catalog(cfg, graph)
            paths = sorted(catalog)
            self.ds_paths.append(paths)
            rows = [(p, d) for p in paths for d in self.dst_names]
            lane_rows.append([(p, d, catalog[p]) for p, d in rows])
            self.row_paths.append([p for p, _ in rows])
            wins = wins_cache.get(id(spec))
            if wins is None:
                pause = spec.build_pause()
                wins = wins_cache[id(spec)] = (
                    [[w.start for w in pause.windows(n)]
                     for n in self.site_names],
                    [[w.end for w in pause.windows(n)]
                     for n in self.site_names])
            win_s.append(wins[0])
            win_e.append(wins[1])

        self.L = L
        self.n_rep = n_rep
        self.R = R = max(len(rows) for rows in lane_rows)
        self.D = D = R // n_rep
        self.src_site = src_id
        # route id lookup: (src site, dst site) -> route index, -1 if absent
        self.route_id = np.full((nS, nS), -1, dtype=np.int64)
        for j, (a, b) in enumerate(self.route_pairs):
            self.route_id[self.site_id[a], self.site_id[b]] = j
        self.route_src = np.array([self.site_id[a]
                                   for a, _ in self.route_pairs])
        self.route_dst = np.array([self.site_id[b]
                                   for _, b in self.route_pairs])
        # [route, site] 0/1 indicators: a route's mover count contributes to
        # exactly its endpoint sites' loads, so per-site loads are an exact
        # integer matmul away from per-route counts
        self.src_ind = np.zeros((nRt, nS), dtype=np.int64)
        self.dst_ind = np.zeros((nRt, nS), dtype=np.int64)
        self.src_ind[np.arange(nRt), self.route_src] = 1
        self.dst_ind[np.arange(nRt), self.route_dst] = 1

        # static per-row arrays (PAD-padded to the widest lane)
        self.pad = np.ones((L, R), dtype=bool)
        self.nbytes = np.zeros((L, R), dtype=np.int64)
        self.files = np.zeros((L, R), dtype=np.int64)
        self.unreadable = np.zeros((L, R), dtype=bool)
        self.dst_id = np.zeros((L, R), dtype=np.int64)
        self.ds_idx = np.zeros((L, R), dtype=np.int64)
        for l, rows in enumerate(lane_rows):
            for r, (p, dname, ds) in enumerate(rows):
                self.pad[l, r] = False
                self.nbytes[l, r] = ds.bytes
                self.files[l, r] = ds.files
                self.unreadable[l, r] = ds.unreadable
                self.dst_id[l, r] = self.site_id[dname]
                self.ds_idx[l, r] = r // n_rep
        self.nbytes_f = self.nbytes.astype(np.float64)
        # sibling row (the dataset's other replica row): 2 replicas -> r ^ 1
        self.sib_idx = np.arange(R) ^ 1
        # pause calendars, padded with inf (a window at inf never matches)
        W = max((len(w) for lw in win_s for w in lw), default=0) or 1
        self.win_start = np.full((L, nS, W), np.inf)
        self.win_end = np.full((L, nS, W), np.inf)
        for l in range(L):
            for j in range(nS):
                ws, we = win_s[l][j], win_e[l][j]
                self.win_start[l, j, :len(ws)] = ws
                self.win_end[l, j, :len(we)] = we
        self.bounds = np.sort(
            np.concatenate([self.win_start, self.win_end], axis=2)
            .reshape(L, -1), axis=1)

        # ---- dynamic state -------------------------------------------------
        # table level
        self.rstatus = np.where(self.pad, PAD, NULL).astype(np.int8)
        self.rsource = np.full((L, R), src_id, dtype=np.int64)
        self.retries = np.zeros((L, R), dtype=np.int64)
        self.rfaults = np.zeros((L, R), dtype=np.int64)
        self.rbytes = np.zeros((L, R), dtype=np.int64)
        self.rrate = np.zeros((L, R))
        self.backoff_until = np.zeros((L, R))
        # transport level (the row's current transfer)
        self.live = np.zeros((L, R), dtype=bool)
        self.phase_move = np.zeros((L, R), dtype=bool)
        self.setup = np.zeros((L, R))
        self.scanleft = np.zeros((L, R))
        self.xbytes = np.zeros((L, R))
        self.actives = np.zeros((L, R))
        self.xfaults = np.zeros((L, R), dtype=np.int64)
        self.stall = np.zeros((L, R))
        self.xstatus = np.full((L, R), ACTIVE, dtype=np.int8)
        self.live_seq = np.full((L, R), _BIG, dtype=np.int64)
        self.marks: List[List[List[float]]] = [
            [[] for _ in range(R)] for _ in range(L)]
        self.marks_head = np.full((L, R), np.inf)
        self.marks_len = np.zeros((L, R), dtype=np.int64)
        # human-fix state per (lane, dataset)
        self.notified = np.zeros((L, D), dtype=bool)
        self.fixedd = np.zeros((L, D), dtype=bool)
        self.fix_at = np.full((L, D), np.nan)
        # loop state
        self.now = np.zeros(L)
        self.last_tick = np.zeros(L)
        self.iterations = np.zeros(L, dtype=np.int64)
        self.alive = np.ones(L, dtype=bool)
        self.finished_at = np.full(L, np.nan)
        self.timed_out = np.zeros(L, dtype=bool)
        self._seq = np.zeros(L, dtype=np.int64)
        self._lanes = np.arange(L)
        # per-row route id, maintained incrementally on submit (rsource only
        # changes there); rows never submitted keep the source route
        self.rid_rows = self.route_id[self.rsource, self.dst_id]
        # event-gate flags: each guards work that is provably a no-op until
        # the corresponding state first appears
        self._any_backoff = False             # no FAILED poll outcome yet
        self._has_notices = False             # no human-fix notification yet
        self._no_unread = not bool(self.unreadable.any())
        self._halt_inf = np.full((L, self.R), np.inf)
        # pause state is a pure function of (now, static windows): refresh
        # whenever the clocks move instead of recomputing per consumer
        self.next_change = None
        self._refresh_pause()

    def _refresh_pause(self) -> None:
        # pause state is constant until some lane's clock reaches its
        # next window boundary (next_change is the EARLIEST bound strictly
        # ahead, so no boundary can fall inside the skipped interval)
        if (self.next_change is not None
                and bool((self.now < self.next_change).all())):
            return
        self.paused_site = self._paused_sites(self.now)
        self.next_change = self._next_pause_change(self.now)

    # ------------------------------------------------------------ small tools
    def _paused_sites(self, now: np.ndarray) -> np.ndarray:
        """[L, site] bool: is each site inside a maintenance window at each
        lane's own clock?  (``start <= now < end``, any window.)"""
        t = now[:, None, None]
        return np.any((self.win_start <= t) & (t < self.win_end), axis=2)

    def _next_pause_change(self, now: np.ndarray) -> np.ndarray:
        """[L]: earliest window boundary strictly after each lane's clock
        (``PauseManager.next_change`` semantics); inf when none remain."""
        later = np.where(self.bounds > now[:, None], self.bounds, np.inf)
        return later.min(axis=1)

    def _paused_rows(self, paused_site: np.ndarray) -> np.ndarray:
        lane = self._lanes[:, None]
        return (paused_site[lane, self.rsource]
                | paused_site[lane, self.dst_id])

    def _notify(self, l: int, r: int) -> None:
        """``Notifier.notify(msg, dataset)``: registers the dataset as
        needing a human fix unless it is already known (fixed or pending)."""
        d = self.ds_idx[l, r]
        if not self.notified[l, d]:
            self.notified[l, d] = True
            self.fixedd[l, d] = False
            self._has_notices = True

    def _halt_bytes(self) -> np.ndarray:
        """[L, R]: the permission-halt byte position, inf when the row is
        readable or its dataset has been fixed."""
        if self._no_unread:
            return self._halt_inf                # shared, read-only
        lane = self._lanes[:, None]
        active = self.unreadable & ~self.fixedd[lane, self.ds_idx]
        return np.where(active, UNREADABLE_HALT_FRACTION * self.nbytes_f,
                        np.inf)

    def _counts_by(self, mask: np.ndarray, idx: np.ndarray,
                   n: int) -> np.ndarray:
        """[L, n] int: per-lane counts of ``mask`` rows bucketed by ``idx``
        (values ≥ n or masked-out rows are dropped)."""
        safe = np.where(mask, idx, n)
        flat = (self._lanes[:, None] * (n + 1) + safe).ravel()
        return (np.bincount(flat, minlength=self.L * (n + 1))
                .reshape(self.L, n + 1)[:, :n])

    def _route_rates(self, movers: np.ndarray) -> np.ndarray:
        """[L, route] float: the tick's fair-share rate per route, the exact
        arithmetic of ``RouteGraph.effective_rate`` via the shared
        ``fair_share_rates``.  Only routes with movers are ever read."""
        nRt = len(self.route_pairs)
        n_route = self._counts_by(movers, self.rid_rows, nRt)
        # site loads: total movers touching each site (readers: none —
        # lane-capable specs have no demand engine); every mover sits on
        # exactly one route, so site loads are the route counts summed per
        # endpoint — an exact integer matmul
        src_load = n_route @ self.src_ind
        dst_load = n_route @ self.dst_ind
        rs, rd = self.route_src, self.route_dst
        return fair_share_rates(
            self.route_bw, self.read_bw[:, rs], self.write_bw[:, rd],
            n_route, src_load[:, rs], dst_load[:, rd],
            self.knee[:, rs], self.knee[:, rd])

    # ---------------------------------------------------------------- submit
    def _submit(self, l: int, r: int, src: int) -> None:
        """``transport.submit`` + table start for one row: the ONLY place the
        lane's fault stream is consumed, in scalar submission order."""
        self.rsource[l, r] = src
        self.rid_rows[l, r] = self.route_id[src, self.dst_id[l, r]]
        self.rstatus[l, r] = ACTIVE
        self.live[l, r] = True
        self.phase_move[l, r] = False
        self.setup[l, r] = self.task_setup[l]
        self.scanleft[l, r] = float(self.files[l, r])
        self.xbytes[l, r] = 0.0
        self.actives[l, r] = 0.0
        self.xfaults[l, r] = 0
        self.stall[l, r] = 0.0
        self.xstatus[l, r] = ACTIVE
        self.live_seq[l, r] = self._seq[l]
        self._seq[l] += 1
        m = self.injectors[l].transient_marks(self.row_paths[l][r],
                                              int(self.nbytes[l, r]))
        self.marks[l][r] = m
        self.marks_head[l, r] = m[0] if m else np.inf
        self.marks_len[l, r] = len(m)

    # ------------------------------------------------------------- scheduler
    def _poll(self, act: np.ndarray) -> None:
        """Scheduler poll pass: map transfer outcomes onto table rows with
        the shared ``retry_disposition`` rule."""
        polled = act[:, None] & _OCCUPYING_LUT[self.rstatus]
        if not polled.any():
            return
        succ = polled & (self.xstatus == SUCCEEDED)
        fail = polled & (self.xstatus == FAILED)
        if succ.any():
            self.rstatus[succ] = SUCCEEDED
            self._record_outcome(succ)
        if fail.any():
            nret, quar = retry_disposition(self.retries,
                                           self.max_retries[:, None])
            quar &= fail
            soft = fail & ~quar
            self.retries[fail] = nret[fail]
            self._record_outcome(fail)
            if quar.any():
                self.rstatus[quar] = QUARANTINED
                for l, r in zip(*np.nonzero(quar)):
                    self._notify(l, r)
            if soft.any():
                self.rstatus[soft] = FAILED
                until = self.now[:, None] + self.backoff_s[:, None]
                self.backoff_until[soft] = np.broadcast_to(
                    until, soft.shape)[soft]
                self._any_backoff = True
        rest = polled & ~succ & ~fail
        if rest.any():
            self.rstatus[rest] = self.xstatus[rest]

    def _record_outcome(self, mask: np.ndarray) -> None:
        """The poll's row update: final byte count, achieved rate over active
        time (``_state_of`` semantics), and the transfer's fault count."""
        self.rbytes[mask] = self.xbytes[mask].astype(np.int64)
        self.rrate[mask] = (self.xbytes[mask]
                            / np.maximum(1e-9, self.actives[mask]))
        self.rfaults[mask] = self.xfaults[mask]

    def _start_batch(self, act: np.ndarray, elig: np.ndarray,
                     slots: np.ndarray, src: int) -> np.ndarray:
        """Start the first-k eligible rows per lane (row order == dataset
        order, the heap's pop order) and return the per-lane count started.
        Field updates are bulk masked stores; only the fault draws walk rows
        one by one (per-lane RNG streams consumed in submission order, the
        bit-identity invariant)."""
        elig = elig & act[:, None]
        if not elig.any():
            return np.zeros(self.L, dtype=np.int64)
        ranks = np.cumsum(elig, axis=1)
        sel = elig & (ranks <= slots[:, None])
        n = sel.sum(axis=1)
        if not n.any():
            return n
        np.copyto(self.rsource, src, where=sel)
        self.rid_rows[sel] = self.route_id[src, self.dst_id[sel]]
        np.copyto(self.rstatus, ACTIVE, where=sel)
        self.live |= sel
        np.copyto(self.phase_move, False, where=sel)
        np.copyto(self.setup, self.task_setup[:, None], where=sel)
        np.copyto(self.scanleft, self.files, where=sel, casting="unsafe")
        np.copyto(self.xbytes, 0.0, where=sel)
        np.copyto(self.actives, 0.0, where=sel)
        np.copyto(self.xfaults, 0, where=sel)
        np.copyto(self.stall, 0.0, where=sel)
        np.copyto(self.xstatus, ACTIVE, where=sel)
        np.copyto(self.live_seq, self._seq[:, None] + ranks - 1, where=sel)
        self._seq += n
        for l, r in zip(*np.nonzero(sel)):
            l, r = int(l), int(r)
            m = self.injectors[l].transient_marks(self.row_paths[l][r],
                                                  int(self.nbytes[l, r]))
            self.marks[l][r] = m
            self.marks_head[l, r] = m[0] if m else np.inf
            self.marks_len[l, r] = len(m)
        return n

    def _retryable_mask(self) -> np.ndarray:
        return _RETRYABLE_LUT[self.rstatus]

    def _readmit(self, act: np.ndarray, dst: int, src_for_start: int,
                 slots_left: np.ndarray, fresh_slots: bool) -> None:
        """Re-admit fixed quarantined rows at ``dst`` (Figure 4 ordering:
        strictly after the pass's ordinary eligibles).  ``fresh_slots``
        mirrors the scalar code: the direct pass decrements a local slot
        counter, the relay pass re-counts occupancy per row."""
        lane = self._lanes[:, None]
        quar = (act[:, None] & (self.rstatus == QUARANTINED)
                & (self.dst_id == dst) & self.fixedd[lane, self.ds_idx])
        if not quar.any():
            return
        self.rstatus[quar] = FAILED
        self.retries[quar] = 0
        for l, r in zip(*np.nonzero(quar)):
            l, r = int(l), int(r)
            if fresh_slots:
                # relay readmission: donor must hold the dataset, and slots
                # are re-counted against the current table
                if self.rstatus[l, self.sib_idx[r]] != SUCCEEDED:
                    continue
                donor = int(self.dst_id[l, self.sib_idx[r]])
                occ = int(np.count_nonzero(
                    _OCCUPYING_LUT[self.rstatus[l]]
                    & (self.rsource[l] == donor) & (self.dst_id[l] == dst)))
                if (self.max_active[l] - occ > 0
                        and not self.backoff_until[l, r] > self.now[l]):
                    self._submit(l, r, donor)
            else:
                if (slots_left[l] > 0
                        and self.rsource[l, r] == src_for_start
                        and not self.backoff_until[l, r] > self.now[l]):
                    self._submit(l, r, src_for_start)
                    slots_left[l] -= 1

    def _sched_step(self, act: np.ndarray) -> None:
        """One Figure-4 pass for every live lane: poll, direct starts
        (primary, then secondaries while the primary has paused rows),
        relays, quarantine re-admissions — in scalar submission order."""
        self._poll(act)
        src = self.src_site
        primary = self.site_id[self.replicas[0]]
        # backoff only changes in the poll above, so one mask serves every
        # pass of this step; readmission needs a fixed quarantined row
        # somewhere, which almost no iteration has
        not_backing = (~(self.backoff_until > self.now[:, None])
                       if self._any_backoff else True)
        fixable = bool((self.rstatus == QUARANTINED).any()
                       and self.fixedd.any())
        # every pass below queries a distinct route, and no submission in an
        # earlier pass lands on a later pass's route — one occupancy count
        # taken here serves them all
        occ_rt = self._counts_by(act[:, None] & _OCCUPYING_LUT[self.rstatus],
                                 self.rid_rows, len(self.route_pairs))

        def slots_for(s: int, d: int) -> np.ndarray:
            return np.maximum(0, self.max_active
                              - occ_rt[:, int(self.route_id[s, d])])
        # 2a: source -> primary.  Re-admissions only happen in a pass that
        # had a slot to begin with (the scalar _start_route returns before
        # its readmit scan when slots <= 0).
        elig = (self._retryable_mask() & (self.rsource == src)
                & (self.dst_id == primary) & not_backing & ~self.pad)
        slots = slots_for(src, primary)
        started = self._start_batch(act, elig, slots, src)
        if fixable:
            self._readmit(act & (slots > 0), primary, src, slots - started,
                          fresh_slots=False)
        # 2c: secondaries while any primary-bound row is paused
        any_paused = (act[:, None] & (self.rstatus == PAUSED)
                      & (self.dst_id == primary)).any(axis=1)
        if any_paused.any():
            for name in self.replicas[1:]:
                sec = self.site_id[name]
                elig = (self._retryable_mask() & (self.rsource == src)
                        & (self.dst_id == sec) & not_backing & ~self.pad)
                slots = slots_for(src, sec)
                started = self._start_batch(any_paused, elig, slots, src)
                if fixable:
                    self._readmit(any_paused & (slots > 0), sec, src,
                                  slots - started, fresh_slots=False)
        # 2d/2e: relays, destination priority order; donor = the sibling
        # replica (unique with 2 replicas).  The scalar relay pass always
        # reaches its readmit scan, so no slot gate here.
        lane = self._lanes[:, None]
        # sibling successes can only appear in the poll, so one mask serves
        # both relay passes
        sib_ok = self.rstatus[lane, self.sib_idx] == SUCCEEDED
        for name in self.replicas:
            dst = self.site_id[name]
            elig = (self._retryable_mask() & (self.dst_id == dst) & sib_ok
                    & not_backing & ~self.pad)
            # all relay rows to dst share one donor site (the other replica)
            donor = int(self.site_id[self.replicas[0]
                                     if name != self.replicas[0]
                                     else self.replicas[1]])
            slots = slots_for(donor, dst)
            self._start_batch(act, elig, slots, donor)
            if fixable:
                self._readmit(act, dst, donor, None, fresh_slots=True)

    # ------------------------------------------------------------ human fixes
    def _apply_human_fixes(self, act: np.ndarray) -> None:
        if not self._has_notices:
            return
        a = act[:, None]
        sched = a & self.notified & ~self.fixedd & np.isnan(self.fix_at)
        if sched.any():
            due = self.now[:, None] + self.human_fix_s[:, None]
            self.fix_at[sched] = np.broadcast_to(due, sched.shape)[sched]
        fix = (a & ~np.isnan(self.fix_at)
               & (self.now[:, None] >= self.fix_at) & ~self.fixedd)
        self.fixedd[fix] = True

    # ------------------------------------------------------------- next event
    def _next_event_dt(self, act: np.ndarray) -> np.ndarray:
        # min over positive candidates; absent state (no backoffs, no fix
        # schedule) contributes inf, so its candidate is skipped outright
        inf = np.inf
        hint = self._transport_hint()
        dt = np.where(hint > 0, hint, inf)
        nc = self.next_change - self.now
        dt = np.minimum(dt, np.where(nc > 0, nc, inf))
        if self._any_backoff:
            nb = (np.where(self.backoff_until > self.now[:, None],
                           self.backoff_until, inf).min(axis=1) - self.now)
            dt = np.minimum(dt, np.where(nb > 0, nb, inf))
        if self._has_notices:
            fx = (np.where(np.isnan(self.fix_at)
                           | (self.fix_at <= self.now[:, None]),
                           inf, self.fix_at).min(axis=1) - self.now)
            dt = np.minimum(dt, np.where(fx > 0, fx, inf))
        return np.maximum(MIN_STEP_S, np.minimum(dt, MAX_STEP_S))

    def _transport_hint(self) -> np.ndarray:
        """Vectorized ``SimulatedTransport.next_event_hint`` — including its
        two early returns: a pending scan OOM pins the hint to 1.0, and the
        FIRST at-halt mover (submission order) pins it to
        ``max(stall_left, 1.0)``, discarding every other candidate."""
        L = self.L
        lane = self._lanes[:, None]
        row_np = self.live & ~self._paused_rows(self.paused_site)
        scanners = row_np & ~self.phase_move
        movers = row_np & self.phase_move
        best = np.full(L, np.inf)
        # scanners
        if scanners.any():
            n_scan = self._counts_by(scanners, self.rsource,
                                     len(self.site_names))
            srate = self.scan_rate_site / np.maximum(1, n_scan)
            rate_row = srate[lane, self.rsource]
            cand = np.where(scanners & (rate_row > 0),
                            self.setup + np.maximum(0.0,
                                                    self.scanleft / rate_row),
                            np.inf)
            best = cand.min(axis=1)
            oom = (scanners
                   & (self.files > self.scan_limit[lane, self.rsource]))
            oom_lane = oom.any(axis=1)
        else:
            oom_lane = np.zeros(L, dtype=bool)
        # movers
        halt = self._halt_bytes()
        if movers.any():
            rr = self._route_rates(movers)
            rid = self.rid_rows
            rate_row = np.where(movers & (rid >= 0),
                                rr[lane, np.clip(rid, 0, None)], 0.0)
            mv = movers & (rate_row > 0)
            halt_active = np.isfinite(halt)
            target = np.where(halt_active, halt, self.nbytes_f)
            at_halt = mv & (target <= self.xbytes)
            # pending stall: every fault mark before the target costs one
            # retry stall (marks are all < bytes; only an active halt needs
            # a per-row prefix count)
            n_below = self.marks_len.astype(np.float64)
            special = mv & halt_active & ~at_halt & (self.marks_len > 0)
            for l, r in zip(*np.nonzero(special)):
                n_below[l, r] = bisect.bisect_left(self.marks[int(l)][int(r)],
                                                   target[l, r])
            cand = np.where(mv & ~at_halt,
                            self.stall + self.fault_cost[:, None] * n_below
                            + (target - self.xbytes) / rate_row, np.inf)
            best = np.minimum(best, cand.min(axis=1))
            halt_lane = at_halt.any(axis=1)
            if halt_lane.any():
                seqs = np.where(at_halt, self.live_seq, _BIG)
                first = seqs.argmin(axis=1)
                halt_hint = np.maximum(self.stall[self._lanes, first], 1.0)
                best = np.where(halt_lane, halt_hint, best)
        best = np.where(oom_lane, 1.0, best)
        return best

    # ------------------------------------------------------------------ tick
    def _tick(self, act: np.ndarray) -> None:
        dt = self.now - self.last_tick
        self.last_tick = self.now.copy()
        act = act & (dt > 0)
        if not act.any():
            return
        lane = self._lanes[:, None]
        live = self.live & act[:, None]
        paused_row = self._paused_rows(self.paused_site)
        self.xstatus[live & paused_row] = PAUSED
        running = live & ~paused_row
        self.xstatus[running] = ACTIVE
        scanners = running & ~self.phase_move
        movers = running & self.phase_move        # pre-scan classification
        # --- metadata scans ------------------------------------------------
        if scanners.any():
            n_scan = self._counts_by(scanners, self.rsource,
                                     len(self.site_names))
            srate = self.scan_rate_site / np.maximum(1, n_scan)
            rate_row = srate[lane, self.rsource]
            oom = (scanners
                   & (self.files > self.scan_limit[lane, self.rsource]))
            if oom.any():
                self.xstatus[oom] = FAILED
                self.xfaults[oom] += 1
                for l, r in zip(*np.nonzero(oom)):
                    self._notify(int(l), int(r))
            ok = scanners & ~oom
            dtc = np.broadcast_to(dt[:, None], ok.shape)
            used = np.minimum(self.setup, dtc)
            avail = dtc - used
            np.subtract(self.setup, used, out=self.setup, where=ok)
            adv = ok & (avail > 0)
            np.subtract(self.scanleft, rate_row * avail,
                        out=self.scanleft, where=adv)
            self.phase_move |= adv & (self.scanleft <= 0)
        # --- data movement -------------------------------------------------
        if movers.any():
            rr = self._route_rates(movers)
            rid = self.rid_rows
            rate_row = np.where(movers & (rid >= 0),
                                rr[lane, np.clip(rid, 0, None)], 0.0)
            halt = self._halt_bytes()
            bound = np.minimum(self.nbytes_f, halt)
            bound = np.where(self.marks_head < bound, self.marks_head, bound)
            rem, new_stall = consume_stall(dt[:, None], self.stall)
            _, new_bd, adv, _moved, hit = self.segment_fn(
                rem, self.xbytes, rate_row, bound)
            fast = movers & ((rem <= 1e-9)
                             | ((rate_row > 0) & (self.xbytes < halt) & ~hit))
            # bulk completion: a boundary hit whose bound is the row's full
            # byte count with no pending mark is the walk's one-iteration
            # SUCCEEDED exit — same expressions, no per-row python
            done = (movers & ~fast & hit & (rem > 1e-9)
                    & (bound == self.nbytes_f) & (self.xbytes < halt))
            # bulk fault absorption: a hit on a mark boundary whose retry
            # stall swallows the rest of the tick is the walk's
            # pop-mark/add-stall/consume-stall exit — closed form, same ops
            t_left = rem - adv
            cost = self.fault_cost[:, None]
            mark1 = (movers & ~fast & ~done & hit & (rem > 1e-9)
                     & (self.marks_head == bound) & (self.xbytes < halt)
                     & (self.marks_head < np.minimum(self.nbytes_f, halt))
                     & ((t_left <= 1e-9) | (cost >= t_left)))
            slow = movers & ~fast & ~done & ~mark1
            fast |= done
            np.copyto(self.stall, new_stall, where=fast)
            upd = (fast & (rem > 1e-9)) | mark1
            np.copyto(self.xbytes, new_bd, where=upd)
            np.add(self.actives, adv, out=self.actives, where=upd)
            self.xstatus[done] = SUCCEEDED
            if mark1.any():
                np.add(self.xfaults, 1, out=self.xfaults, where=mark1)
                np.copyto(self.stall,
                          np.where(t_left <= 1e-9, cost, cost - t_left),
                          where=mark1)
                for l, r in zip(*np.nonzero(mark1)):
                    m = self.marks[int(l)][int(r)]
                    m.pop(0)
                    self.marks_head[l, r] = m[0] if m else np.inf
                    self.marks_len[l, r] -= 1
            for l, r in zip(*np.nonzero(slow)):
                self._walk(int(l), int(r), float(dt[l]),
                           float(rate_row[l, r]))
        # --- evict terminal transfers ---------------------------------------
        self.live &= ~_TERMINAL_LUT[self.xstatus]

    def _walk(self, l: int, r: int, dt: float, rate: float) -> None:
        """Per-row mirror of ``SimulatedTransport._advance_mover`` — the
        segment-exact walk for movers that cross a byte boundary this tick.
        Same statements, same order, python-float arithmetic."""
        marks = self.marks[l][r]
        halt: Optional[float] = None
        d = self.ds_idx[l, r]
        if self.unreadable[l, r] and not self.fixedd[l, d]:
            halt = UNREADABLE_HALT_FRACTION * int(self.nbytes[l, r])
        nbytes = int(self.nbytes[l, r])
        bytes_done = float(self.xbytes[l, r])
        active_s = float(self.actives[l, r])
        stall = float(self.stall[l, r])
        faults = int(self.xfaults[l, r])
        cost = float(self.fault_cost[l])
        t = dt
        while t > 1e-9:
            if stall > 0:
                used = min(stall, t)
                stall -= used
                t -= used
                continue
            if halt is not None and bytes_done >= halt:
                bytes_done = halt
                self.xstatus[l, r] = FAILED
                faults += 1
                self._notify(l, r)
                break
            if rate <= 0:
                break
            nxt = float(nbytes)
            if halt is not None:
                nxt = min(nxt, halt)
            if marks and marks[0] < nxt:
                nxt = marks[0]
            need = max(0.0, nxt - bytes_done) / rate
            if need > t:
                bytes_done += rate * t
                active_s += t
                t = 0.0
                break
            bytes_done = nxt
            active_s += need
            t -= need
            if marks and marks[0] <= nxt:
                marks.pop(0)
                faults += 1
                stall += cost
                continue
            if halt is not None and nxt >= halt:
                continue
            if nxt >= nbytes:
                bytes_done = float(nbytes)
                self.xstatus[l, r] = SUCCEEDED
                break
        self.xbytes[l, r] = bytes_done
        self.actives[l, r] = active_s
        self.stall[l, r] = stall
        self.xfaults[l, r] = faults
        self.marks_head[l, r] = marks[0] if marks else np.inf
        self.marks_len[l, r] = len(marks)

    # ------------------------------------------------------------------- run
    def _table_done(self, act: np.ndarray) -> np.ndarray:
        outstanding = (_OUTSTANDING_LUT[self.rstatus]
                       & ~self.pad).any(axis=1)
        return act & ~outstanding

    def _finish(self, mask: np.ndarray, timed_out: bool) -> None:
        if not mask.any():
            return
        self.finished_at[mask] = self.now[mask]
        self.timed_out[mask] |= timed_out
        self.alive &= ~mask

    def run(self, max_iterations: int = 1_000_000) -> List[LaneResult]:
        """Drive every lane to completion (events-engine semantics) and
        return per-lane results in lane order."""
        it = 0
        with np.errstate(divide="ignore", invalid="ignore"):
            while self.alive.any():
                it += 1
                if it > max_iterations:
                    raise RuntimeError("lanes engine failed to converge")
                self._finish(self.alive & (self.now >= self.deadline),
                             timed_out=True)
                act = self.alive
                if not act.any():
                    break
                self.iterations[act] += 1
                self._sched_step(act)
                self._apply_human_fixes(act)
                self._finish(self._table_done(act), timed_out=False)
                act = self.alive
                if not act.any():
                    break
                dt = self._next_event_dt(act)
                self.now = np.where(act, self.now + dt, self.now)
                self._refresh_pause()
                self._tick(act)
        return [self._result(l) for l in range(self.L)]

    # ---------------------------------------------------------------- results
    def _result(self, l: int) -> LaneResult:
        succ = (self.rstatus[l] == SUCCEEDED) & ~self.pad[l]
        faults = self.rfaults[l][succ]
        bytes_at = {}
        for name in self.replicas:
            m = succ & (self.dst_id[l] == self.site_id[name])
            bytes_at[name] = int(self.rbytes[l][m].sum())
        spec, seed, label = self.lane_specs[l]
        return LaneResult(
            seed=int(seed), label=dict(label),
            iterations=int(self.iterations[l]),
            sim_days=float(self.finished_at[l]) / DAY,
            faults_total=int(np.sum(faults)) if faults.size else 0,
            quarantined=int(np.count_nonzero(
                (self.rstatus[l] == QUARANTINED) & ~self.pad[l])),
            bytes_at=bytes_at,
            succeeded_digest=self._digest(l),
            timed_out=bool(self.timed_out[l]))

    def _digest(self, l: int) -> str:
        """``repro_torch.core.snapshot.succeeded_digest`` over the lane's rows —
        identical format, identical (dataset, destination) order."""
        h = hashlib.sha256()
        paths = self.row_paths[l]
        for r in range(len(paths)):
            if self.rstatus[l, r] != SUCCEEDED:
                continue
            h.update((f"{paths[r]}|{self.site_names[self.dst_id[l, r]]}|"
                      f"{self.site_names[self.rsource[l, r]]}|"
                      f"{int(self.rfaults[l, r])}|{int(self.retries[l, r])}|"
                      f"{int(self.rbytes[l, r])}|"
                      f"{float(self.rrate[l, r])!r}\n").encode())
        return h.hexdigest()
