"""Transfer transports.

``SimulatedTransport`` — event/step-driven WAN simulation with the paper's
bandwidth model: per-site read/write caps, per-route caps, fair sharing among
concurrent transfers, a metadata *scan* phase preceding data movement (Globus
scans source directories to size the transfer), transient fault stalls,
persistent permission failures, and PAUSED semantics during maintenance.

The hot path is O(live transfers), not O(everything ever submitted): terminal
transfers are evicted from the live pool into a compact archive of final
``TransferState``s the moment they finish, so ``tick()`` / ``poll()`` /
``next_event_hint()`` never touch finished work.  Within a tick the live
movers advance through a structure-of-arrays NumPy pool: fair-share rates,
stall consumption, and the advance-to-next-byte-boundary test are batched
array ops, and only movers that actually cross a boundary (fault mark, halt
point, completion) fall back to the segment-exact scalar walk — so the
vectorized trajectory is bit-identical to the scalar one.

``LocalFSTransport`` — real file movement between site directories on the
local filesystem with checksum verification and retransmission of corrupted
files; used by checkpoint replication and the end-to-end examples.  Files
stream through in fixed-size chunks with incremental checksumming — nothing
is ever ``read()`` whole into memory.  The chunks are hashed on ``device``
(default ``"cuda"``: the integrity-hash kernel).  ``SimulatedTransport`` is
host numpy, copied operation for operation from the JAX package, because
its float64 trajectory must stay bit-identical (below).

Determinism invariants (enforced by the engine-equivalence and crash-resume
tests; every engine that drives this transport relies on them):

  * **Segment-exactness** — a mover's trajectory is independent of how wall
    time is sliced into ticks.  ``_advance_mover`` processes stalls, fault
    marks, the unreadable halt point, and completion in byte order within a
    tick, so fixed-step, event-driven, and ensemble drivers produce
    bit-identical ``bytes_done``/``active_s``/fault sequences.
  * **One shared arithmetic** — the vectorized SoA fast path, the scalar
    walk, and the ensemble lanes engine compute every advance through the
    pure helpers ``consume_stall`` / ``advance_segment`` (or expressions
    proven operation-for-operation identical to them), in float64.  Any
    reformulation (e.g. a fused multiply-add) changes trajectories.
  * **RNG consumption order** — the fault stream is consumed ONLY at
    ``submit`` via ``FaultInjector.transient_marks`` (fragility memo →
    Poisson count → uniform positions), in submission order.  Scheduler
    start order therefore determines the entire fault history.
  * **Rate snapshotting** — fair-share rates (``_route_rates``) are computed
    once per tick from the mover population *before* any scan finishes or
    mover completes within that tick, and held constant across the tick.
  * **Hint/advance agreement** — ``next_event_hint`` uses the same shared
    scan rate and fair-share rates as the tick advance, so a projected
    completion time is exactly when the advance lands it.
"""
from __future__ import annotations

import abc
import os
import uuid as uuidlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.faults import (FaultInjector, FaultKind, Notifier, RetryPolicy)
from repro_torch.core.integrity import (Manifest, StreamingChecksum,
                                        stream_file_checksum)
from repro_torch.core.pause import DAY, PauseManager
from repro_torch.core.routes import Dataset, RouteGraph, fair_share_rates
from repro_torch.core.transfer_table import Status
from repro_torch.kernels.device import Device, require_device


class SimClock:
    def __init__(self, t0: float = 0.0):
        self.now = t0

    def advance(self, dt: float) -> None:
        self.now += dt


# fraction of a dataset transferred before its unreadable files are reached
UNREADABLE_HALT_FRACTION = 0.25


# ---------------------------------------------------------- pure segment math
# The two arithmetic steps of the mover segment walk, as pure float64 array
# functions.  The SoA fast path below and the ensemble lanes engine (the
# JAX package's repro.ensemble) call THESE — not re-derived formulas — so
# every driver advances movers through literally the same operations.
# Scalars broadcast.

def consume_stall(t, stall):
    """Consume pending fault-stall time first (the walk's first branch):
    ``used = min(stall, t)``; returns ``(t - used, stall - used)``."""
    used = np.minimum(stall, t)
    return t - used, stall - used


def advance_segment(t, bytes_done, rate, bound):
    """Advance toward the next byte boundary at fair-share ``rate`` for up to
    ``t`` seconds.  ``bound`` is the nearest of completion / halt point /
    first fault mark.  Returns ``(t_left, new_bytes, active_add, moved,
    hit)`` where ``hit`` marks movers that reached the boundary within
    ``t`` (``need <= t``, the walk's branch condition).  Movers with
    ``rate <= 0`` get ``need = inf`` and never hit; callers gate them."""
    inf = float("inf")
    with np.errstate(divide="ignore", invalid="ignore"):
        need = np.where(rate > 0,
                        np.maximum(0.0, bound - bytes_done) / rate, inf)
    hit = need <= t
    adv = np.where(hit, need, t)
    new_bytes = np.where(hit, bound, bytes_done + rate * t)
    moved = rate * adv
    t_left = np.where(hit, t - need, 0.0)
    return t_left, new_bytes, adv, moved, hit


def shared_scan_rate(site, scanners: int) -> float:
    """Per-transfer metadata-scan rate when ``scanners`` concurrent scans
    share one source site's scan throughput — the single definition both the
    tick advance and the next-event hint must use, so the two can never
    drift apart."""
    return site.scan_files_per_s / max(1, scanners)


@dataclass
class TransferState:
    status: Status
    bytes_done: int = 0
    files_done: int = 0
    dirs_done: int = 0
    faults: int = 0
    rate: float = 0.0
    detail: str = ""


class Transport(abc.ABC):
    @abc.abstractmethod
    def submit(self, dataset: Dataset, source: str, destination: str) -> str: ...

    @abc.abstractmethod
    def poll(self, uid: str) -> TransferState: ...

    def cancel(self, uid: str) -> None:
        """Abort an in-flight transfer, releasing whatever capacity it holds.
        Cancelling an unknown or already-terminal uid is a no-op; the final
        state of a cancelled transfer must remain pollable."""


# ================================================================= simulation
@dataclass
class _SimXfer:
    dataset: Dataset
    source: str
    destination: str
    submitted_at: float
    phase: str = "scan"              # scan -> move -> done/failed
    setup_left: float = 0.0          # fixed per-task dispatch cost (seconds)
    scan_files_left: float = 0.0
    bytes_done: float = 0.0
    active_s: float = 0.0                 # time actually moving bytes
    faults: int = 0
    fault_marks: List[float] = field(default_factory=list)  # byte positions
    stall_left: float = 0.0
    status: Status = Status.ACTIVE
    completed_at: Optional[float] = None
    detail: str = ""


class SimulatedTransport(Transport):
    def __init__(self, graph: RouteGraph, clock: SimClock,
                 pause: PauseManager, injector: FaultInjector,
                 notifier: Notifier,
                 retry: RetryPolicy = RetryPolicy(),
                 vectorized: bool = True,
                 task_setup_s: float = 0.0,
                 flow_horizon_days: Optional[float] = None):
        self.graph = graph
        self.clock = clock
        self.pause = pause
        self.injector = injector
        self.notifier = notifier
        self.retry = retry
        self.vectorized = vectorized
        # fixed dispatch cost per submitted task, paid before the metadata
        # scan (Globus task setup/queueing) — what makes one-task-per-tiny-
        # dataset workloads slow and bundling worthwhile.  0.0 = seed model.
        self.task_setup_s = task_setup_s
        self._live: Dict[str, _SimXfer] = {}
        # terminal transfers: uid -> final TransferState, evicted from the
        # live pool so per-tick cost never grows with campaign history
        self._archive: Dict[str, TransferState] = {}
        self._last_tick = clock.now
        # telemetry, bounded: per-(day, route) byte totals instead of one
        # tuple per mover per tick
        self.flow_totals: Dict[Tuple[int, Tuple[str, str]], float] = {}
        # optional retention horizon for flow_totals: buckets older than
        # this many days are pruned at day crossings, so a 29M-file
        # campaign's telemetry stays O(routes · horizon) instead of
        # O(routes · campaign days).  None = keep the whole campaign.
        self.flow_horizon_days = flow_horizon_days
        self._flow_pruned_day = -1
        # cumulative per-route counters for the control plane's tuners:
        # bytes moved and transient/persistent faults observed, O(routes)
        self._route_bytes: Dict[Tuple[str, str], float] = {}
        self._route_faults: Dict[Tuple[str, str], int] = {}
        # user read traffic: owner label -> {site: concurrent reader streams}.
        # Readers consume the site *read* caps alongside movers (the serving
        # tier reads the same archive the movers read from) but occupy no
        # route, so they slow transfers out of a hot site without inventing
        # bandwidth between sites.
        self._read_load: Dict[str, Dict[str, int]] = {}
        # fair-share memo: the last priced population (mover routes + reader
        # pseudo-routes, with counts) and its rates dict.  Valid until any
        # mover joins/leaves a route or reader load shifts — graph caps and
        # knees are build-time constants, so population equality is the whole
        # invalidation condition.  ``_pop_buf`` is the reusable scratch dict
        # the per-tick population is counted into.
        self._rates_pop: Optional[Dict[Tuple[str, str], int]] = None
        self._rates: Dict[Tuple[str, str], float] = {}
        self._pop_buf: Dict[Tuple[str, str], int] = {}
        # interned pricing arrays per distinct active-route set: the routes'
        # bandwidths / site caps / knees as preallocated float64 arrays plus
        # int64 load buffers, so a cache miss prices EVERY route in one
        # vectorized ``fair_share_rates`` call
        self._route_arrays: Dict[Tuple[Tuple[str, str], ...], tuple] = {}

    @property
    def live_count(self) -> int:
        return len(self._live)

    # ----------------------------------------------------------------- submit
    def submit(self, dataset: Dataset, source: str, destination: str) -> str:
        uid = str(uuidlib.uuid4())
        x = _SimXfer(dataset=dataset, source=source, destination=destination,
                     submitted_at=self.clock.now,
                     setup_left=float(self.task_setup_s),
                     scan_files_left=float(dataset.files))
        x.fault_marks = self.injector.transient_marks(dataset.path,
                                                      dataset.bytes)
        self._live[uid] = x
        return uid

    def poll(self, uid: str) -> TransferState:
        done = self._archive.get(uid)
        if done is not None:
            return done
        return self._state_of(self._live[uid])

    def cancel(self, uid: str) -> None:
        """Evict a live transfer to the archive as FAILED/"cancelled".  The
        mover immediately stops occupying its route/site fair share (the next
        ``_route_rates`` no longer counts it), which is how a campaign ending
        early hands its bandwidth back to the survivors.  No-op for archived
        or unknown uids, so terminal transfers stay pollable unchanged."""
        x = self._live.pop(uid, None)
        if x is None:
            return
        x.status = Status.FAILED
        x.detail = "cancelled"
        x.completed_at = self.clock.now
        self._archive[uid] = self._state_of(x)

    @staticmethod
    def _state_of(x: _SimXfer) -> TransferState:
        # rate over *active* time (paper Table 3 reports achieved per-transfer
        # rates; PAUSED maintenance windows and metadata scans don't count)
        dur = max(1e-9, x.active_s)
        frac = x.bytes_done / max(1, x.dataset.bytes)
        return TransferState(
            status=x.status,
            bytes_done=int(x.bytes_done),
            files_done=int(x.dataset.files * frac),
            dirs_done=int(x.dataset.directories * frac),
            faults=x.faults,
            rate=x.bytes_done / dur,
            detail=x.detail)

    def _log_flow(self, route: Tuple[str, str], nbytes: float) -> None:
        key = (int(self.clock.now // DAY), route)
        self.flow_totals[key] = self.flow_totals.get(key, 0.0) + nbytes
        self._route_bytes[route] = self._route_bytes.get(route, 0.0) + nbytes

    def _log_fault(self, route: Tuple[str, str], n: int = 1) -> None:
        self._route_faults[route] = self._route_faults.get(route, 0) + n

    def route_telemetry(self) -> Dict[Tuple[str, str], Tuple[float, int]]:
        """Cumulative (bytes moved, faults observed) per route since the
        campaign start — the control plane's tuners difference consecutive
        readings to get per-interval throughput and fault rates.  Sorted
        route order, so any float reduction a controller runs over the
        values is evaluated identically in every process (kill/resume
        crosses process boundaries; set order does not)."""
        routes = sorted(set(self._route_bytes) | set(self._route_faults))
        return {r: (self._route_bytes.get(r, 0.0),
                    self._route_faults.get(r, 0))
                for r in routes}

    def live_route_counts(self) -> Dict[str, int]:
        """In-flight transfers per route ("SRC->DST", sorted) — the flight
        recorder's fair-share occupancy gauge.  Read-only, O(live)."""
        counts: Dict[str, int] = {}
        for x in self._live.values():
            key = f"{x.source}->{x.destination}"
            counts[key] = counts.get(key, 0) + 1
        return {k: counts[k] for k in sorted(counts)}

    def _pause_memo(self, now: float) -> Callable[[str], bool]:
        """Per-tick memoized site-pause lookup (two sites per transfer, but
        only a handful of distinct sites)."""
        memo: Dict[str, bool] = {}

        def paused(site: str) -> bool:
            p = memo.get(site)
            if p is None:
                p = memo[site] = self.pause.paused(site, now)
            return p

        return paused

    # destination token for pseudo-routes carrying user reader streams into
    # the fair-share computation; never a real site name
    _READERS = "__readers__"

    def set_read_load(self, owner: str, load: Dict[str, int]) -> None:
        """Register ``owner``'s concurrent user-read streams per site (the
        demand engine re-registers each admission wave).  An empty ``load``
        withdraws the owner entirely, so a finished campaign's readers stop
        taxing the shared transport."""
        load = {s: int(n) for s, n in load.items() if int(n) > 0}
        if load:
            self._read_load[owner] = load
        else:
            self._read_load.pop(owner, None)

    def _reader_streams(self) -> Dict[str, int]:
        """Total user reader streams per site across all owners."""
        total: Dict[str, int] = {}
        for load in self._read_load.values():
            for site, n in load.items():
                total[site] = total.get(site, 0) + n
        return total

    def _route_rates(self, movers: List[_SimXfer]) -> Dict[Tuple[str, str], float]:
        """Fair-share rate per route for the current mover population —
        computed once per route, shared by the tick advance and the
        next-event hints so the two can never diverge.  User reader streams
        are folded in as pseudo-routes ``(site, "__readers__")`` so they
        contend for the source read caps, but only real mover routes appear
        in the returned dict.

        O(movers) when the population is unchanged since the last pricing
        (the same rates dict is returned — callers never mutate it); a
        population change prices all routes in ONE vectorized
        ``fair_share_rates`` call over interned per-route arrays, elementwise
        bit-identical to the per-route scalar ``effective_rate`` path."""
        pop = self._pop_buf
        pop.clear()
        for x in movers:
            r = (x.source, x.destination)
            pop[r] = pop.get(r, 0) + 1
        routes = tuple(pop)
        for site, n in self._reader_streams().items():
            pop[(site, self._READERS)] = n
        if pop == self._rates_pop:
            return self._rates
        rates = self._price_routes(routes, pop)
        # ping-pong the buffers: ``pop`` becomes the cached population, the
        # previous cached dict (if any) becomes next call's scratch
        self._pop_buf = self._rates_pop if self._rates_pop is not None else {}
        self._rates_pop = pop
        self._rates = rates
        return rates

    def _price_routes(self, routes: Tuple[Tuple[str, str], ...],
                      pop: Dict[Tuple[str, str], int]
                      ) -> Dict[Tuple[str, str], float]:
        """Price every route in ``routes`` against the full population
        ``pop`` (mover routes plus reader pseudo-routes) with one vectorized
        ``fair_share_rates`` call.  Per distinct route set, the static
        per-route inputs (bandwidth, site caps, contention knees) are
        interned once into preallocated arrays; only the int64 load buffers
        are refilled per call.  Routes absent from the graph price to 0.0
        without touching site lookups, exactly like the scalar path."""
        arrs = self._route_arrays.get(routes)
        if arrs is None:
            if len(self._route_arrays) > 64:    # combinatorial-blowup guard
                self._route_arrays.clear()
            graph = self.graph
            idx = [i for i, r in enumerate(routes) if r in graph.routes]
            m = len(idx)
            route_bw = np.empty(m)
            read_cap = np.empty(m)
            write_cap = np.empty(m)
            src_knee = np.empty(m)
            dst_knee = np.empty(m)
            inf = float("inf")
            for j, i in enumerate(idx):
                src, dst = routes[i]
                s, d = graph.sites[src], graph.sites[dst]
                route_bw[j] = graph.routes[(src, dst)].bandwidth
                read_cap[j] = s.read_bw
                write_cap[j] = d.write_bw
                src_knee[j] = (inf if s.concurrency_knee is None
                               else s.concurrency_knee)
                dst_knee[j] = (inf if d.concurrency_knee is None
                               else d.concurrency_knee)
            arrs = (idx, route_bw, read_cap, write_cap, src_knee, dst_knee,
                    np.empty(m, dtype=np.int64), np.empty(m, dtype=np.int64),
                    np.empty(m, dtype=np.int64))
            self._route_arrays[routes] = arrs
        (idx, route_bw, read_cap, write_cap, src_knee, dst_knee,
         n_route, src_load, dst_load) = arrs
        sload: Dict[str, int] = {}
        dload: Dict[str, int] = {}
        for (s, d), n in pop.items():
            sload[s] = sload.get(s, 0) + n
            dload[d] = dload.get(d, 0) + n
        for j, i in enumerate(idx):
            src, dst = routes[i]
            n_route[j] = pop[(src, dst)]
            src_load[j] = sload[src]
            dst_load[j] = dload[dst]
        shares = fair_share_rates(route_bw, read_cap, write_cap,
                                  n_route, src_load, dst_load,
                                  src_knee, dst_knee)
        rates = dict.fromkeys(routes, 0.0)
        for j, i in enumerate(idx):
            rates[routes[i]] = float(shares[j])
        return rates

    def user_read_rate(self, site: str) -> float:
        """Fair-share bytes/s one user read stream gets from ``site``'s read
        cap right now, sharing it with every non-paused mover sourcing there
        and every other reader stream.  Paused sites serve at their paused
        fair share of zero concurrency — i.e. the full cap — because the
        maintenance window stalls movers, not the serving tier's disks."""
        s = self.graph.sites[site]
        paused = self._pause_memo(self.clock.now)
        load = self._reader_streams().get(site, 0)
        if not paused(site):
            for x in self._live.values():
                if (x.phase == "move" and x.source == site
                        and not paused(x.destination)):
                    load += 1
        load = max(1, load)
        return RouteGraph._contended(s.read_bw, load,
                                     s.concurrency_knee) / load

    # ------------------------------------------------------------------- tick
    def tick(self) -> None:
        """Advance all live transfers by (clock.now - last_tick)."""
        dt = self.clock.now - self._last_tick
        self._last_tick = self.clock.now
        if dt <= 0:
            return
        now = self.clock.now
        if self.flow_horizon_days is not None:
            day = int(now // DAY)
            if day > self._flow_pruned_day:
                self._flow_pruned_day = day
                floor = day - self.flow_horizon_days
                for key in [k for k in self.flow_totals if k[0] < floor]:
                    del self.flow_totals[key]
        paused = self._pause_memo(now)
        movers: List[_SimXfer] = []
        by_src: Dict[str, List[_SimXfer]] = {}
        for x in self._live.values():
            if paused(x.source) or paused(x.destination):
                x.status = Status.PAUSED
                continue
            x.status = Status.ACTIVE
            if x.phase == "move":
                movers.append(x)
            else:
                by_src.setdefault(x.source, []).append(x)

        # --- metadata scans (shared per source site) -------------------------
        for src, xs in by_src.items():
            site = self.graph.sites[src]
            rate = shared_scan_rate(site, len(xs))
            for x in xs:
                if x.dataset.files > site.scan_mem_limit_files:
                    x.status = Status.FAILED
                    x.faults += 1
                    x.detail = FaultKind.OOM_SCAN.value
                    x.completed_at = now
                    self._log_fault((x.source, x.destination))
                    self.notifier.notify(
                        f"scan OOM on {src} for {x.dataset.path} "
                        f"({x.dataset.files} files) — split into smaller requests",
                        x.dataset.path)
                    continue
                avail = dt
                if x.setup_left > 0:         # task dispatch precedes the scan
                    used = min(x.setup_left, avail)
                    x.setup_left -= used
                    avail -= used
                    if avail <= 0:
                        continue
                x.scan_files_left -= rate * avail
                if x.scan_files_left <= 0:
                    x.phase = "move"

        # --- data movement (fair share of route + site caps) -----------------
        if movers:
            self._advance_movers(movers, dt)

        # --- evict terminal transfers to the archive -------------------------
        finished = [uid for uid, x in self._live.items()
                    if x.status in (Status.SUCCEEDED, Status.FAILED)]
        for uid in finished:
            self._archive[uid] = self._state_of(self._live.pop(uid))

    def _advance_movers(self, movers: List[_SimXfer], dt: float) -> None:
        """Batched advance of the live mover pool.  The fair-share rate is
        computed once per route; a structure-of-arrays view of the pool then
        classifies each mover: the common case (no byte boundary reached
        within ``dt``) is resolved with pure array ops, and only movers that
        hit a fault mark, halt point, or completion take the segment-exact
        scalar walk.  Every arithmetic expression in the fast path mirrors
        ``_advance_mover``'s first loop iteration operation-for-operation, so
        both paths produce bit-identical trajectories."""
        route_rate = self._route_rates(movers)
        if not self.vectorized or dt <= 1e-9:
            for x in movers:
                self._advance_mover(x, dt, route_rate[(x.source, x.destination)])
            return
        n = len(movers)
        inf = float("inf")
        rate = np.empty(n)
        bd = np.empty(n)       # bytes_done
        st = np.empty(n)       # stall_left
        halt = np.empty(n)     # permission-halt byte position (inf if none)
        bound = np.empty(n)    # next byte boundary: completion/halt/fault mark
        for i, x in enumerate(movers):
            rate[i] = route_rate[(x.source, x.destination)]
            bd[i] = x.bytes_done
            st[i] = x.stall_left
            h = inf
            if (x.dataset.unreadable
                    and not self.notifier.is_fixed(x.dataset.path)):
                h = UNREADABLE_HALT_FRACTION * x.dataset.bytes
            halt[i] = h
            nxt = min(float(x.dataset.bytes), h)
            if x.fault_marks and x.fault_marks[0] < nxt:
                nxt = x.fault_marks[0]
            bound[i] = nxt
        # stall is consumed first (exactly as the scalar loop does), then one
        # shared segment step classifies each mover.  Movers whose whole dt
        # is eaten by stall never reach a boundary; otherwise the fast path
        # requires rate > 0, not already at the halt point, and the next
        # boundary strictly beyond this tick (``~hit``) — only boundary
        # crossers take the segment-exact scalar walk.
        rem, new_stall = consume_stall(dt, st)
        _, new_bd, adv, moved, hit = advance_segment(rem, bd, rate, bound)
        fast = (rem <= 1e-9) | ((rate > 0) & (bd < halt) & ~hit)
        for i, x in enumerate(movers):
            if not fast[i]:
                self._advance_mover(x, dt,
                                    route_rate[(x.source, x.destination)])
                continue
            x.stall_left = float(new_stall[i])
            r = float(rem[i])
            if r > 1e-9:
                x.bytes_done = float(new_bd[i])
                x.active_s += float(adv[i])
                self._log_flow((x.source, x.destination), float(moved[i]))

    def _advance_mover(self, x: _SimXfer, dt: float, rate: float) -> None:
        """Advance one moving transfer by wall time ``dt`` at fair-share
        ``rate``, processing fault stalls, fault marks, the unreadable-file
        halt point, and completion *in order* within the tick.  Segment-exact:
        the result is independent of how ``dt`` is sliced, so the fixed-step
        and event-driven drivers see identical trajectories."""
        halt: Optional[float] = None
        if (x.dataset.unreadable
                and not self.notifier.is_fixed(x.dataset.path)):
            halt = UNREADABLE_HALT_FRACTION * x.dataset.bytes
        moved_total = 0.0
        t = dt
        while t > 1e-9:
            if x.stall_left > 0:
                used = min(x.stall_left, t)
                x.stall_left -= used
                t -= used
                continue
            if halt is not None and x.bytes_done >= halt:
                x.bytes_done = halt
                x.status = Status.FAILED
                x.faults += 1
                x.detail = FaultKind.PERMISSION.value
                x.completed_at = self.clock.now
                self._log_fault((x.source, x.destination))
                self.notifier.notify(
                    f"permission failure (unreadable files) in {x.dataset.path}",
                    x.dataset.path)
                break
            if rate <= 0:
                break
            # next byte boundary: fault mark, halt point, or completion
            nxt = float(x.dataset.bytes)
            if halt is not None:
                nxt = min(nxt, halt)
            if x.fault_marks and x.fault_marks[0] < nxt:
                nxt = x.fault_marks[0]
            need = max(0.0, nxt - x.bytes_done) / rate
            if need > t:
                x.bytes_done += rate * t
                x.active_s += t
                moved_total += rate * t
                t = 0.0
                break
            x.bytes_done = nxt
            x.active_s += need
            moved_total += rate * need
            t -= need
            if x.fault_marks and x.fault_marks[0] <= nxt:
                x.fault_marks.pop(0)
                x.faults += 1
                x.stall_left += self.retry.fault_retry_cost_s
                self._log_fault((x.source, x.destination))
                continue
            if halt is not None and nxt >= halt:
                continue            # halt handled at the top of the loop
            if nxt >= x.dataset.bytes:
                x.bytes_done = float(x.dataset.bytes)
                x.status = Status.SUCCEEDED
                x.completed_at = self.clock.now
                break
        if moved_total > 0:
            self._log_flow((x.source, x.destination), moved_total)

    # ------------------------------------------------------------ checkpoints
    _XFER_SCALARS = ("source", "destination", "submitted_at", "phase",
                     "setup_left", "scan_files_left", "bytes_done",
                     "active_s", "faults", "stall_left", "completed_at",
                     "detail")
    _STATE_SCALARS = ("bytes_done", "files_done", "dirs_done", "faults",
                      "rate", "detail")

    def state_dict(self, archive_uids: Optional[set] = None) -> dict:
        """JSON-serializable copy of the mutable simulation state: the live
        mover pool (insertion order preserved — tick iteration order must
        survive a resume), the terminal-transfer archive, the tick cursor,
        and the per-(day, route) flow telemetry.  Datasets are referenced by
        path; ``load_state_dict`` re-binds them against the catalog.

        ``archive_uids`` restricts the serialized archive to uids that can
        still be polled (rows still occupying a transfer slot).  Entries the
        scheduler has already consumed — the archive's vast majority late in
        a campaign — are dead weight after their row went terminal, so
        filtering keeps snapshot size O(active), not O(campaign history)."""
        live = []
        for uid, x in self._live.items():
            e = {"uid": uid, "dataset": x.dataset.path,
                 "status": x.status.value,
                 "fault_marks": list(x.fault_marks)}
            for f in self._XFER_SCALARS:
                e[f] = getattr(x, f)
            live.append(e)
        archive = []
        for uid, st in self._archive.items():
            if archive_uids is not None and uid not in archive_uids:
                continue
            e = {"uid": uid, "status": st.status.value}
            for f in self._STATE_SCALARS:
                e[f] = getattr(st, f)
            archive.append(e)
        out = {"last_tick": self._last_tick, "live": live, "archive": archive,
               "flow": [[day, src, dst, v]
                        for (day, (src, dst)), v in self.flow_totals.items()],
               "route_bytes": [[src, dst, v]
                               for (src, dst), v in self._route_bytes.items()],
               "route_faults": [[src, dst, n]
                                for (src, dst), n in
                                self._route_faults.items()]}
        if self._read_load:
            # present only when demand traffic is live, so snapshots of
            # demand-free campaigns are byte-identical to pre-demand ones
            out["read_load"] = [[owner, site, n]
                                for owner in sorted(self._read_load)
                                for site, n in
                                sorted(self._read_load[owner].items())]
        return out

    def load_state_dict(self, d: dict, catalog: Dict[str, Dataset]) -> None:
        self._last_tick = d["last_tick"]
        self._live = {}
        for e in d["live"]:
            x = _SimXfer(dataset=catalog[e["dataset"]],
                         source=e["source"], destination=e["destination"],
                         submitted_at=e["submitted_at"],
                         status=Status(e["status"]),
                         fault_marks=[float(m) for m in e["fault_marks"]])
            for f in self._XFER_SCALARS:
                setattr(x, f, e[f])
            self._live[e["uid"]] = x
        self._archive = {
            e["uid"]: TransferState(
                status=Status(e["status"]),
                **{f: e[f] for f in self._STATE_SCALARS})
            for e in d["archive"]}
        self.flow_totals = {(day, (src, dst)): v
                            for day, src, dst, v in d["flow"]}
        self._route_bytes = {(src, dst): float(v)
                             for src, dst, v in d["route_bytes"]}
        self._route_faults = {(src, dst): int(n)
                              for src, dst, n in d["route_faults"]}
        self._read_load = {}
        for owner, site, n in d.get("read_load", ()):
            self._read_load.setdefault(owner, {})[site] = int(n)

    # ------------------------------------------------------- next-event hints
    def next_event_hint(self) -> float:
        """Seconds until the earliest projected *state change* among live
        transfers, assuming current fair-share rates persist: a transfer
        completing or halting on unreadable files, or a metadata scan
        finishing (either of which changes route/site fair shares).  Fault
        marks and stall expiries are NOT events — ``_advance_mover`` resolves
        them exactly within a tick — but their stall time is folded into each
        completion estimate.  Returns ``inf`` when nothing is in flight;
        pause-window boundaries are the caller's responsibility (see
        ``PauseManager.next_boundary``).  Touches only the live pool."""
        now = self.clock.now
        best = float("inf")
        paused = self._pause_memo(now)
        scanners_by_src: Dict[str, List[_SimXfer]] = {}
        movers: List[_SimXfer] = []
        for x in self._live.values():
            if paused(x.source) or paused(x.destination):
                continue        # state flips at a pause boundary, not here
            if x.phase == "scan":
                scanners_by_src.setdefault(x.source, []).append(x)
            elif x.phase == "move":
                movers.append(x)
        for src, xs in scanners_by_src.items():
            site = self.graph.sites[src]
            rate = shared_scan_rate(site, len(xs))
            for x in xs:
                if x.dataset.files > site.scan_mem_limit_files:
                    return 1.0  # OOM fires on the very next tick
                if rate > 0:
                    best = min(best, x.setup_left
                               + max(0.0, x.scan_files_left / rate))
        route_rate = self._route_rates(movers)
        for x in movers:
            rate = route_rate[(x.source, x.destination)]
            if rate <= 0:
                continue
            halt_active = (x.dataset.unreadable
                           and not self.notifier.is_fixed(x.dataset.path))
            target = (UNREADABLE_HALT_FRACTION * x.dataset.bytes
                      if halt_active else float(x.dataset.bytes))
            if target <= x.bytes_done:
                return max(x.stall_left, 1.0)   # halts on the next tick
            pending_stall = x.stall_left + self.retry.fault_retry_cost_s * sum(
                1 for m in x.fault_marks if m < target)
            best = min(best,
                       pending_stall + (target - x.bytes_done) / rate)
        return best


# ================================================================== local FS
_CHUNK_BYTES = 4 * 1024 * 1024


class LocalFSTransport(Transport):
    """Moves real bytes between site directories with integrity verification.

    Site ``X`` maps to ``root/X/``.  A transfer of dataset path ``P`` copies
    ``root/src/P`` -> ``root/dst/P`` file by file in ``_CHUNK_BYTES`` pieces,
    checksumming source and destination incrementally as the bytes stream
    through (paper: Globus checksums every file and retransmits corrupted
    ones) — whole files are never held in memory.  ``corruptor`` lets tests
    flip bytes in flight (it sees each chunk) to prove detection.  Source
    stream, destination re-read and audit all hash on ``device``; a CUDA
    device without CUDA raises here, at construction.
    """

    def __init__(self, root: str,
                 corruptor: Optional[Callable[[str, bytes], bytes]] = None,
                 device: Device = "cuda"):
        self.root = root
        self.corruptor = corruptor
        self.device = require_device(device)
        self._states: Dict[str, TransferState] = {}

    def site_dir(self, site: str) -> str:
        return os.path.join(self.root, site)

    def _copy_attempt(self, sp: str, dp: str) -> Tuple[int, int]:
        """Stream one source→destination copy; returns (nbytes, source
        checksum).  The corruptor (if any) mangles chunks in flight."""
        src_sum = StreamingChecksum(self.device)
        nbytes = 0
        with open(sp, "rb") as fin, open(dp, "wb") as fout:
            while True:
                chunk = fin.read(_CHUNK_BYTES)
                if not chunk:
                    break
                nbytes += len(chunk)
                src_sum.update(chunk)
                payload = chunk
                if self.corruptor is not None:
                    payload = self.corruptor(sp, chunk)
                fout.write(payload)
        return nbytes, src_sum.digest()

    def _checksum_file(self, path: str) -> int:
        return stream_file_checksum(path, self.device)[1]

    def submit(self, dataset: Dataset, source: str, destination: str) -> str:
        uid = str(uuidlib.uuid4())
        src_base = os.path.join(self.site_dir(source), dataset.path.lstrip("/"))
        dst_base = os.path.join(self.site_dir(destination), dataset.path.lstrip("/"))
        faults = 0
        nbytes = 0
        nfiles = 0
        ndirs = 0
        try:
            for dirpath, _, files in os.walk(src_base):
                rel = os.path.relpath(dirpath, src_base)
                ddir = os.path.join(dst_base, rel) if rel != "." else dst_base
                os.makedirs(ddir, exist_ok=True)
                ndirs += 1
                for fn in files:
                    sp = os.path.join(dirpath, fn)
                    dp = os.path.join(ddir, fn)
                    for _attempt in range(3):
                        size, want = self._copy_attempt(sp, dp)
                        if self._checksum_file(dp) == want:
                            break
                        faults += 1  # integrity fault -> retransmit
                    else:
                        raise IOError(f"persistent corruption for {sp}")
                    nbytes += size
                    nfiles += 1
            st = TransferState(Status.SUCCEEDED, bytes_done=nbytes,
                               files_done=nfiles, dirs_done=ndirs, faults=faults)
        except (OSError, IOError) as e:
            st = TransferState(Status.FAILED, bytes_done=nbytes,
                               files_done=nfiles, dirs_done=ndirs,
                               faults=faults + 1, detail=str(e))
        self._states[uid] = st
        return uid

    def poll(self, uid: str) -> TransferState:
        return self._states[uid]

    def audit(self, dataset: Dataset, source: str, destination: str,
              rels=None) -> Dict[str, dict]:
        """Post-landing scrub of a landed replica: scan the source tree into
        a ``Manifest`` and re-verify the destination copy against it with
        ``Manifest.verify_many`` — the same batched/partial API the simulated
        scrub engine models.  ``rels`` limits the audit to a subset of files
        (one scrub batch); returns the per-file verify_many report."""
        src = os.path.join(self.site_dir(source), dataset.path.lstrip("/"))
        dst = os.path.join(self.site_dir(destination), dataset.path.lstrip("/"))
        return Manifest.scan(src, self.device).verify_many(
            dst, rels=rels, device=self.device)
