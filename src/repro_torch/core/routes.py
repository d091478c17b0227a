"""Site/route model: bandwidths, dataset catalogs, and relay planning.

The paper's key performance insight (C2 in DESIGN.md): the source file system
is the bottleneck (LLNL could source at only ~1.5 GB/s), so read it ONCE per
dataset and relay replica→replica over the faster inter-LCF path (up to
7.5 GB/s), with the two hops overlapping.  ``RouteGraph`` captures per-site
read/write caps and per-route bandwidths (paper Table 3) so both the simulator
and the scheduler can reason about them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

GB = 1024 ** 3
TB = 1024 ** 4
PB = 1024 ** 5
DAY = 86400.0


def fair_share_rates(route_bw, read_cap, write_cap, n_route, src_load,
                     dst_load, src_knee=None, dst_knee=None, xp=None):
    """Vectorized fair-share allocation — the pure arithmetic core of
    ``RouteGraph.effective_rate``, elementwise over arbitrarily-shaped
    arrays (numpy or jax.numpy via ``xp``) so the ensemble lanes engine can
    price every route of every lane in one shot.

    All inputs broadcast together: per-route bandwidth and the owning
    sites' read/write caps against the route's active count and the site
    loads (``n_route``/``src_load``/``dst_load`` are clamped to ≥ 1 exactly
    as the scalar path's ``max(1, ·)`` / ``or 1`` do).  Contention knees are
    scalars or arrays with ``inf`` (or ``None``) meaning "no knee declared".
    Missing routes are encoded as ``route_bw == 0`` and price to 0.0.  The
    expression tree (divide, multiply, min — no reassociation) is identical
    to the scalar path, so results agree bit-for-bit in float64.
    """
    import numpy as _np
    if xp is None:
        xp = _np
    inf = float("inf")
    sk = inf if src_knee is None else src_knee
    dk = inf if dst_knee is None else dst_knee
    nr = xp.maximum(1, n_route)
    sl = xp.maximum(1, src_load)
    dl = xp.maximum(1, dst_load)
    with _np.errstate(divide="ignore", invalid="ignore"):
        src_cap = xp.where(sl <= sk, read_cap, read_cap * (sk / sl))
        dst_cap = xp.where(dl <= dk, write_cap, write_cap * (dk / dl))
        return xp.minimum(route_bw / nr,
                          xp.minimum(src_cap / sl, dst_cap / dl))


@dataclass
class Dataset:
    """One ESGF path (a directory tree)."""
    path: str
    bytes: int
    files: int
    directories: int
    unreadable: bool = False  # persistent permission fault (paper §4 phase 4)


@dataclass
class Site:
    name: str
    read_bw: float            # aggregate source rate cap (bytes/s)
    write_bw: float           # aggregate sink rate cap (bytes/s)
    scan_files_per_s: float = 50_000.0   # metadata scan throughput
    scan_mem_limit_files: int = 5_000_000  # OOM threshold for one scan (paper §5)
    # DTN contention knee: beyond this many concurrent transfers touching the
    # site, aggregate throughput *degrades* (stream thrashing — the classic
    # GridFTP parallelism curve rises then falls).  None = ideal fair share,
    # exactly the pre-knee model.
    concurrency_knee: Optional[int] = None


@dataclass
class Route:
    source: str
    destination: str
    bandwidth: float          # per-route cap (bytes/s); min with site caps applies


class RouteGraph:
    def __init__(self, sites: Sequence[Site], routes: Sequence[Route]):
        self.sites: Dict[str, Site] = {s.name: s for s in sites}
        self.routes: Dict[Tuple[str, str], Route] = {
            (r.source, r.destination): r for r in routes}

    def route(self, src: str, dst: str) -> Optional[Route]:
        return self.routes.get((src, dst))

    def bandwidth(self, src: str, dst: str) -> float:
        r = self.route(src, dst)
        if r is None:
            return 0.0
        return min(r.bandwidth, self.sites[src].read_bw, self.sites[dst].write_bw)

    @staticmethod
    def _contended(cap: float, load: int, knee: Optional[int]) -> float:
        """A site's aggregate cap under ``load`` concurrent transfers: ideal
        up to the contention knee, degrading as ``knee/load`` beyond it."""
        if knee is None or load <= knee:
            return cap
        return cap * (knee / load)

    def effective_rate(self, src: str, dst: str,
                       active_by_route: Dict[Tuple[str, str], int]) -> float:
        """Fair-share rate for ONE transfer on (src, dst) given concurrent
        transfers: the route cap is shared among its actives, and each site's
        read/write caps are shared among all transfers touching the site
        (degraded past the site's contention knee, when one is declared)."""
        n_route = max(1, active_by_route.get((src, dst), 1))
        src_load = sum(n for (s, _), n in active_by_route.items() if s == src) or 1
        dst_load = sum(n for (_, d), n in active_by_route.items() if d == dst) or 1
        r = self.route(src, dst)
        if r is None:
            return 0.0
        s_src, s_dst = self.sites[src], self.sites[dst]
        # one shared arithmetic with the batched lanes engine (bit-identical)
        return float(fair_share_rates(
            r.bandwidth, s_src.read_bw, s_dst.write_bw,
            n_route, src_load, dst_load,
            s_src.concurrency_knee, s_dst.concurrency_knee))


# --------------------------------------------------------------- paper setup
def paper_route_graph() -> RouteGraph:
    """Three-site graph with paper Table 3 / §1 bandwidths.

    LLNL file system sources ~1.5 GB/s aggregate; with 2 concurrent transfers
    per route that is ~0.65 GB/s each (Table 3).  Inter-LCF single transfers
    reached 2-3.5 GB/s, peak >7.5 GB/s aggregate.
    """
    sites = [
        Site("LLNL", read_bw=1.5 * GB, write_bw=1.5 * GB,
             scan_files_per_s=20_000, scan_mem_limit_files=2_000_000),
        Site("ALCF", read_bw=10 * GB, write_bw=10 * GB),
        Site("OLCF", read_bw=10 * GB, write_bw=10 * GB),
    ]
    routes = [
        Route("LLNL", "ALCF", 2 * 0.648 * GB),
        Route("LLNL", "OLCF", 2 * 0.662 * GB),
        Route("ALCF", "OLCF", 2 * 1.706 * GB),
        Route("OLCF", "ALCF", 2 * 2.352 * GB),
    ]
    return RouteGraph(sites, routes)


def make_catalog(n_datasets: int = 2291, total_bytes: int = int(7.3 * PB),
                 total_files: int = 28_907_532,
                 total_dirs: int = 17_347_671,
                 seed: int = 0) -> List[Dataset]:
    """Synthesize an ESGF-like catalog: n_datasets directory trees whose sizes
    follow a lognormal distribution, normalized to the paper's totals."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = rng.lognormal(mean=0.0, sigma=1.6, size=n_datasets)
    w = w / w.sum()
    sizes = (w * total_bytes).astype(np.int64)
    files = np.maximum(1, (w * total_files)).astype(np.int64)
    dirs = np.maximum(1, (w * total_dirs)).astype(np.int64)
    names = [_esgf_path(i, rng) for i in range(n_datasets)]
    return [Dataset(names[i], int(sizes[i]), int(files[i]), int(dirs[i]))
            for i in range(n_datasets)]


_INSTITUTIONS = ["MPI-M", "MOHC", "MIROC", "IPSL", "NCAR", "CSIRO", "NOAA-GFDL",
                 "EC-Earth-Consortium", "CNRM-CERFACS", "BCC"]
_EXPERIMENTS = ["historical", "amip", "piControl", "abrupt-4xCO2", "ssp585",
                "ssp245", "esm-hist", "1pctCO2"]


_PATH_CACHE: dict = {}


def _esgf_path(i: int, rng) -> str:
    # pure function of i (rng unused); memoized — every catalog re-derives
    # the same name table
    p = _PATH_CACHE.get(i)
    if p is None:
        inst = _INSTITUTIONS[i % len(_INSTITUTIONS)]
        exp = _EXPERIMENTS[(i // len(_INSTITUTIONS)) % len(_EXPERIMENTS)]
        phase = "CMIP6" if (i % 10) < 9 else "CMIP5"   # ~90% CMIP6 by count
        p = f"/css03_data/{phase}/CMIP/{inst}/model-{i % 97}/{exp}/r{i}i1p1f1"
        _PATH_CACHE[i] = p
    return p


def split_oversized(ds: Dataset, scan_limit_files: int) -> List[Dataset]:
    """Paper §5: scanning an extremely large directory OOM'd a LLNL node; the
    fix was to split into multiple smaller subdirectory transfers."""
    if ds.files <= scan_limit_files:
        return [ds]
    n = math.ceil(ds.files / scan_limit_files)
    out = []
    for j in range(n):
        out.append(Dataset(
            path=f"{ds.path}/part-{j:03d}",
            bytes=ds.bytes // n, files=ds.files // n,
            directories=max(1, ds.directories // n),
            unreadable=ds.unreadable))
    return out
