"""Observability: the campaign flight recorder.

The paper's replication succeeded because operators could *see* what 29 M
files were doing — Globus event logs plus the progress database let them
diagnose DTN outages, a 2.5-day network failure, and checksum faults
mid-campaign.  This package gives the simulator the same layer:

  * ``TraceRecorder`` (``repro_torch.obs.trace``) — per-transfer lifecycle spans
    off the ``TransferTable`` row-transition listener, ring-buffered with a
    byte budget, exportable to NDJSON and Chrome trace-event JSON
    (Perfetto-viewable, sim-clock timestamps);
  * ``MetricsRegistry`` (``repro_torch.obs.metrics``) — counters / gauges /
    histograms sampled on a sim-clock cadence: per-route throughput and
    occupancy, queue/backoff depths, fault rates, scrub data-at-risk,
    demand hit-rate;
  * ``Observability`` (``repro_torch.obs.engine``) — the runtime wiring both onto
    a campaign, driven by ``run_world``;
  * the JAX package's ``PhaseProfiler`` (``obs/profile.py``) and post-mortem
    CLI (``obs/report.py``) are not ported yet.

Declared via ``ObsSpec`` on a ``ScenarioSpec``; the default ``NO_OBS``
compiles to **zero hooks**, and the hard contract is bit-identical
trajectories and snapshots with obs on or off.
"""
from repro_torch.obs.spec import FULL_OBS, NO_OBS, ObsSpec

__all__ = ["ObsSpec", "NO_OBS", "FULL_OBS"]
