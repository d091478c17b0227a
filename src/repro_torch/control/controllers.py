"""Online transfer-tuning controllers.

Each controller observes per-route flow telemetry from the simulated
transport at a fixed control interval (sim-clock driven, so every decision
is a pure function of the trajectory — trajectories stay bit-reproducible)
and adjusts either the schedulers' live per-route concurrency caps
(``ConcurrencyTuner``) or the bundle composer's soft size targets for
future cuts (``BundleSizeTuner``).

The lineage is the congestion-control family GridFTP adopted for WAN
transfers: additive-increase / multiplicative-decrease concurrency probing,
and hill-climbing on observed throughput for batch sizing.  ``StaticPolicy``
is represented by the *absence* of controllers — the control plane builds
none, and the declared caps/targets hold for the whole campaign.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple

Route = Tuple[str, str]


class Controller(abc.ABC):
    """One online tuner; ``act`` runs once per control interval."""
    kind: str = "?"

    @abc.abstractmethod
    def act(self, now: float, dt: float,
            telemetry: Dict[Route, Tuple[float, int]],
            plane) -> List[dict]:
        """Observe the interval's telemetry and apply adjustments through
        ``plane`` (the ControlPlane owning scheduler/composer access).
        Returns ledger entries for every decision taken."""

    @abc.abstractmethod
    def state_dict(self) -> dict: ...

    @abc.abstractmethod
    def load_state_dict(self, d: dict) -> None: ...


class ConcurrencyTuner(Controller):
    """AIMD per-route concurrency: probe upward one slot at a time while a
    route's throughput holds; halve toward the floor when throughput drops
    or the route's fault count spikes (the scheduler drains excess actives
    naturally — a lowered cap stops new starts, it never aborts transfers).
    """
    kind = "aimd"

    def __init__(self, policy):
        self.policy = policy
        self._last: Dict[Route, Tuple[float, int]] = {}  # route -> (bytes, faults)
        self._last_tput: Dict[Route, float] = {}

    def act(self, now, dt, telemetry, plane):
        entries: List[dict] = []
        pol = self.policy
        for route in sorted(telemetry):
            nbytes, nfaults = telemetry[route]
            lb, lf = self._last.get(route, (0.0, 0))
            self._last[route] = (nbytes, nfaults)
            tput = (nbytes - lb) / max(dt, 1e-9)
            dfaults = nfaults - lf
            prev = self._last_tput.get(route)
            self._last_tput[route] = tput
            cap = plane.route_cap(route)
            if dfaults > pol.fault_budget or (
                    prev is not None and prev > 0
                    and tput < prev * (1.0 - pol.drop_fraction)):
                new = max(pol.min_active_per_route, cap // 2)
            elif tput > 0:
                new = min(pol.max_active_per_route, cap + 1)
            else:
                continue                    # idle route: leave it alone
            if new == cap:
                continue
            plane.set_route_cap(route, new)
            entries.append({"controller": self.kind,
                            "route": list(route),
                            "cap": new, "prev_cap": cap,
                            "gbps": tput / 1024 ** 3,
                            "faults": dfaults})
        return entries

    def state_dict(self):
        return {"last": [[s, d, b, f]
                         for (s, d), (b, f) in self._last.items()],
                "last_tput": [[s, d, t]
                              for (s, d), t in self._last_tput.items()]}

    def load_state_dict(self, d):
        self._last = {(s, dst): (float(b), int(f))
                      for s, dst, b, f in d["last"]}
        self._last_tput = {(s, dst): float(t) for s, dst, t in d["last_tput"]}


class BundleSizeTuner(Controller):
    """Throughput-gradient bundle sizing: scale the composer's soft targets
    by ``bundle_growth`` in the current direction; reverse direction when
    aggregate throughput fell since the last interval.  Only affects bundles
    not yet cut — in-flight tasks are never resized."""
    kind = "gradient"

    def __init__(self, policy):
        self.policy = policy
        self._dir = 1.0
        self._last_bytes: Optional[float] = None
        self._last_tput: Optional[float] = None

    def act(self, now, dt, telemetry, plane):
        composer = plane.composer
        if composer is None or composer.done:
            return []
        total = sum(b for b, _ in telemetry.values())
        if self._last_bytes is None:
            self._last_bytes = total
            return []
        tput = (total - self._last_bytes) / max(dt, 1e-9)
        self._last_bytes = total
        prev, self._last_tput = self._last_tput, tput
        if prev is not None and tput < prev:
            self._dir = -self._dir
        g = self.policy.bundle_growth ** self._dir
        pol = self.policy
        composer.target_files = int(
            min(pol.max_files,
                max(pol.min_target_files, composer.target_files * g)))
        composer.target_bytes = int(
            min(pol.max_bytes,
                max(pol.min_target_bytes, composer.target_bytes * g)))
        return [{"controller": self.kind,
                 "target_files": composer.target_files,
                 "target_bytes": composer.target_bytes,
                 "gbps": tput / 1024 ** 3,
                 "direction": self._dir}]

    def state_dict(self):
        return {"dir": self._dir, "last_bytes": self._last_bytes,
                "last_tput": self._last_tput}

    def load_state_dict(self, d):
        self._dir = float(d["dir"])
        self._last_bytes = d["last_bytes"]
        self._last_tput = d["last_tput"]


def make_controllers(policy) -> List[Controller]:
    """Instantiate the policy's controller chain (empty for static)."""
    made: List[Controller] = []
    for name in policy.controller_names():
        if name == "aimd":
            made.append(ConcurrencyTuner(policy))
        elif name == "gradient":
            made.append(BundleSizeTuner(policy))
        else:                               # pragma: no cover - validated
            raise ValueError(f"unknown controller {name!r}")
    return made
