"""The control plane: one per campaign runtime, wiring a bundle composer
and a controller chain onto the scheduler/transport pair.

Responsibilities, all driven from the run loop at iteration boundaries (so
every action lands at a deterministic point of the trajectory):

  * **bundle feed** — keep roughly ``lookahead`` bundles composed ahead of
    the scheduler (each cut bundle occupies one pending row per replica):
    cut from the composer's cursor and insert the fresh
    (bundle, destination) rows into the transfer table, which routes them
    into the scheduler's pending queues through the ordinary row-listener
    path (exactly how incremental top-ups enter a campaign);
  * **online control** — every ``control_interval_s`` of sim time, hand the
    transport's per-route telemetry to the controller chain, which adjusts
    live per-route concurrency caps (``ReplicationPolicy.route_caps``) and
    the composer's future-bundle targets;
  * **policy telemetry ledger** — record every decision with its observed
    throughput, feeding the dashboard's policy view and
    ``benchmarks/campaign_replay.py --policy-bench``.

Everything here serializes: the composer cursor, controller internals, live
route caps, the control clock, and the ledger all land in the (version-
bumped) campaign snapshot, so a kill-at-any-iteration resume continues the
controlled trajectory bit-identically.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.control.bundles import BundleComposer
from repro_torch.control.controllers import make_controllers
from repro_torch.control.policy import TransferPolicySpec
from repro_torch.core.routes import DAY
from repro_torch.core.transfer_table import Status

Route = Tuple[str, str]


class PolicyLedger:
    """Append-only record of control decisions (bounded by the number of
    control intervals, not by catalog size)."""

    def __init__(self):
        self.entries: List[dict] = []

    def record(self, now: float, entry: dict) -> None:
        self.entries.append(dict(entry, t_day=round(now / DAY, 6)))

    def state_dict(self) -> list:
        return [dict(e) for e in self.entries]

    def load_state_dict(self, entries: list) -> None:
        self.entries = [dict(e) for e in entries]


class ControlPlane:
    def __init__(self, policy: TransferPolicySpec, sched, transport,
                 source: str, replicas,
                 composer: Optional[BundleComposer] = None,
                 label: str = "campaign"):
        policy.validate()
        self.policy = policy
        self.sched = sched
        self.transport = transport
        self.source = source
        self.replicas = tuple(replicas)
        self.composer = composer
        self.label = label
        self.controllers = make_controllers(policy)
        self.ledger = PolicyLedger()
        self._next_control: Optional[float] = None
        self._last_control: Optional[float] = None

    # ------------------------------------------------------------ cap access
    def route_cap(self, route: Route) -> int:
        return self.sched.policy.cap(*route)

    def set_route_cap(self, route: Route, cap: int) -> None:
        self.sched.policy.route_caps[route] = int(cap)

    # ---------------------------------------------------------------- stepping
    def step(self, now: float) -> None:
        """One control-plane pass at a run-loop boundary: top up the bundle
        feed, then run the controller chain if a control interval elapsed."""
        self._feed_bundles()
        if not self.controllers:
            return
        if self._next_control is None:       # first boundary anchors the clock
            self._last_control = now
            self._next_control = now + self.policy.control_interval_s
            return
        if now + 1e-9 < self._next_control:
            return
        dt = now - self._last_control
        telemetry = self._own_routes(self.transport.route_telemetry())
        for c in self.controllers:
            for entry in c.act(now, dt, telemetry, self):
                self.ledger.record(now, entry)
        self._last_control = now
        self._next_control = now + self.policy.control_interval_s

    def _own_routes(self, telemetry: Dict[Route, Tuple[float, int]]
                    ) -> Dict[Route, Tuple[float, int]]:
        """Restrict shared-transport telemetry to routes THIS campaign can
        schedule on (source→replica and replica→replica relays).  In a
        federation the transport's counters cover every member's traffic;
        without the filter a member's tuner would write caps and ledger
        entries for routes its scheduler never starts."""
        mine = {self.source, *self.replicas}
        return {(src, dst): v for (src, dst), v in telemetry.items()
                if dst in self.replicas and src in mine}

    def _feed_bundles(self) -> None:
        if self.composer is None or self.composer.done:
            return
        table = self.sched.table
        want = max(1, self.policy.lookahead) * len(self.replicas)
        while not self.composer.done and table.count_status(Status.NULL) < want:
            cut = self.composer.cut_next()
            if not cut:
                break
            for b in cut:
                table.populate([b.path], self.source, list(self.replicas))

    def exhausted(self) -> bool:
        """True when no future work can still originate here (the run loop's
        completion check: a campaign is done only when its table is drained
        AND its composer has nothing left to cut)."""
        return self.composer is None or self.composer.done

    def next_action(self, now: float) -> float:
        """Next sim time this plane must run regardless of transfer events
        (the controllers' interval boundary); ``inf`` for pure bundling."""
        if not self.controllers:
            return float("inf")
        if self._next_control is None:
            return now                       # anchor on the next boundary
        return self._next_control

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {
            "composer": (self.composer.state_dict()
                         if self.composer is not None else None),
            "controllers": {c.kind: c.state_dict() for c in self.controllers},
            "route_caps": [[s, d, c]
                           for (s, d), c in
                           sorted(self.sched.policy.route_caps.items())],
            "next_control": self._next_control,
            "last_control": self._last_control,
            "ledger": self.ledger.state_dict(),
        }

    def load_state_dict(self, d: dict) -> None:
        if (d["composer"] is None) != (self.composer is None):
            raise ValueError("snapshot/world disagree about bundle "
                             "composition — policy mismatch")
        if self.composer is not None:
            self.composer.load_state_dict(d["composer"])
        kinds = {c.kind: c for c in self.controllers}
        if set(kinds) != set(d["controllers"]):
            raise ValueError(
                f"snapshot controllers {sorted(d['controllers'])} do not "
                f"match the policy's {sorted(kinds)}")
        for kind, state in d["controllers"].items():
            kinds[kind].load_state_dict(state)
        self.sched.policy.route_caps.clear()
        self.sched.policy.route_caps.update(
            {(s, dst): int(c) for s, dst, c in d["route_caps"]})
        self._next_control = d["next_control"]
        self._last_control = d["last_control"]
        self.ledger.load_state_dict(d["ledger"])
