"""Maintenance windows -> PAUSED transfers (paper C4).

ALCF pauses active transfers involving its endpoints before maintenance so
they do not fail; the replication tool detects PAUSED and re-routes.  We model
per-site maintenance calendars in simulated time, including ALCF's weekly
extended window and occasional unplanned outages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DAY = 86400.0


@dataclass
class MaintenanceWindow:
    start: float
    end: float
    planned: bool = True


class PauseManager:
    def __init__(self):
        self._windows: Dict[str, List[MaintenanceWindow]] = {}

    def add_window(self, site: str, start: float, end: float,
                   planned: bool = True) -> None:
        self._windows.setdefault(site, []).append(
            MaintenanceWindow(start, end, planned))

    def add_weekly(self, site: str, first_start: float, duration: float,
                   until: float, planned: bool = True) -> None:
        t = first_start
        while t < until:
            self.add_window(site, t, min(t + duration, until), planned)
            t += 7 * DAY

    def paused(self, site: str, now: float) -> bool:
        return any(w.start <= now < w.end for w in self._windows.get(site, ()))

    def next_change(self, now: float) -> float:
        """Next time any window opens or closes (all sites)."""
        return min((self.next_boundary(s, now) for s in self._windows),
                   default=float("inf"))

    def next_boundary(self, site: str, now: float) -> float:
        """Next time ``site``'s paused/unpaused state can flip: the start of a
        future window or the end of one containing ``now``.  ``inf`` when the
        site has no boundary after ``now``."""
        ts = [t for w in self._windows.get(site, ())
              for t in (w.start, w.end) if t > now]
        return min(ts) if ts else float("inf")

    def windows(self, site: str) -> List[MaintenanceWindow]:
        return list(self._windows.get(site, ()))
