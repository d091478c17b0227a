"""Declarative campaign scenarios on an event-driven simulation core.

``spec``     — ``ScenarioSpec``: sites, routes, maintenance calendars, fault
               profiles, catalog shape, and incidents, compiled onto the
               existing ``CampaignConfig``/``RouteGraph``/``PauseManager``
               wiring.
``registry`` — named what-if scenarios (the paper-2022 baseline plus
               counterfactuals: degraded source, fault storm, four-site mesh,
               flaky network, incremental top-up, cold-start relay).
``events``   — next-event time advance replacing blind fixed-step ticking:
               a 77-simulated-day campaign replays in seconds.
``crash_resume`` — kill-and-resume scenarios through ``Checkpointer``.
``sweep``    — multi-process parameter sweeps aggregating ``CampaignReport``s
               into comparison frames (``BENCH_scenarios.json``).
``run``      — ``python -m repro_torch.scenarios.run --scenario <name>`` CLI.
"""
from repro_torch.scenarios.spec import (CatalogSpec, FaultProfileSpec, OutageSpec,
                                  RouteSpec, ScenarioSpec, SiteSpec,
                                  TopUpSpec)
from repro_torch.scenarios.registry import get_scenario, list_scenarios

__all__ = [
    "CatalogSpec", "FaultProfileSpec", "OutageSpec", "RouteSpec",
    "ScenarioSpec", "SiteSpec", "TopUpSpec", "get_scenario", "list_scenarios",
]
