"""Replica fleet front door (the port of ``sutro_tpu/fleet/``).

One stable batch + OpenAI endpoint over N engine replicas: health-
checked routing with per-replica circuit breakers (membership.py,
health.py), SGLang-style warm-prefix affinity (affinity.py), and
jobstore-backed batch failover with zero lost or duplicated rows
(router.py). Wire frames between router and replica live in frames.py.
The observability plane (obs.py) adds cross-process trace stitching,
federated metrics, and the fleet SLO monitor; replay.py turns the
router's trace ring into a replayable load harness.

Every transport is the standard library's ``http.client``
(``frames._open``; the card's machine has no ``requests``). Import
surface is lazy on purpose: the router pulls in telemetry; replicas
(``server.py``) import only ``fleet.frames``.
"""

from __future__ import annotations

__all__ = [
    "FleetRouter",
    "FleetMembership",
    "FleetMonitor",
    "FleetObservability",
    "HealthProber",
    "WarmAffinity",
    "make_fleet_server",
    "serve_fleet",
    "start_fleet_thread",
]


def __getattr__(name: str):
    if name in ("FleetRouter", "make_fleet_server", "serve_fleet",
                "start_fleet_thread"):
        from . import router

        return getattr(router, name)
    if name in ("FleetMonitor", "FleetObservability"):
        from . import obs

        return getattr(obs, name)
    if name == "FleetMembership":
        from .membership import FleetMembership

        return FleetMembership
    if name == "HealthProber":
        from .health import HealthProber

        return HealthProber
    if name == "WarmAffinity":
        from .affinity import WarmAffinity

        return WarmAffinity
    raise AttributeError(name)
