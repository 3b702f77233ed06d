"""Heartbeat health prober for the replica fleet.

The port of ``sutro_tpu/fleet/health.py``, line for line; its
transport is ``frames._send`` over ``http.client``.

One daemon thread sweeps the membership table: every replica whose
probe deadline has passed gets one ``GET /fleet-state`` (falling back
to ``GET /healthz`` for replicas that predate the fleet protocol — the
degradation contract in fleet/frames.py). Outcomes feed the
per-replica circuit breaker in FleetMembership; the breaker — not the
prober — decides cadence, so open replicas are probed on bounded
backoff instead of every sweep.

Fault site ``fleet.probe`` fires per probe attempt (``job=`` matches
the replica id): a raising kind is recorded as a probe failure, which
is how the chaos suite drives breaker transitions and flap detection
deterministically without killing real processes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

from .. import telemetry
from ..engine import faults
from . import frames
from .membership import CLOSED, OPEN, FleetMembership

log = logging.getLogger("sutro.fleet")

#: sweep granularity (s) — the floor on probe-deadline resolution,
#: NOT the probe rate (that's membership.probe_interval + backoff)
SWEEP_S = 0.05


class HealthProber:
    def __init__(
        self,
        membership: FleetMembership,
        timeout: float = 2.0,
        send=frames._send,
    ):
        self.membership = membership
        self.timeout = float(timeout)
        self._send = send
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="fleet-prober", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def wake(self) -> None:
        """Probe everything due right now (tests + router startup)."""
        self.sweep_once()

    # -- internals -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sweep_once()
            except Exception:
                log.exception("fleet prober sweep failed")
            self._stop.wait(SWEEP_S)

    def sweep_once(self) -> None:
        for due in self.membership.due_probes():
            if self._stop.is_set():
                return
            self.probe_one(due["rid"], due["url"])
        self._export_gauges()

    def probe_one(self, rid: str, url: str) -> bool:
        """One probe exchange; returns True when the replica answered
        as routable."""
        row = self.membership.get(rid)
        if row is not None and row["state"] == OPEN:
            # breaker open: this probe is the half-open trial
            self.membership.note_half_open(rid)
        try:
            if faults.ACTIVE is not None:
                faults.inject("fleet.probe", job=rid)
            doc = self._probe_state(rid, url, row)
        except Exception:
            self.membership.note_probe_failure(rid)
            return False
        if doc is None:
            self.membership.note_probe_failure(rid)
            return False
        self.membership.note_probe_success(rid, doc)
        return bool(doc.get("ready") and not doc.get("draining"))

    def _probe_state(
        self, rid: str, url: str, row: Optional[Dict[str, Any]]
    ) -> Optional[Dict[str, Any]]:
        """GET /fleet-state, degrading to /healthz on 404 (old replica
        vs new router: health-probe-only routing, never a crash)."""
        use_fleet = row is None or row.get("fleet_protocol", True)
        if use_fleet:
            doc = self._send("get", url + "/fleet-state", timeout=self.timeout)
            status = doc.get("_status", 200) if isinstance(doc, dict) else 0
            if status == 404:
                use_fleet = False  # legacy replica — fall through
            elif status >= 500 and not isinstance(doc, dict):
                return None
            else:
                parsed = frames.parse_fleet_state(doc)
                if parsed is not None:
                    # 503 carries state=draining/warming in-band: the
                    # replica is alive, just unroutable
                    return parsed
                return None
        if not use_fleet:
            doc = self._send("get", url + "/healthz", timeout=self.timeout)
            if not isinstance(doc, dict):
                return None
            parsed = frames.parse_fleet_state(doc)
            if parsed is None:
                # pre-healthz-states server: any JSON answer means alive
                parsed = {"ok": True, "ready": True, "draining": False,
                          "load": {}, "models": [], "fleet_protocol": False,
                          "warm_probe": False, "state": "ready"}
            parsed["fleet_protocol"] = False
            parsed["warm_probe"] = False
            return parsed
        return None

    def _export_gauges(self) -> None:
        if not telemetry.ENABLED:
            return
        snap = self.membership.snapshot()
        counts: Dict[str, int] = {"healthy": snap["n_healthy"],
                                  "draining": snap["n_draining"]}
        for row in snap["replicas"]:
            if row["state"] != CLOSED:
                counts[row["state"]] = counts.get(row["state"], 0) + 1
        for state in ("healthy", "open", "half_open", "draining"):
            telemetry.FLEET_REPLICAS.set(float(counts.get(state, 0)), state)
