"""Replica membership table with per-replica circuit breakers.

The port of ``sutro_tpu/fleet/membership.py``, line for line.

One ``Replica`` row per configured engine endpoint. The health prober
(``fleet/health.py``) feeds probe outcomes in; the router reads healthy
snapshots out. Breaker discipline per replica:

    closed  --F consecutive failures-->  open
    open    --backoff-spaced probe-----> half_open (one trial in flight)
    half_open --success--> closed        --failure--> open (backoff grows)

While open, probes are spaced by bounded exponential backoff
(``interval * 2^k`` capped) so a dead replica costs O(1) probes/min,
not a probe storm. ``draining`` is orthogonal to the breaker: a
replica that answers 503-draining is *alive but unroutable* — the
router stops sending new work and lets in-flight rows finish, and no
failover fires until the replica actually stops answering.

All mutation happens under one lock; readers get plain-dict snapshots
(never live row references) so the router's pick path holds no lock
while doing network IO.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import frames

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: consecutive probe failures that open the breaker
FAIL_THRESHOLD = 3
#: sliding window (s) over which breaker transitions count as "flap"
FLAP_WINDOW_S = 120.0
#: transitions within FLAP_WINDOW_S that the doctor calls flapping
FLAP_THRESHOLD = 3


class Replica:
    """One engine endpoint. Mutated only by FleetMembership under its
    lock; external readers see snapshot() copies."""

    def __init__(self, rid: str, url: str):
        self.rid = rid
        self.url = url.rstrip("/")
        self.state = CLOSED
        self.draining = False
        self.ready = False  # False until the first successful probe
        self.consecutive_failures = 0
        self.open_probes = 0  # probes attempted while open (backoff exponent)
        self.next_probe_at = 0.0  # monotonic deadline for the next probe
        self.last_seen = 0.0  # monotonic time of last successful probe
        self.load = 0  # least-loaded score from the last fleet_state
        self.load_doc: Dict[str, Any] = {}
        self.models: List[str] = []
        # protocol capabilities (downgraded when the replica 404s the
        # fleet endpoints — satellite: old replica vs new router)
        self.fleet_protocol = True
        self.warm_probe = True
        self.fleet_obs = True
        # breaker transition timestamps (monotonic) for flap detection
        self.transitions: List[float] = []


class FleetMembership:
    """Thread-safe replica table + breaker state machine."""

    def __init__(
        self,
        replica_urls: List[str],
        probe_interval: float = 1.0,
        backoff_cap: float = 30.0,
        fail_threshold: int = FAIL_THRESHOLD,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ):
        self.probe_interval = float(probe_interval)
        self.backoff_cap = float(backoff_cap)
        self.fail_threshold = int(fail_threshold)
        # called as on_transition(rid, old_state, new_state) OUTSIDE the
        # lock — the router hooks batch failover here
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        for i, url in enumerate(replica_urls):
            rid = "r%d" % i
            self._replicas[rid] = Replica(rid, url)

    # -- probe scheduling ---------------------------------------------

    def due_probes(self, now: Optional[float] = None) -> List[Dict[str, str]]:
        """Replicas whose next probe deadline has passed."""
        now = time.monotonic() if now is None else now
        out = []
        with self._lock:
            for r in self._replicas.values():
                if now >= r.next_probe_at:
                    out.append({"rid": r.rid, "url": r.url})
        return out

    def _schedule_next(self, r: Replica, now: float) -> None:
        if r.state == CLOSED:
            r.next_probe_at = now + self.probe_interval
        else:
            # bounded exponential backoff while open/half-open; the
            # exponent is probes-since-open so a long-dead replica
            # settles at backoff_cap instead of a probe storm
            delay = min(
                self.probe_interval * (2.0 ** min(r.open_probes, 16)),
                self.backoff_cap,
            )
            r.next_probe_at = now + delay

    def _transition(self, r: Replica, new_state: str, now: float) -> Optional[str]:
        old = r.state
        if old == new_state:
            return None
        r.state = new_state
        r.transitions.append(now)
        # trim the flap window
        cutoff = now - FLAP_WINDOW_S
        while r.transitions and r.transitions[0] < cutoff:
            r.transitions.pop(0)
        return old

    # -- probe outcomes (called by the prober) ------------------------

    def note_probe_success(
        self, rid: str, state_doc: Dict[str, Any], now: Optional[float] = None
    ) -> None:
        """A probe answered. ``state_doc`` is a parsed fleet_state (or
        normalized legacy healthz) frame."""
        now = time.monotonic() if now is None else now
        fired = None
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.consecutive_failures = 0
            r.open_probes = 0
            r.last_seen = now
            r.draining = bool(state_doc.get("draining", False))
            r.ready = bool(state_doc.get("ready", state_doc.get("ok", False)))
            r.load_doc = state_doc.get("load") or {}
            r.load = frames.load_score(r.load_doc)
            if state_doc.get("models"):
                r.models = list(state_doc["models"])
            r.fleet_protocol = bool(state_doc.get("fleet_protocol", False))
            r.warm_probe = bool(state_doc.get("warm_probe", False))
            r.fleet_obs = bool(state_doc.get("fleet_obs", False))
            old = self._transition(r, CLOSED, now)
            if old is not None:
                fired = (r.rid, old, CLOSED)
            self._schedule_next(r, now)
        if fired is not None and self.on_transition is not None:
            self.on_transition(*fired)

    def note_probe_failure(self, rid: str, now: Optional[float] = None) -> None:
        """A probe timed out / refused / errored."""
        now = time.monotonic() if now is None else now
        fired = None
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.consecutive_failures += 1
            if r.state == CLOSED:
                if r.consecutive_failures >= self.fail_threshold:
                    old = self._transition(r, OPEN, now)
                    r.open_probes = 0
                    if old is not None:
                        fired = (r.rid, old, OPEN)
            else:
                # half_open trial failed, or still dead while open
                old = self._transition(r, OPEN, now)
                r.open_probes += 1
                if old is not None:
                    fired = (r.rid, old, OPEN)
            self._schedule_next(r, now)
        if fired is not None and self.on_transition is not None:
            self.on_transition(*fired)

    def note_half_open(self, rid: str, now: Optional[float] = None) -> None:
        """The prober is about to send a trial probe to an open replica."""
        now = time.monotonic() if now is None else now
        fired = None
        with self._lock:
            r = self._replicas.get(rid)
            if r is None or r.state != OPEN:
                return
            old = self._transition(r, HALF_OPEN, now)
            if old is not None:
                fired = (r.rid, old, HALF_OPEN)
        if fired is not None and self.on_transition is not None:
            self.on_transition(*fired)

    # -- router-facing reads ------------------------------------------

    def healthy(self) -> List[Dict[str, Any]]:
        """Routable replicas: breaker closed, ready, not draining."""
        with self._lock:
            return [
                self._row(r)
                for r in self._replicas.values()
                if r.state == CLOSED and r.ready and not r.draining
            ]

    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            r = self._replicas.get(rid)
            return self._row(r) if r is not None else None

    def all(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._row(r) for r in self._replicas.values()]

    def bump_load(self, rid: str, delta: int = 1) -> None:
        """Optimistic load adjustment between probes so a burst of
        picks doesn't all land on the same momentarily-idle replica."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None:
                r.load = max(0, r.load + delta)

    def flapping(self, now: Optional[float] = None) -> List[str]:
        """Replica ids with >= FLAP_THRESHOLD breaker transitions in
        the flap window (the doctor's replica_flapping evidence)."""
        now = time.monotonic() if now is None else now
        cutoff = now - FLAP_WINDOW_S
        out = []
        with self._lock:
            for r in self._replicas.values():
                if len([t for t in r.transitions if t >= cutoff]) >= FLAP_THRESHOLD:
                    out.append(r.rid)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view for /fleet, the doctor, and telemetry."""
        now = time.monotonic()
        cutoff = now - FLAP_WINDOW_S
        with self._lock:
            rows = []
            for r in self._replicas.values():
                row = self._row(r)
                row["transitions_in_window"] = len(
                    [t for t in r.transitions if t >= cutoff]
                )
                row["age_s"] = round(now - r.last_seen, 3) if r.last_seen else None
                rows.append(row)
        states = [row["state"] for row in rows]
        n_healthy = len(
            [
                row
                for row in rows
                if row["state"] == CLOSED and row["ready"] and not row["draining"]
            ]
        )
        return {
            "replicas": rows,
            "n_replicas": len(rows),
            "n_healthy": n_healthy,
            "n_open": states.count(OPEN) + states.count(HALF_OPEN),
            "n_draining": len([row for row in rows if row["draining"]]),
        }

    @staticmethod
    def _row(r: Replica) -> Dict[str, Any]:
        return {
            "rid": r.rid,
            "url": r.url,
            "state": r.state,
            "ready": r.ready,
            "draining": r.draining,
            "load": r.load,
            "load_doc": dict(r.load_doc),
            "models": list(r.models),
            "fleet_protocol": r.fleet_protocol,
            "warm_probe": r.warm_probe,
            "fleet_obs": r.fleet_obs,
            "consecutive_failures": r.consecutive_failures,
        }
