"""Fleet-wide observability plane for the replica-fleet front door.

The port of ``sutro_tpu/fleet/obs.py``, line for line but for its
imports (the port's telemetry, doctor and monitor).

Three pieces, all router-side (``fleet/router.py`` owns one
:class:`FleetObservability` and, when the monitor switch is on, one
:class:`FleetMonitor`):

1. **Cross-process trace propagation.** The router opens a trace
   (``tr-fr-<n>``) for every relayed request in its OWN bounded
   :class:`~..telemetry.traces.TraceStore` ring — deliberately not the
   process-global ``telemetry.TRACES``: in-process test fleets share
   that singleton with their replicas, and ``start_trace`` idempotency
   would silently merge router and replica spans into one document.
   The id travels to the picked replica in the ``X-Sutro-Trace``
   header; the replica's gateway ADOPTS it instead of minting its own
   (server.py), so both processes hold span timelines under one id.
   An old replica ignores the header and mints locally — its own trace
   still exports, the stitch just degrades to router-spans-only.
   :meth:`FleetObservability.stitch_trace` joins the two documents into
   one multi-process timeline, re-anchoring the replica's offsets onto
   the router's clock by wall-clock difference (the same skew
   convention dp federation uses in telemetry/distributed.py);
   traceexport.stitched_to_chrome renders it with one Perfetto process
   lane group per participant.

2. **Federated metrics.** The router keeps a MIRRORED
   :class:`~..telemetry.registry.MetricsRegistry` whose federation
   label is ``replica`` (the dp coordinator's is ``worker``). Each
   scrape tick it pulls every obs-capable replica's
   ``GET /metrics-snapshot``, ships the per-scrape DIFFERENCE
   (:func:`~..telemetry.registry.snapshot_delta`) into the registry
   under the replica id, and ALSO folds counters/histograms into the
   ``_fleet`` pseudo-replica — so one ``GET /metrics`` scrape of the
   router shows per-replica TTFT/ITL/stage series side by side with a
   fleet-wide aggregate, plus the router's own series (which render
   as ``replica="0"`` once any federation has happened, mirroring the
   coordinator-as-worker-0 convention). Scrapes are cached per
   ``scrape_interval_s`` so a tight curl loop cannot amplify into a
   scrape storm against the replicas.

3. **Fleet SLO monitor.** :class:`FleetMonitor` subclasses the
   engine's :class:`~..telemetry.monitor.Monitor` — same sampler loop,
   hysteresis/debounce rule machine, NDJSON stream contract, and
   degrade-to-disabled-on-error posture — but samples the ROUTER's
   world instead of the engine registry: router counters, the
   federated ``_fleet`` TTFT window, route latency, and membership
   census. Stock rules (:data:`FLEET_RULES`) cover fleet p99 TTFT,
   failover rate, the routed-prefix hit-rate floor, replica load
   imbalance, and replicas down. Firing alerts embed the worst
   ``sutro_fleet_route_seconds`` exemplar trace ids — each one is a
   router trace id, i.e. directly stitchable via ``GET /trace/{id}``.

Overhead discipline: every public entry point early-returns when
``telemetry.ENABLED`` is off — zero allocations, zero network.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import telemetry
from ..telemetry import doctor
from ..telemetry.monitor import (
    Monitor,
    SLORule,
    percentile_from_buckets,
)
from ..telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    snapshot_delta,
)
from ..telemetry.traces import TraceStore
from . import frames
from .membership import CLOSED

logger = logging.getLogger(__name__)

#: pseudo-replica id under which federated counters/histograms are
#: accumulated a second time — its series ARE the fleet-wide aggregate
FLEET_AGG = "_fleet"

#: metric names the monitor windows over
_TTFT = "sutro_interactive_ttft_seconds"
_ROUTE = "sutro_fleet_route_seconds"

_EMPTY_SNAP: Dict[str, List] = {"counters": [], "hists": [], "gauges": []}


def mirror_registry(src: MetricsRegistry) -> MetricsRegistry:
    """A fresh registry with every metric of ``src`` re-declared (same
    name/help/labels/unit/buckets) but NO values and federation label
    ``replica``. The router federates replica snapshots into the copy,
    so the global process registry (shared with in-process replicas in
    tests) is never polluted with fleet series."""
    reg = MetricsRegistry(federation_label="replica")
    with src._lock:
        metrics = list(src._metrics.values())
    for m in metrics:
        if isinstance(m, Histogram):
            reg.histogram(m.name, m.help, labels=m.label_names,
                          unit=m.unit, max_series=m.max_series,
                          buckets=m.buckets)
        elif isinstance(m, Gauge):
            reg.gauge(m.name, m.help, labels=m.label_names,
                      unit=m.unit, max_series=m.max_series)
        elif isinstance(m, Counter):
            reg.counter(m.name, m.help, labels=m.label_names,
                        unit=m.unit, max_series=m.max_series)
    return reg


class FleetObservability:
    """Router-side trace ring + federated registry + trace stitcher.

    Thread-safety: the trace ring and registry are internally safe;
    the scrape cache takes its own small lock so concurrent /metrics
    readers collapse into one upstream sweep per interval.
    """

    #: default scrape cadence — aligned with the health prober's
    #: steady-state probe interval so federation lag tracks membership
    DEFAULT_SCRAPE_INTERVAL_S = 1.0

    def __init__(
        self,
        *,
        scrape_interval_s: float = DEFAULT_SCRAPE_INTERVAL_S,
        scrape_timeout: float = 2.0,
        send=frames._send,
        trace_capacity: Optional[int] = None,
    ) -> None:
        self.scrape_interval_s = float(scrape_interval_s)
        self.scrape_timeout = float(scrape_timeout)
        self._send = send
        self.registry = mirror_registry(telemetry.REGISTRY)
        self.traces = TraceStore(
            **({"capacity": trace_capacity} if trace_capacity else {})
        )
        self._seq = itertools.count(1)
        self._scrape_lock = threading.Lock()
        self._last_scrape = 0.0
        # rid -> last cumulative export_snapshot (delta base)
        self._prev: Dict[str, Dict[str, List]] = {}

    # -- router trace ring ---------------------------------------------

    def trace_begin(
        self,
        kind: str,
        attrs: Optional[Dict[str, Any]] = None,
        *,
        t0_mono: Optional[float] = None,
        created_unix: Optional[float] = None,
    ) -> Optional[str]:
        """Open a router trace; returns its id (``tr-fr-<n>``) or None
        when telemetry is off. graftlint's ``trace-ctx-dropped`` fleet
        pass anchors on this name: a handler that binds the returned id
        and talks upstream must forward it (``trace_id=`` /
        ``X-Sutro-Trace``), or the cross-process stitch silently loses
        the replica half."""
        if not telemetry.ENABLED:
            return None
        tid = "tr-fr-%d" % next(self._seq)
        self.traces.start_trace(
            tid, kind, attrs,
            **{
                k: v
                for k, v in (
                    ("t0_mono", t0_mono), ("created_unix", created_unix)
                )
                if v is not None
            },
        )
        return tid

    def span(
        self, tid: Optional[str], name: str, t0_mono: float,
        dur_s: float, attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        if tid is not None:
            self.traces.add(tid, name, t0_mono, dur_s, attrs)

    def event(
        self, tid: Optional[str], name: str,
        attrs: Optional[Dict[str, Any]] = None,
        t_mono: Optional[float] = None,
    ) -> None:
        if tid is not None:
            self.traces.event(tid, name, attrs=attrs, t_mono=t_mono)

    def annotate(self, tid: Optional[str], attrs: Dict[str, Any]) -> None:
        """Attach routing facts (picked replica, its url) to the trace
        — the stitcher reads ``replica_url`` back to fetch the far
        half of the timeline."""
        if tid is None:
            return
        tr = self.traces.get(tid)
        if tr is not None:
            tr.attrs.update(attrs)

    def end(self, tid: Optional[str], outcome: str = "ok") -> None:
        if tid is not None:
            self.traces.end_trace(tid, outcome)

    def has_trace(self, tid: str) -> bool:
        return self.traces.get(tid) is not None

    # -- route latency + gauges ----------------------------------------

    def observe_route(
        self, dur_s: float, kind: str, trace_id: Optional[str] = None
    ) -> None:
        """Record one routing decision's latency into BOTH registries:
        the process-global one (so a bare replica-style /metrics still
        shows it) and the federated copy (so it renders next to the
        per-replica series with its exemplar intact)."""
        if not telemetry.ENABLED:
            return
        telemetry.FLEET_ROUTE_SECONDS.observe(
            dur_s, kind, exemplar=trace_id
        )
        m = self.registry._metrics.get(_ROUTE)
        if isinstance(m, Histogram):
            m.observe(dur_s, kind, exemplar=trace_id)

    def route_latency_summary(self) -> Optional[Dict[str, Any]]:
        """Cumulative p50/p99/count of the router's own
        ``sutro_fleet_route_seconds`` series (all kinds merged) — the
        ``/fleet`` snapshot's at-a-glance routing-latency line."""
        m = self.registry._metrics.get(_ROUTE)
        if not isinstance(m, Histogram):
            return None
        agg = self.registry._aggregate()
        accs = [
            list(acc) for (n, _lv), acc in agg.hists.items() if n == _ROUTE
        ]
        if not accs:
            return None
        total = accs[0]
        for acc in accs[1:]:
            for i, v in enumerate(acc):
                if i < len(total):
                    total[i] += v
        if total[-1] <= 0:
            return None
        p50 = percentile_from_buckets(m.buckets, total, 0.50)
        p99 = percentile_from_buckets(m.buckets, total, 0.99)
        return {
            "p50_s": round(p50, 6) if p50 is not None else None,
            "p99_s": round(p99, 6) if p99 is not None else None,
            "count": int(total[-1]),
        }

    def refresh_router_gauges(self, snap: Dict[str, Any]) -> None:
        """Project the membership census into the federated registry's
        ``sutro_fleet_replicas`` copy — same state classification as
        health._export_gauges, so the /metrics string a fleet test pins
        (``sutro_fleet_replicas{state="healthy"} 2``) is identical
        whether it scrapes a replica or the router."""
        if not telemetry.ENABLED:
            return
        g = self.registry._metrics.get("sutro_fleet_replicas")
        if not isinstance(g, Gauge):
            return
        counts = {
            "healthy": snap.get("n_healthy", 0),
            "draining": snap.get("n_draining", 0),
            "open": 0,
            "half_open": 0,
        }
        for row in snap.get("replicas", ()):
            state = row.get("state")
            if state != CLOSED and state in counts:
                counts[state] += 1
        for state in ("healthy", "open", "half_open", "draining"):
            g.set(float(counts[state]), state)

    # -- federation -----------------------------------------------------

    def federate(self, membership, now: Optional[float] = None) -> int:
        """Scrape every routable obs-capable replica's registry
        snapshot and fold the per-scrape delta into the federated
        registry (per-replica series + the ``_fleet`` aggregate).
        Cached: at most one upstream sweep per ``scrape_interval_s``
        regardless of how hot /metrics is curled. Returns the number of
        replicas scraped this call (0 on a cache hit or telemetry
        off)."""
        if not telemetry.ENABLED:
            return 0
        now = time.monotonic() if now is None else now
        with self._scrape_lock:
            if now - self._last_scrape < self.scrape_interval_s:
                return 0
            self._last_scrape = now
        n = 0
        for row in membership.all():
            if row.get("state") != CLOSED or not row.get("fleet_obs"):
                continue
            rid, url = row["rid"], row["url"]
            try:
                raw = self._send(
                    "get", url + "/metrics-snapshot",
                    timeout=self.scrape_timeout,
                )
            except OSError as e:
                logger.debug("metrics scrape of %s failed: %s", rid, e)
                continue
            parsed = frames.parse_metrics_snapshot(raw)
            if parsed is None:
                # old replica answered something else (404 body) —
                # degrade: membership will flip fleet_obs on its next
                # probe, this scrape just skips
                continue
            cur = parsed["snapshot"]
            delta = snapshot_delta(
                self._prev.get(rid, _EMPTY_SNAP), cur
            )
            # gauges are NOT federated: a replica gauge is a statement
            # about that process's now, and summing (or relabeling) it
            # would also flip the router's own census gauges into
            # federated rendering — the /metrics strings tests pin
            # (sutro_fleet_replicas{state="healthy"} N) stay exact
            shard = {
                "counters": delta["counters"],
                "hists": delta["hists"],
                "gauges": [],
            }
            self.registry.ingest_remote(rid, shard)
            # the _fleet pseudo-replica accumulates the same deltas a
            # second time — its series ARE the fleet-wide aggregate
            self.registry.ingest_remote(FLEET_AGG, shard)
            self._prev[rid] = cur
            n += 1
        return n

    # -- cross-process stitch ------------------------------------------

    def stitch_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Join the router's trace with the picked replica's half
        (``GET /trace-doc/{id}``) into one multi-process document:
        ``{version, trace_id, kind: "fleet", processes: [...]}`` where
        each process entry carries its raw trace doc plus ``t_off_s``,
        the wall-clock re-anchor onto the ROUTER's timeline (clamped at
        0 so clock skew can never push a replica span before the
        request arrived). Degrades to router-spans-only when the
        replica is gone, evicted the trace, or predates the obs
        protocol."""
        tr = self.traces.get(trace_id)
        if tr is None:
            return None
        rdoc = tr.to_doc()
        processes: List[Dict[str, Any]] = [
            {
                "process": "router",
                "role": "router",
                "doc": rdoc,
                "t_off_s": 0.0,
            }
        ]
        url = tr.attrs.get("replica_url")
        rid = tr.attrs.get("replica", "?")
        if url:
            try:
                raw = self._send(
                    "get", "%s/trace-doc/%s" % (url, trace_id),
                    timeout=self.scrape_timeout,
                )
            except OSError as e:
                logger.debug(
                    "trace-doc fetch for %s from %s failed: %s",
                    trace_id, rid, e,
                )
                raw = None
            parsed = frames.parse_trace_doc(raw) if raw is not None else None
            if parsed is not None:
                pdoc = parsed["doc"]
                t_off = max(
                    0.0,
                    float(pdoc.get("created_unix") or 0.0)
                    - float(rdoc.get("created_unix") or 0.0),
                )
                processes.append(
                    {
                        "process": "replica %s" % rid,
                        "doc": pdoc,
                        "t_off_s": round(t_off, 6),
                    }
                )
        return {
            "version": 1,
            "trace_id": trace_id,
            "kind": "fleet",
            "processes": processes,
        }


# ---------------------------------------------------------------------------
# fleet SLO rules + monitor
# ---------------------------------------------------------------------------

#: stock fleet-level SLO clauses (OBSERVABILITY.md "Fleet
#: observability"). Metric keys resolve in FleetMonitor's per-tick
#: stats document; thresholds mirror the engine-level rules where a
#: counterpart exists (fleet_ttft_p99 == interactive_ttft_p99).
FLEET_RULES: Tuple[SLORule, ...] = (
    SLORule(
        "fleet_ttft_p99", metric="fleet_ttft_p99_s", op=">",
        threshold=5.0, clear=2.5, workload="fleet",
        severity="critical",
    ),
    SLORule(
        "fleet_failover_rate", metric="failovers_per_s", op=">",
        threshold=0.5, clear=0.1, workload="fleet",
    ),
    SLORule(
        "fleet_prefix_hit_floor", metric="routed_prefix_hit_rate",
        op="<", threshold=0.05, clear=0.2, for_ticks=3,
        workload="fleet",
    ),
    SLORule(
        "fleet_replica_imbalance", metric="replica_imbalance", op=">",
        threshold=4.0, clear=2.0, for_ticks=3, workload="fleet",
    ),
    SLORule(
        "fleet_replicas_down", metric="n_unhealthy", op=">",
        threshold=0.0, clear=0.0, workload="fleet",
        severity="critical",
    ),
)


class FleetMonitor(Monitor):
    """The engine Monitor's sampler/rule/stream machinery pointed at
    the fleet: each tick federates (cache-bounded), samples router
    counters + the ``_fleet`` TTFT window + route latency + membership,
    windows the ring, advances :data:`FLEET_RULES`, and publishes the
    fleet doctor's verdict. ``GET /fleet-monitor`` serves
    :meth:`snapshot_doc`, ``GET /fleet-monitor/stream`` serves
    :meth:`stream` — both inherited unchanged.

    The base class's degrade contract carries over: a tick error (real
    or injected at fault site ``telemetry.monitor``) disables the
    monitor, it never takes the router down."""

    def __init__(
        self,
        router,
        *,
        interval_s: Optional[float] = None,
        window_s: Optional[float] = None,
        history: Optional[int] = None,
        rules: Optional[Tuple[SLORule, ...]] = None,
    ) -> None:
        super().__init__(
            interval_s=interval_s,
            window_s=window_s,
            history=history,
            rules=list(rules if rules is not None else FLEET_RULES),
            jobs_provider=None,
            alert_dump=None,
        )
        self.router = router
        self.obs: FleetObservability = router.obs

    # -- sampling ------------------------------------------------------

    def _hist_acc(
        self, name: str, remote: bool
    ) -> Optional[List[float]]:
        """One summed accumulator for ``name`` across label tuples —
        from the federated ``_fleet`` shard (``remote``) or the
        registry's own local shards (router-side series)."""
        reg = self.obs.registry
        if remote:
            with reg._lock:
                shard = reg._remote.get(FLEET_AGG) or {}
                items = [
                    list(acc)
                    for (n, _lv), acc in shard.get("hists", {}).items()
                    if n == name
                ]
        else:
            agg = reg._aggregate()
            items = [
                list(acc) for (n, _lv), acc in agg.hists.items()
                if n == name
            ]
        if not items:
            return None
        out = items[0]
        for acc in items[1:]:
            for i, v in enumerate(acc):
                if i < len(out):
                    out[i] += v
        return out

    def _sample(self) -> Dict[str, Any]:
        snap = self.router.membership.snapshot()
        loads = [
            row.get("load", 0)
            for row in snap.get("replicas", ())
            if row.get("state") == CLOSED
            and row.get("ready")
            and not row.get("draining")
        ]
        return {
            "counters": dict(self.router.counters),
            "ttft_acc": self._hist_acc(_TTFT, remote=True),
            "route_acc": self._hist_acc(_ROUTE, remote=False),
            "membership": {
                "n_replicas": snap.get("n_replicas", 0),
                "n_healthy": snap.get("n_healthy", 0),
                "n_draining": snap.get("n_draining", 0),
                "loads": loads,
                "snapshot": snap,
            },
        }

    def tick(self) -> None:
        """One fleet sample; same skeleton as Monitor.tick minus the
        per-job doctor (the fleet doctor grades the membership snapshot
        instead). Raises propagate to the inherited loop's degrade
        handler."""
        from ..engine import faults

        if faults.ACTIVE is not None:
            faults.inject("telemetry.monitor")
        now_mono = time.monotonic()
        now_unix = time.time()
        self.obs.federate(self.router.membership)
        sample = self._sample()
        self._ring.append((now_mono, now_unix, sample))
        stats = self._window_stats()
        with self._lock:
            transitions = self._evaluate_rules(stats, now_unix)
            if transitions:
                self._events.extend(transitions)
                self._events_seen += len(transitions)
            firing = [
                name
                for name, s in self._rule_state.items()
                if s.state == "firing"
            ]
        fleet_doc = dict(sample["membership"]["snapshot"])
        fleet_doc["failovers"] = {
            k.replace("failover_", ""): v
            for k, v in sample["counters"].items()
            if k.startswith("failover_")
        }
        verdicts = {
            "fleet": dict(
                doctor.diagnose_fleet(fleet_doc), in_flight=True
            )
        }
        trail_entry = {
            "unix": round(now_unix, 3),
            "rates": stats.get("rates", {}),
            "gauges": stats.get("gauges", {}),
            "percentiles": stats.get("percentiles", {}),
            "alerts_firing": len(firing),
        }
        with self._lock:
            self._stats = stats
            self._verdicts = verdicts
            self._trail.append(trail_entry)
            self._ticks += 1
            self._seq += 1
        with self._wake:
            self._wake.notify_all()
        hook = self.on_tick
        if hook is not None:
            try:
                hook(stats, transitions, verdicts, firing)
            except Exception:  # noqa: BLE001 — consumer crash must not
                # take the sampler down (same backstop as the base)
                logger.warning(
                    "fleet monitor on_tick hook failed — unhooking",
                    exc_info=True,
                )
                self.on_tick = None

    # -- windowing -----------------------------------------------------

    @staticmethod
    def _acc_delta(
        base: Optional[List[float]], head: Optional[List[float]]
    ) -> Optional[List[float]]:
        if head is None:
            return None
        if base is None or len(base) != len(head):
            return list(head)
        return [x - y for x, y in zip(head, base)]

    def _window_stats(self) -> Dict[str, Any]:
        edges = self._window_edges()
        head = self._ring[-1]
        mem = head[2]["membership"]
        n_replicas = mem["n_replicas"]
        n_healthy = mem["n_healthy"]
        stats: Dict[str, Any] = {
            "window_s": 0.0,
            "rates": {},
            "percentiles": {},
            "gauges": {
                "n_replicas": n_replicas,
                "n_healthy": n_healthy,
                "n_draining": mem["n_draining"],
            },
            "tenants": {},
        }
        # census-derived metrics are live regardless of traffic: a
        # fleet with a dead replica pages even when idle
        if n_replicas > 0:
            stats["n_unhealthy"] = float(n_replicas - n_healthy)
        loads = mem["loads"]
        if len(loads) >= 2:
            # ratio of busiest to least-busy routable replica; the
            # max(1, ...) floor keeps an idle fleet at ratio ~busiest
            # instead of dividing by zero
            stats["replica_imbalance"] = round(
                max(loads) / max(1.0, float(min(loads))), 4
            )
        if edges is None:
            return stats
        base, head = edges
        dt = max(head[0] - base[0], 1e-6)
        stats["window_s"] = round(dt, 3)
        bc, hc = base[2]["counters"], head[2]["counters"]

        def delta(key: str) -> float:
            return max(0.0, hc.get(key, 0) - bc.get(key, 0))

        failovers = (
            delta("failover_batch")
            + delta("failover_interactive")
            + delta("failover_stream_error")
        )
        routed = delta("interactive_routed")
        rates = {
            "routed_per_s": round(
                (routed + delta("batch_routed")) / dt, 4
            ),
            "failovers_per_s": round(failovers / dt, 4),
        }
        stats["rates"] = rates
        stats["failovers_per_s"] = rates["failovers_per_s"]
        if routed > 0:
            stats["routed_prefix_hit_rate"] = round(
                delta("prefix_hits") / routed, 4
            )
        pcts: Dict[str, Any] = {}

        def grade(name: str, key: str) -> Optional[Dict[str, Any]]:
            m = self.obs.registry._metrics.get(name)
            acc = self._acc_delta(base[2].get(key), head[2].get(key))
            if not isinstance(m, Histogram) or acc is None:
                return None
            if acc[-1] <= 0:
                return None
            p50 = percentile_from_buckets(m.buckets, acc, 0.50)
            p99 = percentile_from_buckets(m.buckets, acc, 0.99)
            if p50 is None:
                return None
            return {
                "p50_s": round(p50, 6),
                "p99_s": round(p99, 6) if p99 is not None else None,
                "count": int(acc[-1]),
            }

        ttft = grade(_TTFT, "ttft_acc")
        if ttft:
            pcts["fleet_ttft"] = ttft
            stats["fleet_ttft_p50_s"] = ttft["p50_s"]
            stats["fleet_ttft_p99_s"] = ttft["p99_s"]
        route = grade(_ROUTE, "route_acc")
        if route:
            pcts["fleet_route"] = route
            stats["fleet_route_p99_s"] = route["p99_s"]
        stats["percentiles"] = pcts
        return stats

    # -- alert exemplars -----------------------------------------------

    def _exemplar_trace_ids(self, metric: str) -> List[str]:
        """Every fleet alert points at the worst route-latency exemplar
        trace ids (``_event`` in the base class calls this on firing)
        — router trace ids, so ``GET /trace/<id>`` on the router stitches the
        full cross-process timeline straight from the page."""
        out: List[str] = []
        for ex in self.obs.registry.exemplars(_ROUTE):
            tid = ex.get("trace_id")
            if tid and tid not in out:
                out.append(tid)
            if len(out) >= self._EXEMPLAR_TOP:
                break
        return out
