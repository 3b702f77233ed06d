"""Live SLO monitor: metrics history, alerts, streaming doctor verdicts.

The port of ``sutro_tpu/telemetry/monitor.py``, line for line but for
its imports (the port's registry, doctor and fault sites).

The registry (:mod:`.registry`) answers "what are the totals NOW"; the
doctor (:mod:`.doctor`) answers "why was that job slow" AFTER it ends.
This module closes the gap in between: a low-overhead sampler thread
that periodically snapshots the registry via the existing federation
machinery (:meth:`MetricsRegistry.export_snapshot` /
:func:`snapshot_delta`) into a bounded ring of timestamped snapshots —
a real time series — and derives from it, every tick:

1. **Windowed rates and percentiles.** Counter deltas over the sliding
   window become rates (rows/s, tokens/s, quarantines/s, failure
   events/s); histogram deltas become windowed p50/p99 via bucket
   interpolation (interactive TTFT/ITL and every engine stage). The
   window sees only what moved INSIDE it, so a throughput collapse at
   row 5k of a 20k-row job shows up seconds later, not at finalize.
2. **Declarative SLO rules** per workload class (interactive TTFT/ITL,
   batch rows/s, quarantine rate, dp fleet size) evaluated with
   hysteresis (separate breach and clear levels) + debounce
   (consecutive-tick streaks) into structured alert events with a
   pending → firing → resolved lifecycle. An alert FIRING dumps the
   flight recorder next to every running job, exactly like a FAILED
   job does — the postmortem artifact exists while the incident is
   still live.
3. **Continuous doctor.** The bottleneck doctor re-runs over the
   flight recorder's sliding span window for every RUNNING job, so
   verdicts (``decode_below_roofline``, ``host_bound_admit``,
   ``interactive_starved``, ...) stream mid-job instead of post-mortem
   (each carries ``in_flight: true``).

Surfaces: ``GET /monitor`` (one consolidated document) and NDJSON
``GET /monitor/stream`` on the daemon (server.py) and
``sdk.get_monitor``.

Overhead discipline: the monitor is constructed only when telemetry is
enabled AND ``SUTRO_MONITOR`` != 0, and its loop re-checks the package
``ENABLED`` switch every tick — with telemetry off the thread does one
attribute load + truth test per interval and NOTHING else. A tick never writes registry series except on alert state transitions,
so it cannot perturb the <2% telemetry budget it is measured under.
Fault site ``telemetry.monitor`` (engine/faults.py) covers the tick:
any injected raise degrades the monitor to disabled — a broken monitor
must never fail a job.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .registry import snapshot_delta

logger = logging.getLogger(__name__)

MONITOR_VERSION = 1

#: default sampler cadence / sliding-window span / ring depth
DEFAULT_INTERVAL_S = 1.0
DEFAULT_WINDOW_S = 30.0
DEFAULT_HISTORY = 120

#: alert/event logs kept (oldest dropped first) — an incident trail,
#: not a metrics store, same bounding rationale as failure_log[]
EVENT_CAP = 128


def monitor_enabled() -> bool:
    """The monitor's own switch, subordinate to ``SUTRO_TELEMETRY``:
    the engine constructs a Monitor only when BOTH are on."""
    return os.environ.get("SUTRO_MONITOR", "1").lower() not in (
        "0", "false", "off",
    )


# ---------------------------------------------------------------------------
# SLO rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SLORule:
    """One declarative SLO clause (OBSERVABILITY.md "Live monitor").

    ``metric`` names a key of the per-tick window-stats document;
    a tick where the key is absent/None leaves the rule dormant (its
    streaks reset — a rule cannot fire on a workload that is not
    running). Breach is ``value <op> threshold``; hysteresis: once
    firing, the rule only starts resolving when the value clears the
    SEPARATE ``clear`` level (default: the threshold itself), so
    flapping at the threshold cannot produce fire/resolve churn;
    debounce: ``for_ticks`` consecutive breaching ticks arm
    pending → firing, ``clear_ticks`` consecutive cleared ticks
    resolve."""

    name: str
    metric: str
    op: str = ">"                       # ">" or "<"
    threshold: float = 0.0
    clear: Optional[float] = None       # hysteresis level (default: threshold)
    for_ticks: int = 2
    clear_ticks: int = 2
    workload: str = ""                  # interactive | batch | dp | engine
    severity: str = "warning"

    def breached(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" else value < self.threshold

    def cleared(self, value: float) -> bool:
        lvl = self.threshold if self.clear is None else self.clear
        return value <= lvl if self.op == ">" else value >= lvl

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: the stock rule set — per workload class, as the ROADMAP's SLO
#: control plane names them. Thresholds mirror the engine's existing
#: constants where one exists (STARVED_TTFT_S for interactive TTFT).
DEFAULT_RULES: Tuple[SLORule, ...] = (
    SLORule(
        "interactive_ttft_p99", metric="ttft_p99_s", op=">",
        threshold=5.0, clear=2.5, workload="interactive",
        severity="critical",
    ),
    SLORule(
        "interactive_itl_p99", metric="itl_p99_s", op=">",
        threshold=1.0, clear=0.5, workload="interactive",
    ),
    SLORule(
        "batch_rows_stalled", metric="batch_rows_per_s", op="<",
        threshold=0.1, clear=0.5, for_ticks=3, clear_ticks=2,
        workload="batch",
    ),
    SLORule(
        "quarantine_rate", metric="quarantine_rate", op=">",
        threshold=0.05, clear=0.01, workload="batch",
    ),
    SLORule(
        "dp_fleet_shrunk", metric="dp_fleet_size", op="<",
        threshold=1.0, clear=1.0, workload="dp", severity="critical",
    ),
)


class _RuleState:
    """Per-rule evaluation state (sampler thread only)."""

    __slots__ = ("state", "breach_streak", "clear_streak", "fired_unix",
                 "value")

    def __init__(self) -> None:
        self.state = "ok"          # ok | pending | firing
        self.breach_streak = 0
        self.clear_streak = 0
        self.fired_unix: Optional[float] = None
        self.value: Optional[float] = None


# ---------------------------------------------------------------------------
# windowed percentile over histogram bucket deltas
# ---------------------------------------------------------------------------


def percentile_from_buckets(
    buckets: Sequence[float], acc: Sequence[float], q: float
) -> Optional[float]:
    """Linear-interpolated q-quantile from one histogram accumulator
    (layout ``[b0..bn, +Inf, sum, count]`` — registry.Histogram).
    None when the accumulator is empty. Values in the +Inf bucket clamp
    to the top finite boundary (the honest answer a bounded histogram
    can give; tests compare against brute force WITHIN bucket
    resolution)."""
    count = acc[-1]
    if count <= 0:
        return None
    target = q * count
    cum = 0.0
    lo = 0.0
    for i, le in enumerate(buckets):
        c = acc[i]
        if c > 0 and cum + c >= target:
            frac = (target - cum) / c
            return lo + (le - lo) * min(max(frac, 0.0), 1.0)
        cum += c
        lo = le
    return float(buckets[-1]) if buckets else None


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


class Monitor:
    """Background sampler + SLO evaluator + continuous doctor.

    Constructor wires, never imports: the engine passes callables so
    this module stays importable (and unit-testable) without an engine.

    - ``jobs_provider() -> [(job_id, status), ...]`` — the RUNNING jobs
      the continuous doctor diagnoses each tick;
    - ``alert_dump(job_id, alert) -> None`` — invoked once per firing
      alert per running job (the engine dumps the flight recorder next
      to the job, like FAILED already does). Best-effort: a dump error
      is logged and swallowed.
    """

    def __init__(
        self,
        *,
        interval_s: Optional[float] = None,
        window_s: Optional[float] = None,
        history: Optional[int] = None,
        rules: Optional[Sequence[SLORule]] = None,
        jobs_provider: Optional[Callable[[], List[Tuple[str, str]]]] = None,
        alert_dump: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    ) -> None:
        env = os.environ
        self.interval_s = float(
            interval_s
            if interval_s is not None
            else env.get("SUTRO_MONITOR_INTERVAL", DEFAULT_INTERVAL_S)
        )
        self.window_s = float(
            window_s
            if window_s is not None
            else env.get("SUTRO_MONITOR_WINDOW", DEFAULT_WINDOW_S)
        )
        self.history = int(
            history
            if history is not None
            else env.get("SUTRO_MONITOR_HISTORY", DEFAULT_HISTORY)
        )
        self._rules = list(rules if rules is not None else DEFAULT_RULES)
        self._rule_state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self._rules
        }
        self._jobs_provider = jobs_provider
        self._alert_dump = alert_dump
        # ring of (monotonic_ts, unix_ts, export_snapshot()) — the time
        # series every window computation subtracts across
        self._ring: deque = deque(maxlen=max(self.history, 2))
        self._events: deque = deque(maxlen=EVENT_CAP)
        # monotonic count of events ever appended to ``_events`` — the
        # deque drops old entries at EVENT_CAP, so stream cursors track
        # this counter instead of indexing into the ring
        self._events_seen = 0
        self._trail: deque = deque(maxlen=max(self.history, 2))
        self._verdicts: Dict[str, Dict[str, Any]] = {}
        self._stats: Dict[str, Any] = {}
        self._ticks = 0
        self._seq = 0  # stream cursor: bumps once per completed tick
        self._started_unix = time.time()
        self._failed: Optional[str] = None
        self._stop = threading.Event()
        self._wake = threading.Condition()
        self._lock = threading.Lock()  # guards published state
        self._thread: Optional[threading.Thread] = None
        # per-tick consumer hook (the control-plane autotuner): called
        # after each published tick with (stats, transitions, verdicts,
        # firing_rule_names). A hook crash unhooks it — the sampler
        # itself never degrades on a consumer's behalf.
        self.on_tick: Optional[
            Callable[
                [Dict[str, Any], List[Dict[str, Any]],
                 Optional[Dict[str, Dict[str, Any]]], List[str]],
                None,
            ]
        ] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Monitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="sutro-monitor"
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and self.failed is None

    @property
    def failed(self) -> Optional[str]:
        """The degradation reason once the sampler has given up (an
        injected or real tick error), else None."""
        with self._lock:
            return self._failed

    def set_rules(self, rules: Sequence[SLORule]) -> None:
        """Swap the rule set (tests / operator reconfiguration). Resets
        evaluation state — in-flight alerts resolve administratively."""
        with self._lock:
            self._rules = list(rules)
            self._rule_state = {r.name: _RuleState() for r in self._rules}

    # -- sampler loop --------------------------------------------------

    def _loop(self) -> None:
        from . import ENABLED as _unused  # noqa: F401 — import check only

        while not self._stop.is_set():
            from . import ENABLED

            if ENABLED:
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — the monitor
                    # degrades to disabled, it never takes a job down
                    with self._lock:
                        self._failed = f"{type(e).__name__}: {e}"
                    logger.warning(
                        "monitor sampler failed — degrading to "
                        "disabled: %s", e, exc_info=True,
                    )
                    with self._wake:
                        self._wake.notify_all()
                    return
            self._stop.wait(self.interval_s)

    def tick(self) -> None:
        """One sample: snapshot → window stats → rules → doctor. Public
        for tests and the op-census leg; the loop is just this on a
        timer. Raises propagate to the loop's degrade handler."""
        from . import REGISTRY
        from ..engine import faults

        if faults.ACTIVE is not None:
            faults.inject("telemetry.monitor")
        now_mono = time.monotonic()
        now_unix = time.time()
        snap = REGISTRY.export_snapshot()
        self._ring.append((now_mono, now_unix, snap))
        stats = self._window_stats()
        # rule state is shared with set_rules / snapshot_doc / stream:
        # advance the state machines and publish their transition events
        # under the same lock those readers take
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
        verdicts = self._run_doctor()
        trail_entry = {
            "unix": round(now_unix, 3),
            "rates": stats.get("rates", {}),
            "gauges": stats.get("gauges", {}),
            "percentiles": stats.get("percentiles", {}),
            "alerts_firing": len(firing),
        }
        with self._lock:
            self._stats = stats
            if verdicts is not None:
                self._verdicts = verdicts
            self._trail.append(trail_entry)
            self._ticks += 1
            self._seq += 1
        with self._wake:
            self._wake.notify_all()
        # alert dumps OUTSIDE the lock: filesystem work must not block
        # /monitor readers
        for ev in transitions:
            if ev["state"] == "firing":
                self._dump_for_alert(ev)
        hook = self.on_tick
        if hook is not None:
            try:
                hook(stats, transitions, verdicts, firing)
            except Exception:  # noqa: BLE001 — a consumer crash must
                # not take the sampler down; the control plane has its
                # own degrade path, this is the backstop
                logger.warning(
                    "monitor on_tick hook failed — unhooking",
                    exc_info=True,
                )
                self.on_tick = None

    # -- window statistics ---------------------------------------------

    def _window_edges(self) -> Optional[Tuple[Tuple, Tuple]]:
        """(base, head) ring entries spanning the sliding window: head
        is the newest sample, base the oldest one still inside
        ``window_s`` (so the delta covers at most the window)."""
        if len(self._ring) < 2:
            return None
        head = self._ring[-1]
        cutoff = head[0] - self.window_s
        base = None
        for entry in self._ring:
            if entry[0] >= cutoff:
                base = entry
                break
        if base is None or base is head:
            base = self._ring[-2]
        return base, head

    @staticmethod
    def _counter_total(
        delta: Dict[str, List], name: str,
        label_filter: Optional[Callable[[List[str]], bool]] = None,
    ) -> float:
        return sum(
            v
            for n, lv, v in delta.get("counters") or ()
            if n == name and (label_filter is None or label_filter(lv))
        )

    def _hist_windows(
        self, delta: Dict[str, List]
    ) -> Dict[Tuple[str, Tuple[str, ...]], List[float]]:
        return {
            (n, tuple(lv)): acc
            for n, lv, acc in delta.get("hists") or ()
        }

    def _window_stats(self) -> Dict[str, Any]:
        """Derive the per-tick stats document from the ring. Keys here
        are the namespace SLO rules' ``metric`` fields resolve in."""
        from . import REGISTRY

        edges = self._window_edges()
        head = self._ring[-1]
        gauges = {
            n: (v if not lv else None)
            for n, lv, v in head[2].get("gauges") or ()
            if not lv
        }
        labeled_gauges: Dict[str, Dict[str, float]] = {}
        for n, lv, v in head[2].get("gauges") or ():
            if lv:
                labeled_gauges.setdefault(n, {})[",".join(lv)] = v
        stats: Dict[str, Any] = {
            "window_s": 0.0,
            "rates": {},
            "percentiles": {},
            "gauges": {},
            "tenants": {},
        }
        jobs_running = gauges.get("sutro_jobs_running")
        dp_fleet = gauges.get("sutro_dp_fleet_size")
        interactive_active = gauges.get("sutro_interactive_active")
        g: Dict[str, Any] = {}
        if jobs_running is not None:
            g["jobs_running"] = jobs_running
        if dp_fleet is not None:
            g["dp_fleet_size"] = dp_fleet
            # the rule is dormant until a dp round has reported a fleet
            if dp_fleet > 0 or (jobs_running or 0) > 0:
                stats["dp_fleet_size"] = dp_fleet
        if interactive_active is not None:
            g["interactive_active"] = interactive_active
        rps = labeled_gauges.get("sutro_rows_per_second") or {}
        if rps:
            g["rows_per_second"] = rps
        stats["gauges"] = g

        # tenant attribution: cumulative totals from the head snapshot
        # (tenant,outcome) / (tenant,direction) counters
        tenants: Dict[str, Dict[str, float]] = {}
        for n, lv, v in head[2].get("counters") or ():
            if n == "sutro_tenant_rows_total" and len(lv) == 2:
                t = tenants.setdefault(lv[0], {})
                t[f"rows_{lv[1]}"] = t.get(f"rows_{lv[1]}", 0.0) + v
            elif n == "sutro_tenant_tokens_total" and len(lv) == 2:
                t = tenants.setdefault(lv[0], {})
                t[f"tokens_{lv[1]}"] = t.get(f"tokens_{lv[1]}", 0.0) + v
            elif n == "sutro_tenant_requests_total" and len(lv) == 2:
                t = tenants.setdefault(lv[0], {})
                t[f"requests_{lv[1]}"] = (
                    t.get(f"requests_{lv[1]}", 0.0) + v
                )
        stats["tenants"] = tenants

        if edges is None:
            return stats
        base, head = edges
        dt = max(head[0] - base[0], 1e-6)
        delta = snapshot_delta(base[2], head[2])
        stats["window_s"] = round(dt, 3)

        rows = self._counter_total(delta, "sutro_rows_total")
        quarantined = self._counter_total(
            delta, "sutro_rows_total", lambda lv: lv[:1] == ["quarantined"]
        )
        tokens = self._counter_total(delta, "sutro_tokens_total")
        failures = self._counter_total(
            delta, "sutro_failure_events_total"
        )
        rates = {
            "rows_per_s": round(rows / dt, 4),
            "tokens_per_s": round(tokens / dt, 2),
            "quarantined_per_s": round(quarantined / dt, 4),
            "failure_events_per_s": round(failures / dt, 4),
        }
        stats["rates"] = rates
        if rows > 0:
            stats["quarantine_rate"] = round(quarantined / rows, 4)
        elif quarantined > 0:
            stats["quarantine_rate"] = 1.0
        # batch throughput only judged while batch jobs run — an idle
        # engine must not page anyone about 0 rows/s
        if (jobs_running or 0) > 0:
            stats["batch_rows_per_s"] = rates["rows_per_s"]

        # windowed percentiles from histogram deltas
        hists = self._hist_windows(delta)
        pcts: Dict[str, Any] = {}

        def grade(name: str, lv: Tuple[str, ...] = ()) -> Optional[Dict]:
            m = REGISTRY._metrics.get(name)
            acc = hists.get((name, lv))
            if m is None or acc is None:
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

        ttft = grade("sutro_interactive_ttft_seconds")
        if ttft:
            pcts["ttft"] = ttft
            stats["ttft_p50_s"] = ttft["p50_s"]
            stats["ttft_p99_s"] = ttft["p99_s"]
        itl = grade("sutro_interactive_itl_seconds")
        if itl:
            pcts["itl"] = itl
            stats["itl_p50_s"] = itl["p50_s"]
            stats["itl_p99_s"] = itl["p99_s"]
        stage_pcts: Dict[str, Any] = {}
        for (name, lv) in hists:
            if name == "sutro_stage_seconds" and len(lv) == 1:
                sg = grade(name, lv)
                if sg:
                    stage_pcts[lv[0]] = sg
        if stage_pcts:
            pcts["stages"] = stage_pcts
        stats["percentiles"] = pcts
        return stats

    # -- rule evaluation -----------------------------------------------

    def _lookup(self, stats: Dict[str, Any], metric: str) -> Optional[float]:
        v = stats.get(metric)
        if v is None:
            v = stats.get("rates", {}).get(metric)
        if v is None:
            v = stats.get("gauges", {}).get(metric)
        return float(v) if v is not None else None

    def _evaluate_rules(
        self, stats: Dict[str, Any], now_unix: float
    ) -> List[Dict[str, Any]]:
        """Advance every rule's hysteresis/debounce state machine one
        tick; returns the transition events for this tick. ``tick``
        calls this (and publishes the events) under ``self._lock``; the
        method itself must therefore never take the lock."""
        from . import ALERTS_TOTAL, ENABLED

        out: List[Dict[str, Any]] = []
        for rule in self._rules:
            st = self._rule_state[rule.name]
            value = self._lookup(stats, rule.metric)
            st.value = value
            if value is None:
                # dormant: the workload is not running — hold a firing
                # alert (no data is not evidence of recovery), disarm a
                # pending one
                st.breach_streak = 0
                if st.state == "pending":
                    st.state = "ok"
                continue
            if rule.breached(value):
                st.breach_streak += 1
                st.clear_streak = 0
                if st.state == "ok":
                    st.state = "pending"
                if (
                    st.state == "pending"
                    and st.breach_streak >= rule.for_ticks
                ):
                    st.state = "firing"
                    st.fired_unix = now_unix
                    ev = self._event(rule, "firing", value, now_unix)
                    out.append(ev)
                    if ENABLED:
                        ALERTS_TOTAL.inc(1.0, rule.name, "firing")
            elif rule.cleared(value):
                st.clear_streak += 1
                st.breach_streak = 0
                if st.state == "pending":
                    st.state = "ok"
                elif (
                    st.state == "firing"
                    and st.clear_streak >= rule.clear_ticks
                ):
                    st.state = "ok"
                    ev = self._event(rule, "resolved", value, now_unix)
                    ev["fired_unix"] = st.fired_unix
                    st.fired_unix = None
                    out.append(ev)
                    if ENABLED:
                        ALERTS_TOTAL.inc(1.0, rule.name, "resolved")
            else:
                # hysteresis band (between clear and threshold): hold
                # the current state, reset both streaks — flapping at
                # the threshold produces exactly one fire/resolve pair
                st.breach_streak = 0
                st.clear_streak = 0
        return out

    #: alert metric -> registry histogram carrying its exemplars; a
    #: firing alert embeds the worst captured trace ids so `sutro
    #: trace <id>` jumps straight from the page to the forensic trace
    _EXEMPLAR_SOURCE: Dict[str, str] = {
        "ttft_p99_s": "sutro_interactive_ttft_seconds",
        "itl_p99_s": "sutro_interactive_itl_seconds",
    }
    _EXEMPLAR_TOP = 3

    def _event(
        self, rule: SLORule, state: str, value: float, now_unix: float
    ) -> Dict[str, Any]:
        ev = {
            "rule": rule.name,
            "state": state,
            "severity": rule.severity,
            "workload": rule.workload,
            "metric": rule.metric,
            "op": rule.op,
            "threshold": rule.threshold,
            "value": round(value, 6),
            "unix": round(now_unix, 3),
        }
        if state == "firing":
            ids = self._exemplar_trace_ids(rule.metric)
            if ids:
                ev["exemplar_trace_ids"] = ids
        return ev

    def _exemplar_trace_ids(self, metric: str) -> List[str]:
        """Worst (highest-value) exemplar trace ids for the histogram
        backing ``metric``, deduplicated, worst first."""
        hist = self._EXEMPLAR_SOURCE.get(metric)
        if hist is None:
            return []
        from . import REGISTRY

        out: List[str] = []
        for ex in REGISTRY.exemplars(hist):
            tid = ex.get("trace_id")
            if tid and tid not in out:
                out.append(tid)
            if len(out) >= self._EXEMPLAR_TOP:
                break
        return out

    def _dump_for_alert(self, ev: Dict[str, Any]) -> None:
        """A firing alert persists the flight recorder next to every
        RUNNING job — the same artifact a FAILED job leaves, produced
        while the incident is live. Best-effort by contract."""
        if self._alert_dump is None or self._jobs_provider is None:
            return
        try:
            jobs = self._jobs_provider()
        except Exception:  # noqa: BLE001 — provider errors degrade
            logger.warning("monitor jobs_provider failed", exc_info=True)
            return
        for job_id, _status in jobs:
            try:
                self._alert_dump(job_id, ev)
            except Exception:  # noqa: BLE001 — dumps are best-effort
                logger.warning(
                    "alert dump failed for %s", job_id, exc_info=True
                )

    # -- continuous doctor ---------------------------------------------

    def _run_doctor(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """Diagnose every RUNNING job over the flight recorder's live
        span window. Returns the fresh verdict map, or None when there
        is no provider (unit-test monitors)."""
        if self._jobs_provider is None:
            return None
        from . import job_doc
        from .doctor import diagnose

        try:
            jobs = self._jobs_provider()
        except Exception:  # noqa: BLE001
            logger.warning("monitor jobs_provider failed", exc_info=True)
            return None
        out: Dict[str, Dict[str, Any]] = {}
        for job_id, status in jobs:
            try:
                diag = diagnose(
                    job_doc(job_id), status=status, in_flight=True
                )
                out[job_id] = {
                    "verdict": diag["verdict"],
                    "in_flight": True,
                    "partial": diag.get("partial", False),
                    "evidence": diag.get("evidence", [])[:4],
                    "spans": diag.get("totals", {}).get("spans", 0),
                }
            except Exception:  # noqa: BLE001 — one sick job must not
                # blind the monitor to the others
                logger.warning(
                    "live doctor failed for %s", job_id, exc_info=True
                )
        return out

    # -- published documents -------------------------------------------

    def snapshot_doc(self) -> Dict[str, Any]:
        """The ``GET /monitor`` payload (OBSERVABILITY.md schema)."""
        with self._lock:
            stats = dict(self._stats)
            events = list(self._events)
            trail = list(self._trail)
            verdicts = dict(self._verdicts)
            rule_view = [
                {
                    **r.to_dict(),
                    "state": self._rule_state[r.name].state,
                    "value": self._rule_state[r.name].value,
                    "fired_unix": self._rule_state[r.name].fired_unix,
                }
                for r in self._rules
            ]
            ticks = self._ticks
            failed = self._failed
        active = [r for r in rule_view if r["state"] == "firing"]
        t = self._thread
        return {
            "version": MONITOR_VERSION,
            "enabled": True,
            "running": t is not None and t.is_alive() and failed is None,
            "degraded": failed,
            "interval_s": self.interval_s,
            "window_s": self.window_s,
            "ticks": ticks,
            "started_unix": round(self._started_unix, 3),
            "stats": stats,
            "rules": rule_view,
            "alerts": {"active": active, "events": events},
            "verdicts": verdicts,
            "history": trail,
        }

    def stream(
        self, max_ticks: Optional[int] = None, timeout_s: float = 30.0
    ):
        """Yield one compact NDJSON-able record per completed tick (the
        ``GET /monitor/stream`` body). Ends after ``max_ticks`` records,
        on monitor stop/degrade, or when no tick lands for
        ``timeout_s``."""
        sent = 0
        last_seq = -1
        # cursor over the monotonic event counter, not the deque index:
        # once the ring saturates at EVENT_CAP older entries shift out,
        # so a positional cursor would replay or skip events
        last_seen = 0
        while max_ticks is None or sent < max_ticks:
            deadline = time.monotonic() + timeout_s
            with self._wake:
                while True:
                    with self._lock:
                        seq = self._seq
                        failed = self._failed
                    if seq != last_seq:
                        break
                    if (
                        self._stop.is_set()
                        or failed is not None
                        or time.monotonic() >= deadline
                    ):
                        return
                    self._wake.wait(0.25)
            with self._lock:
                last_seq = self._seq
                stats = dict(self._stats)
                verdicts = dict(self._verdicts)
                events = list(self._events)
                n_new = min(len(events), self._events_seen - last_seen)
                new_events = events[len(events) - n_new:] if n_new else []
                last_seen = self._events_seen
                firing = [
                    r.name
                    for r in self._rules
                    if self._rule_state[r.name].state == "firing"
                ]
            yield {
                "t": "tick",
                "seq": last_seq,
                "unix": round(time.time(), 3),
                "rates": stats.get("rates", {}),
                "percentiles": stats.get("percentiles", {}),
                "gauges": stats.get("gauges", {}),
                "tenants": stats.get("tenants", {}),
                "alerts_firing": firing,
                "alert_events": new_events,
                "verdicts": verdicts,
            }
            sent += 1
