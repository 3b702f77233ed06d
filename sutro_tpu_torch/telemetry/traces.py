"""Per-request trace store: end-to-end timelines for tail forensics.

The flight recorder (:mod:`.spans`) is a process-wide ring — great for
"what was the engine doing", useless for "where did THIS request's
time go": its spans are batch-wide and the ring evicts under load. A
*trace* is the per-request view: every interactive request (and every
batch job) gets a ``trace_id`` propagated through the gateway, the
scheduler (queue wait, preemption suspend/resume, prefix hit/extend,
per-window accept), and the server's SSE flush loop; each leg lands as
a child span under that id. The store is a bounded ring of traces
(oldest evicted), each trace a bounded list of spans (overflow counted,
never grown) — a month-long daemon holds the last N requests' shapes,
never more.

Naming contract (graftlint ``trace-ctx-dropped``): the pass treats
``start_trace`` as an acquire and ``end_trace`` / ``Trace.end`` as the
release, so a held trace handle must be ended (or ownership-
transferred) on every exit path of the function that started it.
Call sites that start and end a trace in *different* functions key the
handoff by trace_id string, which the pass does not track — by design:
the string is the propagated context, the handle is a local resource.

dp-awareness: a coordinator job's trace carries the round-10 wire
trace context (``attrs["dp_trace"] = "<job>/r<round>"``) so a
cross-process timeline can be joined to the per-rank sections the
federation layer ingests.

Everything here is called behind ``telemetry.ENABLED`` checks at the
instrumented sites — the store itself stays allocation-free when the
switch is off because no caller reaches it (asserted by the op census
in benchmarks/profile_host_overhead.py --telemetry).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

#: traces kept (oldest evicted) — a request museum, not an archive
DEFAULT_TRACE_CAPACITY = 256
#: spans kept per trace; beyond it spans drop and ``dropped`` counts
MAX_SPANS_PER_TRACE = 512

SCHEMA_VERSION = 1


class Trace:
    """One request's (or job's) timeline. Single-writer-ish by
    construction — the gateway/server thread and the engine worker
    thread interleave appends, and ``list.append`` is GIL-atomic, so
    recording takes no lock; reads copy."""

    __slots__ = (
        "trace_id", "kind", "t0_mono", "created_unix", "attrs",
        "_spans", "dropped", "finished", "outcome",
    )

    def __init__(
        self,
        trace_id: str,
        kind: str,
        attrs: Optional[Dict[str, Any]] = None,
        *,
        t0_mono: Optional[float] = None,
        created_unix: Optional[float] = None,
    ) -> None:
        self.trace_id = trace_id
        self.kind = kind  # interactive | batch
        self.t0_mono = time.monotonic() if t0_mono is None else t0_mono
        self.created_unix = (
            time.time() if created_unix is None else created_unix
        )
        self.attrs: Dict[str, Any] = dict(attrs or ())
        # tuple-shaped spans, same rationale as the flight recorder:
        # (name, t0_rel_s, dur_s, attrs)
        self._spans: List[tuple] = []
        self.dropped = 0
        self.finished = False
        self.outcome: Optional[str] = None

    def add(
        self,
        name: str,
        t0_mono: float,
        dur_s: float,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append one child span (start given on the process monotonic
        clock; stored relative to the trace start)."""
        if len(self._spans) >= MAX_SPANS_PER_TRACE:
            self.dropped += 1
            return
        self._spans.append(
            (name, t0_mono - self.t0_mono, dur_s, attrs)
        )

    def event(
        self, name: str, t_mono: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Zero-duration instant (preempt_suspend, prefix_hit, ...)."""
        self.add(
            name, time.monotonic() if t_mono is None else t_mono,
            0.0, attrs,
        )

    def end(self, outcome: str = "ok") -> None:
        self.finished = True
        self.outcome = outcome

    def to_doc(self) -> Dict[str, Any]:
        """The per-request timeline document (OBSERVABILITY.md
        "Forensics"): spans sorted by start offset, attrs preserved."""
        spans = []
        for name, t0, dur, attrs in sorted(
            list(self._spans), key=lambda s: (s[1], s[0])
        ):
            d: Dict[str, Any] = {
                "name": name,
                "t0_s": round(t0, 6),
                "dur_s": round(dur, 6),
            }
            if attrs:
                d["attrs"] = dict(attrs)
            spans.append(d)
        doc: Dict[str, Any] = {
            "version": SCHEMA_VERSION,
            "trace_id": self.trace_id,
            "kind": self.kind,
            "created_unix": self.created_unix,
            "finished": self.finished,
            "outcome": self.outcome,
            "dropped": self.dropped,
            "stages": sorted({s["name"] for s in spans}),
            "spans": spans,
        }
        if self.attrs:
            doc["attrs"] = dict(self.attrs)
        return doc


class TraceStore:
    """Bounded trace_id -> Trace ring (oldest evicted). The lock guards
    creation/eviction only; span appends go straight at the trace."""

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY) -> None:
        self.capacity = max(int(capacity), 8)
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, Trace]" = (
            collections.OrderedDict()
        )

    def start_trace(
        self,
        trace_id: str,
        kind: str = "interactive",
        attrs: Optional[Dict[str, Any]] = None,
        **fixed: Any,
    ) -> Trace:
        """Create (or return the existing) trace for ``trace_id``.
        ``fixed`` forwards deterministic clocks (``t0_mono``,
        ``created_unix``) for golden tests."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                tr = Trace(trace_id, kind, attrs, **fixed)
                self._traces[trace_id] = tr
                while len(self._traces) > self.capacity:
                    self._traces.popitem(last=False)
            return tr

    def end_trace(self, trace_id: str, outcome: str = "ok") -> None:
        tr = self._traces.get(trace_id)
        if tr is not None:
            tr.end(outcome)

    def add(
        self,
        trace_id: str,
        name: str,
        t0_mono: float,
        dur_s: float,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append a span by id — the fan-out form the scheduler's
        batch-wide sink uses (no handle threading through the loop)."""
        tr = self._traces.get(trace_id)
        if tr is not None:
            tr.add(name, t0_mono, dur_s, attrs)

    def event(
        self, trace_id: str, name: str,
        attrs: Optional[Dict[str, Any]] = None,
        t_mono: Optional[float] = None,
    ) -> None:
        tr = self._traces.get(trace_id)
        if tr is not None:
            tr.event(name, t_mono=t_mono, attrs=attrs)

    def get(self, trace_id: str) -> Optional[Trace]:
        return self._traces.get(trace_id)

    def doc(self, trace_id: str) -> Optional[Dict[str, Any]]:
        tr = self._traces.get(trace_id)
        return None if tr is None else tr.to_doc()

    def ids(self) -> List[str]:
        return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
