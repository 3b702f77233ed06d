"""Span tracer + bounded ring-buffer flight recorder.

Every engine stage (tokenize, constraint compile, prefill, decode
window, accept, flush, finalize, dp round) records a :class:`Span`:
a name, an optional owning job id, a start offset on the recorder's
monotonic timeline, a duration, and small free-form attrs. Spans land
in a fixed-capacity ring (``collections.deque(maxlen=...)``) — a
month-long daemon holds the last N spans, never more — and the ring is
the *flight recorder*: when a job FAILs (or on demand) the engine dumps
the job's slice of the timeline to
``$SUTRO_HOME/jobs/<job_id>/telemetry.json`` next to PR 3's
``failure_log[]``, answering "what was the engine doing when job X
died?" without a rerun.

Threading: ``deque.append`` with a maxlen is atomic under the GIL, so
recording takes no lock; snapshotting copies the ring (bounded) and
filters. Scheduler-level spans may be shared by several co-batched
jobs — those carry the live job ids in ``attrs["jobs"]`` and a
``job_id`` of None; the per-job filter matches either.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._buf: "collections.deque" = collections.deque(
            maxlen=max(int(capacity), 16)
        )
        # epoch pair: spans are stored relative to the monotonic epoch;
        # the wall epoch lets dumps render absolute timestamps
        self.epoch_mono = time.monotonic()
        self.epoch_wall = time.time()
        self.dropped = 0  # ring evictions are implicit; this counts
        #                   records only when the ring was full
        self._full = False

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def record(
        self,
        name: str,
        job_id: Optional[str],
        t0_mono: float,
        dur_s: float,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append one span. Tuple-shaped on purpose (no dataclass
        alloc on the hot path): (name, job_id, t0_rel, dur, attrs)."""
        if self._full:
            self.dropped += 1
        elif len(self._buf) + 1 >= (self._buf.maxlen or 0):
            self._full = True
        self._buf.append(
            (name, job_id, t0_mono - self.epoch_mono, dur_s, attrs)
        )

    class _SpanCtx:
        __slots__ = ("rec", "name", "job_id", "attrs", "t0")

        def __init__(self, rec, name, job_id, attrs):
            self.rec = rec
            self.name = name
            self.job_id = job_id
            self.attrs = attrs

        def __enter__(self):
            self.t0 = time.monotonic()
            return self

        def __exit__(self, et, ev, tb):
            t1 = time.monotonic()
            attrs = self.attrs
            if et is not None:
                attrs = dict(attrs or ())
                attrs["error"] = f"{et.__name__}: {ev}"
            self.rec.record(
                self.name, self.job_id, self.t0, t1 - self.t0, attrs
            )
            return False

    def span(
        self,
        name: str,
        job_id: Optional[str] = None,
        **attrs: Any,
    ) -> "FlightRecorder._SpanCtx":
        """Context manager recording one span (errors annotate the
        span and propagate)."""
        return self._SpanCtx(self, name, job_id, attrs or None)

    # -- reads ---------------------------------------------------------

    def _matches(self, entry, job_id: Optional[str]) -> bool:
        if job_id is None:
            return True
        if entry[1] == job_id:
            return True
        attrs = entry[4]
        return bool(attrs) and job_id in (attrs.get("jobs") or ())

    def snapshot(self, job_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Spans (oldest first) as dicts: name, job_id, t0_s (relative
        to the recorder epoch), dur_s, attrs. Filtered to one job when
        ``job_id`` is given (scheduler spans tagged with the job in
        ``attrs['jobs']`` count)."""
        out = []
        for entry in list(self._buf):
            if not self._matches(entry, job_id):
                continue
            name, jid, t0, dur, attrs = entry
            d: Dict[str, Any] = {
                "name": name,
                "job_id": jid,
                "t0_s": round(t0, 6),
                "dur_s": round(dur, 6),
            }
            if attrs:
                d["attrs"] = dict(attrs)
            out.append(d)
        return out

    def stages(self, job_id: Optional[str] = None) -> List[str]:
        """Distinct span names present (sorted)."""
        return sorted({s["name"] for s in self.snapshot(job_id)})

    def clear(self) -> None:
        self._buf.clear()
        self._full = False
        self.dropped = 0
        self.epoch_mono = time.monotonic()
        self.epoch_wall = time.time()


class JobCounters:
    """Per-job counter accumulator for exact reconciliation against job
    results (rows ok/quarantined/cancelled, tokens in/out, retries).

    These are NOT registry metrics: job ids are unbounded, so they stay
    out of the label space. Single-writer by construction — the engine
    worker thread (or the dp coordinator's serialized result path)
    owns a job's accumulator — so plain dict arithmetic is exact.

    ``attrs`` carries small non-numeric per-job facts that belong in
    the telemetry document but not in counters: the runner's device
    info (the doctor's roofline denominator), the active jax profiler
    trace path, the dp trace id."""

    __slots__ = ("job_id", "counters", "attrs")

    def __init__(self, job_id: str) -> None:
        self.job_id = job_id
        self.counters: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}

    def add(self, key: str, n: float = 1.0) -> None:
        self.counters[key] = self.counters.get(key, 0.0) + n

    def set(self, key: str, v: float) -> None:
        self.counters[key] = float(v)

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (int(v) if v == int(v) else v)
            for k, v in sorted(self.counters.items())
        }


class JobTelemetryStore:
    """Bounded job_id -> JobCounters map (oldest evicted). The lock
    guards only creation/eviction; increments go straight at the
    accumulator."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = max(int(capacity), 8)
        self._lock = threading.Lock()
        self._jobs: "collections.OrderedDict[str, JobCounters]" = (
            collections.OrderedDict()
        )

    def job(self, job_id: str) -> JobCounters:
        jc = self._jobs.get(job_id)
        if jc is not None:
            return jc
        with self._lock:
            jc = self._jobs.get(job_id)
            if jc is None:
                jc = JobCounters(job_id)
                self._jobs[job_id] = jc
                while len(self._jobs) > self.capacity:
                    self._jobs.popitem(last=False)
            return jc

    def peek(self, job_id: str) -> Optional[JobCounters]:
        return self._jobs.get(job_id)

    def drop(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)

    def __iter__(self) -> Iterator[JobCounters]:
        return iter(list(self._jobs.values()))
