"""Distributed telemetry: cross-worker trace propagation + federation.

The port of ``sutro_tpu/telemetry/distributed.py`` (the same frames and
shard schema). The dp tier (engine/dphost.py) runs one LocalEngine per
rank process;
before this module the coordinator's telemetry ended at its own
process boundary — worker spans, metrics and stage timings never
crossed the wire, so "why was this dp job slow" had no answer. Two
proven shapes, adapted to the dp NDJSON channel:

1. **Trace propagation** (Dapper-style): the coordinator stamps a
   versioned trace context into the ``resume`` frame of every round
   (:func:`trace_context`); each worker rank opens its round under
   that context (:class:`WorkerTelemetry`) and ships a bounded
   telemetry shard back piggybacked on its terminal ``done``/``err``
   frame — its job-filtered span timeline, exact per-job counters,
   and its registry's per-round delta.
2. **Federation** (Monarch-style regional-collect/global-aggregate):
   the coordinator ingests each shard (:class:`DistributedTelemetry`)
   — spans land in the per-job section store (merged into the job
   telemetry document by round and rank), registry deltas fold into
   the live registry under a trailing ``worker`` label
   (``MetricsRegistry.ingest_remote``), so ``GET /metrics``, ``sutro
   telemetry`` and ``sdk.get_metrics_text()`` expose fleet series
   whose per-metric sum is the pod total.

Wire compatibility: every frame addition is a NEW optional key on an
existing frame type, guarded by ``WIRE_VERSION``. An old worker
ignores the ``tele`` key in ``resume`` and ships nothing; an old
coordinator ignores the ``tele`` key in ``done`` — either way the
round completes and the job telemetry document simply reports partial
data (the doctor names the silent ranks). A version-mismatched shard
is dropped with a log line, never an error.

Size discipline: a shipped shard is bounded — at most
``SUTRO_TELEMETRY_SHIP_SPANS`` spans (default 512, newest kept, the
drop count travels with the shard) and a registry delta whose series
count is already capped by the registry's fixed label cardinality.
Everything is inert when ``SUTRO_TELEMETRY=0`` — the dp channel then
carries byte-identical frames to the pre-telemetry protocol.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .registry import snapshot_delta

logger = logging.getLogger(__name__)

#: dp telemetry frame schema version. Bump on incompatible changes to
#: the ``tele`` payloads; receivers drop shards from other versions
#: (graceful degradation, OBSERVABILITY.md "Distributed telemetry").
WIRE_VERSION = 1

#: spans shipped per worker shard (newest kept); the registry delta is
#: bounded by the catalog's fixed cardinality, spans need their own cap
MAX_SHIP_SPANS = int(os.environ.get("SUTRO_TELEMETRY_SHIP_SPANS", "512"))


def _tel():
    # late import: this module is imported from telemetry/__init__.py,
    # so the package singletons are resolved at call time, not load time
    import sutro_tpu_torch.telemetry as tel

    return tel


def trace_context(job_id: str, round_no: int) -> Optional[Dict[str, Any]]:
    """The coordinator's trace context for one dp round — stamped into
    the ``resume`` frame so workers open their round under the same
    trace. None when telemetry is disabled (the frame then carries no
    ``tele`` key at all: zero wire overhead off)."""
    tel = _tel()
    if not tel.ENABLED:
        return None
    return {
        "v": WIRE_VERSION,
        "trace": f"{job_id}/r{int(round_no)}",
        "job": job_id,
        "round": int(round_no),
        "epoch_unix": tel.RECORDER.epoch_wall,
    }


class WorkerTelemetry:
    """Rank>0 side of one dp round: opened with the coordinator's trace
    context, closed into a bounded shard piggybacked on ``done``/
    ``err``. Constructed per round by the engine's dp dispatch with the
    WORKER-LOCAL job id (job ids are per-process; the trace id is the
    cross-process identity)."""

    def __init__(
        self,
        job_id: str,
        rank: int,
        *,
        registry: Any = None,
        recorder: Any = None,
        jobs: Any = None,
    ) -> None:
        tel = _tel()
        self.job_id = job_id
        self.rank = int(rank)
        self._registry = registry if registry is not None else tel.REGISTRY
        self._recorder = recorder if recorder is not None else tel.RECORDER
        self._jobs = jobs if jobs is not None else tel.JOBS
        self._ctx: Optional[Dict[str, Any]] = None
        self._base: Optional[Dict[str, List]] = None
        self._t0 = 0.0

    def begin(self, ctx: Any) -> bool:
        """Open the round under the coordinator's trace context (the
        ``tele`` value of the resume frame). Returns False — and stays
        inert — when telemetry is off, the coordinator sent no context
        (old frame), or the wire version does not match."""
        tel = _tel()
        if not tel.ENABLED or not isinstance(ctx, dict):
            return False
        if ctx.get("v") != WIRE_VERSION:
            logger.info(
                "dropping dp trace context with wire version %r "
                "(this build speaks v%d)", ctx.get("v"), WIRE_VERSION,
            )
            return False
        self._ctx = dict(ctx)
        self._base = self._registry.export_snapshot()
        self._t0 = time.monotonic()
        return True

    def payload(self) -> Optional[Dict[str, Any]]:
        """The bounded shard to piggyback on the worker's terminal
        frame, or None when the round was never opened (ships nothing
        — the coordinator reports partial data)."""
        tel = _tel()
        if self._ctx is None or not tel.ENABLED:
            return None
        # the round envelope span lands BEFORE the snapshot so the
        # shipped timeline carries its own boundary marker
        self._recorder.record(
            "dp_round", self.job_id, self._t0,
            time.monotonic() - self._t0,
            {"trace": self._ctx.get("trace"), "rank": self.rank},
        )
        spans = self._recorder.snapshot(self.job_id)
        dropped = 0
        if len(spans) > MAX_SHIP_SPANS:
            dropped = len(spans) - MAX_SHIP_SPANS
            spans = spans[-MAX_SHIP_SPANS:]
        jc = self._jobs.peek(self.job_id)
        return {
            "v": WIRE_VERSION,
            "trace": self._ctx.get("trace"),
            "round": int(self._ctx.get("round", 0)),
            "rank": self.rank,
            "epoch_unix": self._recorder.epoch_wall,
            "spans": spans,
            "spans_dropped": dropped,
            "counters": jc.to_dict() if jc is not None else {},
            "attrs": dict(jc.attrs) if jc is not None and jc.attrs else {},
            "registry": snapshot_delta(
                self._base, self._registry.export_snapshot()
            ),
        }


class DistributedTelemetry:
    """Coordinator-side store of ingested worker shards, keyed job ->
    (round, rank). Bounded like the other telemetry stores: oldest job
    evicted past ``capacity``, at most ``max_sections`` shards per job
    (a pathological reconnect storm cannot grow one job's document
    without bound). Also the per-job dp round counter — rounds number
    coordinator dispatches, so a resumed job's sections merge by round
    instead of overwriting."""

    def __init__(
        self,
        capacity: int = 256,
        max_sections: int = 128,
        *,
        registry: Any = None,
    ) -> None:
        self.capacity = max(int(capacity), 8)
        self.max_sections = max(int(max_sections), 4)
        self._registry = registry  # None -> the live telemetry.REGISTRY
        self._lock = threading.Lock()
        self._jobs: "collections.OrderedDict[str, Dict[str, Any]]" = (
            collections.OrderedDict()
        )

    def _job(self, job_id: str) -> Dict[str, Any]:
        st = self._jobs.get(job_id)
        if st is None:
            st = self._jobs[job_id] = {"round": 0, "sections": {}}
            while len(self._jobs) > self.capacity:
                self._jobs.popitem(last=False)
        return st

    def next_round(self, job_id: str) -> int:
        """Allocate the next dp round number for a job (1-based)."""
        with self._lock:
            st = self._job(job_id)
            st["round"] += 1
            return st["round"]

    def ingest(self, job_id: str, rank: int, payload: Any) -> bool:
        """Fold one worker shard into the job's section store and the
        live registry (worker-labelled federation). Malformed or
        version-mismatched shards are dropped with a log line — wire
        drift degrades to partial data, never to a failed round."""
        tel = _tel()
        if not tel.ENABLED or not isinstance(payload, dict):
            return False
        if payload.get("v") != WIRE_VERSION:
            logger.info(
                "dropping telemetry shard from rank %s: wire version "
                "%r != %d", rank, payload.get("v"), WIRE_VERSION,
            )
            return False
        try:
            rank = int(payload.get("rank", rank))
            round_no = int(payload.get("round", 0))
            # re-anchor worker span offsets onto the coordinator's
            # timeline: worker wall = worker epoch + t0; coordinator
            # offset = worker wall - coordinator epoch. Cross-host
            # clock skew shifts a whole rank's section, never its
            # internal ordering (merge rules in OBSERVABILITY.md).
            t_off = float(payload.get("epoch_unix", 0.0)) - float(
                tel.RECORDER.epoch_wall
            )
            spans = []
            for s in payload.get("spans") or ():
                if not isinstance(s, dict) or "name" not in s:
                    continue
                d = dict(s)
                d["t0_coord_s"] = round(float(s.get("t0_s", 0.0)) + t_off, 6)
                spans.append(d)
            section = {
                "rank": rank,
                "round": round_no,
                "trace": payload.get("trace"),
                "epoch_unix": payload.get("epoch_unix"),
                "clock_offset_s": round(t_off, 6),
                "spans": spans,
                "spans_dropped": int(payload.get("spans_dropped", 0)),
                "counters": dict(payload.get("counters") or {}),
                "attrs": dict(payload.get("attrs") or {}),
            }
        except (TypeError, ValueError) as e:
            logger.warning(
                "dropping malformed telemetry shard from rank %s: %s",
                rank, e,
            )
            return False
        with self._lock:
            st = self._job(job_id)
            if len(st["sections"]) >= self.max_sections and (
                round_no, rank
            ) not in st["sections"]:
                logger.warning(
                    "job %s telemetry section cap (%d) reached; "
                    "dropping shard round=%d rank=%d",
                    job_id, self.max_sections, round_no, rank,
                )
                return False
            st["sections"][(round_no, rank)] = section
        registry = self._registry if self._registry is not None else tel.REGISTRY
        registry.ingest_remote(str(rank), payload.get("registry") or {})
        tel.DP_EVENTS_TOTAL.inc(1.0, "tele_shard")
        return True

    def sections(self, job_id: str) -> List[Dict[str, Any]]:
        """The job's ingested worker sections, ordered (round, rank)."""
        with self._lock:
            st = self._jobs.get(job_id)
            if st is None:
                return []
            return [
                dict(st["sections"][k]) for k in sorted(st["sections"])
            ]

    def drop(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)

    def clear(self) -> None:
        with self._lock:
            self._jobs.clear()


#: coordinator-side singleton (mirrors REGISTRY/RECORDER/JOBS)
REMOTE = DistributedTelemetry(
    capacity=int(os.environ.get("SUTRO_TELEMETRY_JOBS", 256))
)
