"""Engine telemetry: metrics registry, span tracing, flight recorder.

The operator surface the hosted reference keeps server-side (SURVEY §0:
progress accounting and quota enforcement live behind api.sutro.sh),
rebuilt for the TPU-native engine. Three pillars:

1. **Metrics registry** (:mod:`.registry`) — lock-light counters,
   gauges and bounded histograms with thread-local write shards, fixed
   label cardinality, and Prometheus-text / JSON exporters. Scraped via
   ``GET /metrics`` on the engine daemon (server.py) or ``sutro
   telemetry`` on the CLI.
2. **Span tracer + flight recorder** (:mod:`.spans`) — per-stage
   timings (tokenize, constraint compile, prefill, decode window,
   accept, flush, finalize, dp round) in a bounded ring buffer, dumped
   to ``$SUTRO_HOME/jobs/<job_id>/telemetry.json`` when a job FAILs
   (pairing with the job record's ``failure_log[]``) and on demand.
3. **Per-job counters** — exact rows/tokens accumulators outside the
   label space (job ids are unbounded), reconciled against job results.

The catalog of engine metrics lives here (OBSERVABILITY.md documents
names/labels/units). Everything is guarded by one module-global switch:
``SUTRO_TELEMETRY=0`` (or :func:`set_enabled`) turns instrumentation
off, and call sites pay a single attribute load + truth test — the
same zero-overhead-when-off pattern as engine/faults.py ``ACTIVE``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

from .registry import DEFAULT_BUCKETS, MetricsRegistry
from .spans import (
    DEFAULT_CAPACITY,
    FlightRecorder,
    JobCounters,
    JobTelemetryStore,
)
from .traces import DEFAULT_TRACE_CAPACITY, TraceStore

logger = logging.getLogger(__name__)

__all__ = [
    "REGISTRY",
    "RECORDER",
    "JOBS",
    "TRACES",
    "traces",
    "distributed",
    "enabled",
    "set_enabled",
    "stage_observe",
    "job",
    "job_doc",
    "dump_job",
    "load_job_dump",
    "MetricsRegistry",
    "FlightRecorder",
    "JobCounters",
    "JobTelemetryStore",
    "TraceStore",
]

# -- the one enable switch ---------------------------------------------

ENABLED: bool = os.environ.get("SUTRO_TELEMETRY", "1").lower() not in (
    "0", "false", "off",
)


def enabled() -> bool:
    return ENABLED


def set_enabled(on: bool) -> bool:
    """Flip instrumentation globally (tests / the overhead profiler).
    Components that latch the switch at construction (the scheduler's
    timer sink) pick it up on their next construction."""
    global ENABLED
    ENABLED = bool(on)
    return ENABLED


# -- singletons --------------------------------------------------------

REGISTRY = MetricsRegistry()
RECORDER = FlightRecorder(
    capacity=int(os.environ.get("SUTRO_TELEMETRY_SPANS", DEFAULT_CAPACITY))
)
JOBS = JobTelemetryStore(
    capacity=int(os.environ.get("SUTRO_TELEMETRY_JOBS", 256))
)
TRACES = TraceStore(
    capacity=int(
        os.environ.get("SUTRO_TELEMETRY_TRACES", DEFAULT_TRACE_CAPACITY)
    )
)

# -- engine metric catalog (documented in OBSERVABILITY.md) ------------

STAGE_SECONDS = REGISTRY.histogram(
    "sutro_stage_seconds",
    "Engine stage latency (tokenize, constraint_compile, prefill, "
    "decode_window, decode_fetch, admit, accept, flush, finalize, "
    "dp_round, embed)",
    labels=("stage",),
    unit="seconds",
    max_series=16,
)
ROWS_TOTAL = REGISTRY.counter(
    "sutro_rows_total",
    "Result rows emitted by terminal outcome",
    labels=("outcome",),  # ok | quarantined | cancelled
    max_series=8,
)
STAGE_ROWS_TOTAL = REGISTRY.counter(
    "sutro_stage_rows_total",
    "Stage-graph rows completed per stage (engine/stagegraph.py); "
    "labelled by the submit payload's stage name",
    labels=("stage",),
    unit="rows",
    max_series=32,
)
TOKENS_TOTAL = REGISTRY.counter(
    "sutro_tokens_total",
    "Tokens processed by direction (accounted at job finalize)",
    labels=("direction",),  # in | out
    unit="tokens",
)
JOBS_TOTAL = REGISTRY.counter(
    "sutro_jobs_total",
    "Jobs reaching a terminal status",
    labels=("status",),  # succeeded | failed | cancelled
    max_series=8,
)
ROW_EVENTS_TOTAL = REGISTRY.counter(
    "sutro_failure_events_total",
    "failure_log[] events appended (row_retry, row_quarantined, "
    "io_retry, torn_chunk_quarantined, job_failed, ...)",
    labels=("event",),
    max_series=16,
)
FAULTS_INJECTED_TOTAL = REGISTRY.counter(
    "sutro_faults_injected_total",
    "Deterministic fault-plan injections fired, by site",
    labels=("site",),
    max_series=32,
)
IO_RETRIES_TOTAL = REGISTRY.counter(
    "sutro_io_retries_total",
    "Transient-I/O retry attempts (engine/faults.retry_transient)",
    labels=("what",),
    max_series=16,
)
TOKENIZE_ROWS_TOTAL = REGISTRY.counter(
    "sutro_tokenize_rows_total",
    "Prompt rows tokenized through encode_chat_batch",
    unit="rows",
)
DP_EVENTS_TOTAL = REGISTRY.counter(
    "sutro_dp_events_total",
    "Data-parallel coordinator events",
    # reconnect | stall | fault_forwarded | reject | join | requeue |
    # reshard | steal | drain | dup_result | resume_port_busy
    labels=("kind",),
    max_series=16,
)
DP_FLEET_SIZE = REGISTRY.gauge(
    "sutro_dp_fleet_size",
    "Live dp ranks (running or idle-parked) in the coordinator's "
    "current elastic round, coordinator included",
    unit="ranks",
)
DP_REQUEUED_ROWS_TOTAL = REGISTRY.counter(
    "sutro_dp_requeued_rows_total",
    "Rows returned to the pending pool after a rank died, stalled, "
    "tore a frame, drained (preemption), or never connected",
    unit="rows",
)
DP_STOLEN_ROWS_TOTAL = REGISTRY.counter(
    "sutro_dp_stolen_rows_total",
    "Straggler tail rows dual-assigned to an idle rank "
    "(first result wins; duplicates dropped by row id)",
    unit="rows",
)
TOKENS_PER_SECOND = REGISTRY.gauge(
    "sutro_tokens_per_second",
    "Most recent total token throughput reported by a running job",
    unit="tokens/s",
)
ROWS_PER_SECOND = REGISTRY.gauge(
    "sutro_rows_per_second",
    "Most recent row completion rate by workload "
    "(generate, embed, dp, interactive — dp is the coordinator's "
    "pod-merged rate; interactive is the serving tier's request rate)",
    labels=("workload",),
    unit="rows/s",
    max_series=8,
)
# -- interactive serving tier (serving/gateway.py, OBSERVABILITY.md) ----
TTFT_SECONDS = REGISTRY.histogram(
    "sutro_interactive_ttft_seconds",
    "Interactive request time-to-first-token (admission wait + prefill "
    "+ first decode), measured from gateway submit",
    unit="seconds",
)
ITL_SECONDS = REGISTRY.histogram(
    "sutro_interactive_itl_seconds",
    "Interactive inter-token latency (gap between consecutive streamed "
    "tokens of one request)",
    unit="seconds",
)
INTERACTIVE_REQUESTS_TOTAL = REGISTRY.counter(
    "sutro_interactive_requests_total",
    "Interactive serving requests by terminal outcome",
    labels=("outcome",),  # ok | cancelled | error | rejected
    max_series=8,
)
INTERACTIVE_ACTIVE = REGISTRY.gauge(
    "sutro_interactive_active",
    "Interactive requests currently admitted or streaming",
)
INTERACTIVE_PREEMPTIONS_TOTAL = REGISTRY.counter(
    "sutro_interactive_preemptions_total",
    "Batch rows suspended to admit an interactive request inside the "
    "interactive_slots budget (the row re-admits row-granularly)",
)
TOKENS_PER_SECOND_PER_CHIP = REGISTRY.gauge(
    "sutro_tokens_per_second_per_chip",
    "Most recent per-chip token throughput (Throughput estimator)",
    unit="tokens/s",
)
JOBS_RUNNING = REGISTRY.gauge(
    "sutro_jobs_running",
    "Generation/embedding jobs currently executing in this process",
)
SPANS_DROPPED = REGISTRY.gauge(
    "sutro_flight_recorder_dropped",
    "Spans evicted from the flight-recorder ring since process start",
)
# -- tenant attribution + live monitor (telemetry/monitor.py) -----------
# Tenant series ride the registry's ordinary cardinality admission: the
# tenant label value space is capped at TENANT_MAX_SERIES and overflow
# collapses into the standard ("_overflow", ...) series — an abusive
# tenant-id generator cannot grow the scrape unboundedly.
TENANT_MAX_SERIES = int(os.environ.get("SUTRO_TENANT_MAX_SERIES", 32))
TENANT_REQUESTS_TOTAL = REGISTRY.counter(
    "sutro_tenant_requests_total",
    "Submissions by tenant and kind (batch job submits and interactive "
    "requests)",
    labels=("tenant", "kind"),  # kind: batch | interactive
    max_series=TENANT_MAX_SERIES,
)
TENANT_ROWS_TOTAL = REGISTRY.counter(
    "sutro_tenant_rows_total",
    "Result rows attributed to a tenant at job terminal status",
    labels=("tenant", "outcome"),  # ok | quarantined
    max_series=TENANT_MAX_SERIES,
    unit="rows",
)
TENANT_TOKENS_TOTAL = REGISTRY.counter(
    "sutro_tenant_tokens_total",
    "Tokens attributed to a tenant at job terminal status",
    labels=("tenant", "direction"),  # in | out
    max_series=TENANT_MAX_SERIES,
    unit="tokens",
)
ALERTS_TOTAL = REGISTRY.counter(
    "sutro_monitor_alerts_total",
    "SLO alert lifecycle transitions emitted by the live monitor",
    labels=("rule", "state"),  # state: firing | resolved
    max_series=32,
)
ADMISSION_REJECTIONS_TOTAL = REGISTRY.counter(
    "sutro_admission_rejections_total",
    "Submits rejected by the control plane's per-tenant token buckets",
    labels=("tenant",),
    max_series=TENANT_MAX_SERIES,
)
PREEMPTIONS_TOTAL = REGISTRY.counter(
    "sutro_preemptions_total",
    "Decode rows suspended by the priority ladder "
    "(labels are the preemptor's and victim's job_priority)",
    labels=("from", "to"),
    unit="rows",
    max_series=32,
)
AUTOTUNE_ADJUSTMENTS_TOTAL = REGISTRY.counter(
    "sutro_autotune_adjustments_total",
    "Live engine-config adjustments applied by the control-plane "
    "autotuner",
    labels=("knob",),
    max_series=16,
)
PREFIX_STORE_HITS_TOTAL = REGISTRY.counter(
    "sutro_prefix_store_hits_total",
    "Radix prefix-store lookups that matched at least one KV page",
)
PREFIX_STORE_MISSES_TOTAL = REGISTRY.counter(
    "sutro_prefix_store_misses_total",
    "Radix prefix-store lookups that matched nothing",
)
PREFIX_STORE_EVICTIONS_TOTAL = REGISTRY.counter(
    "sutro_prefix_store_evictions_total",
    "Unpinned prefix-store pages evicted under allocation pressure",
    unit="pages",
)
PREFIX_STORE_TOKENS_SAVED_TOTAL = REGISTRY.counter(
    "sutro_prefix_store_prefill_tokens_saved_total",
    "Prefill tokens skipped because their KV was already resident in "
    "the prefix store",
    unit="tokens",
)
# -- tiered paged-KV pool (engine/kvtier.py, OBSERVABILITY.md) ----------
KV_TIER_PAGES = REGISTRY.gauge(
    "sutro_kv_tier_pages",
    "KV pages resident per below-HBM tier (host = int8 page payloads "
    "in pinned RAM, disk = npz bundles under sutro_home()/kvtier)",
    labels=("tier",),  # host | disk
    unit="pages",
    max_series=4,
)
KV_MIGRATIONS_TOTAL = REGISTRY.counter(
    "sutro_kv_migrations_total",
    "Tier-hop page migrations by direction (demote = device->host, "
    "promote = host/disk->device, disk_write/disk_read = host<->disk)",
    labels=("dir",),  # demote | promote | disk_write | disk_read
    max_series=8,
)
KV_RESUMES_TOTAL = REGISTRY.counter(
    "sutro_kv_resumes_total",
    "Preempted-row resumes by mechanism: 'upload' re-admits from a "
    "hibernated host/disk payload (page-upload, no prefill); "
    "'reprefill' regenerates from scratch (tier miss / torn promotion)",
    labels=("kind",),  # upload | reprefill
    unit="rows",
    max_series=4,
)
FLEET_REPLICAS = REGISTRY.gauge(
    "sutro_fleet_replicas",
    "Fleet router replica census by state (healthy = breaker closed + "
    "ready + not draining; open/half_open = breaker tripped; draining "
    "= alive, refusing new work)",
    labels=("state",),  # healthy | open | half_open | draining
    max_series=8,
)
FLEET_FAILOVERS_TOTAL = REGISTRY.counter(
    "sutro_fleet_failovers_total",
    "Requests/jobs moved off a failed replica: 'batch' = jobstore "
    "resume_job re-submission after a replica death mid-job, "
    "'interactive' = transparent pre-first-token retry on another "
    "replica, 'stream_error' = post-first-token structured mid-stream "
    "error returned to the client (no transparent retry possible)",
    labels=("kind",),  # batch | interactive | stream_error
    max_series=8,
)
FLEET_ROUTED_PREFIX_HITS_TOTAL = REGISTRY.counter(
    "sutro_fleet_routed_prefix_hits_total",
    "Interactive requests routed to a replica reporting > 0 warm "
    "prefix tokens (the SGLang-style cache-aware routing win)",
)
FLEET_ROUTE_SECONDS = REGISTRY.histogram(
    "sutro_fleet_route_seconds",
    "Router time from request arrival to the routing decision landing "
    "on a replica (candidate scoring + affinity probe + upstream "
    "connect, retries included); exemplars carry the router trace id",
    labels=("kind",),  # interactive | batch
    unit="seconds",
    max_series=8,
)

# Span names the engine emits — OBSERVABILITY.md's span schema section
# and tests key off this tuple, so additions land in one place.
STAGES = (
    "tokenize",
    "constraint_compile",
    "admit",
    "prefill",
    "decode_window",
    # a pipelined decode window's fetch: the host waiting on the card
    "decode_fetch",
    "accept",
    "flush",
    "finalize",
    "dp_round",
    "embed",
    # tiered-KV migration hops (engine/kvtier.py): device<->host page
    # payload moves on the scheduler thread (disk writes happen on the
    # migration worker and surface as kv_demote queue time only)
    "kv_demote",
    "kv_promote",
    # LocalEngine.submit_batch_inference, around its whole body
    "submit",
)


def stage_observe(
    stage: str, dur_s: float, exemplar: Optional[str] = None
) -> None:
    """One engine stage latency sample into the registry histogram
    (the flight-recorder span is the caller's concern — spans carry
    job identity, the histogram does not). ``exemplar`` optionally
    pins a trace id to the sample's bucket (forensics). Internally
    gated: callers on hot paths may invoke it bare and still honor
    the kill switch."""
    if not ENABLED:
        return
    STAGE_SECONDS.observe(dur_s, stage, exemplar=exemplar)


def job(job_id: str) -> JobCounters:
    return JOBS.job(job_id)


# -- per-job document / flight-recorder dump ---------------------------

# v2: adds per-job "attrs" (device info, profile trace path) and, for
# dp coordinator jobs, "workers" — the ingested per-rank sections
# (telemetry/distributed.py), merged by (round, rank)
SCHEMA_VERSION = 2


def job_doc(job_id: str) -> Dict[str, Any]:
    """Assemble the per-job telemetry document from live state: the
    job's span timeline (flight recorder) + its exact counters, plus —
    on a dp coordinator — every ingested worker section (the merged
    cross-process timeline the doctor analyzes)."""
    jc = JOBS.peek(job_id)
    spans = RECORDER.snapshot(job_id)
    doc: Dict[str, Any] = {
        "version": SCHEMA_VERSION,
        "job_id": job_id,
        "dumped_at": time.strftime(
            "%Y-%m-%dT%H:%M:%S%z", time.localtime()
        ),
        "recorder": {
            "capacity": RECORDER.capacity,
            "dropped": RECORDER.dropped,
            "epoch_unix": RECORDER.epoch_wall,
        },
        "counters": jc.to_dict() if jc is not None else {},
        "stages": sorted({s["name"] for s in spans}),
        "spans": spans,
    }
    if jc is not None and jc.attrs:
        doc["attrs"] = dict(jc.attrs)
    workers = distributed.REMOTE.sections(job_id)
    if workers:
        doc["workers"] = workers
        doc["stages"] = sorted(
            set(doc["stages"])
            | {
                s["name"]
                for w in workers
                for s in w.get("spans", ())
            }
        )
    return doc


def dump_job(job_dir: Path, job_id: str) -> Optional[Dict[str, Any]]:
    """Write ``telemetry.json`` into the job directory (atomic rename,
    jobstore convention). Best-effort: recording a postmortem must
    never become a new failure. Returns the doc (or None on failure/
    disabled)."""
    if not ENABLED:
        return None
    try:
        doc = job_doc(job_id)
        SPANS_DROPPED.set(RECORDER.dropped)
        path = Path(job_dir) / "telemetry.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(doc, indent=2))
        tmp.replace(path)
        return doc
    except Exception:
        logger.warning(
            "telemetry dump failed for %s", job_id, exc_info=True
        )
        return None


def load_job_dump(job_dir: Path) -> Optional[Dict[str, Any]]:
    path = Path(job_dir) / "telemetry.json"
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as e:
        logger.warning("unreadable telemetry.json in %s: %s", job_dir, e)
        return None


def reset_for_tests() -> None:
    """Drop accumulated registry/recorder/job state (declarations
    stay). Tests only."""
    REGISTRY.reset()
    RECORDER.clear()
    TRACES.clear()
    for jc in JOBS:
        JOBS.drop(jc.job_id)
    distributed.REMOTE.clear()


# imported last: distributed.py resolves the package singletons above
# lazily at call time, so the bottom import only publishes the name
from . import distributed  # noqa: E402
