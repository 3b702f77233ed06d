"""LocalEngine: the in-process job API behind the ``Sutro`` client.

The port of ``sutro_tpu/engine/api.py``: the Sutro wire contract
(``POST /batch-inference``, ``GET /stream-job-progress``, ``POST
/job-results``, ...) as direct calls on an in-process object that the
SDK dispatches to when ``backend="tpu"`` (the default; the name is kept
for the SDK's contract, and the engine runs on a CUDA card).

Threading model: one worker thread drains a priority queue of jobs
(priority, then submit order). The worker is the single writer for
running jobs (jobstore invariant). Generation jobs run as co-batched
sessions: same-model jobs submitted while one runs attach to its
``ContinuousBatcher.run_multi`` and share its decode batch; a
strictly-higher-priority job that cannot attach (another model, a dry
run) makes the session yield, requeue and later resume row-granularly.
Cancellation is a flag the scheduler polls between decode steps.
Progress streams through the metrics bus; results and status are
durable in the jobstore, so a new process can still see and resume
finished or partial work. CUDA launches therefore come from the
worker thread, not the caller's.

Inputs are a list of rows, a ``dataset-<id>`` of the engine's
``DatasetStore`` (``engine/datasets.py``) or an http(s) CSV/parquet
URL. Embedding models run length-sorted batches through
``ModelRunner.embed_batch`` (``_run_embedding_job``), with the same
flushes, resume, cancel and yield as generation jobs. The telemetry
getters (``job_telemetry``, ``get_trace``, ``diagnose_job``) read the
flight recorder through ``telemetry/traceexport.py`` and
``telemetry/doctor.py``.

Online serving (``EngineConfig.interactive_slots > 0``): the
interactive gateway (``serving/gateway.py``) parks each OpenAI request
as a 1-row job at priority -1 and wakes the worker with a
``serve:<engine_key>`` queue sentinel; a running co-batched session of
that model adopts it directly (``poll_new``), an idle worker starts a
serving-only session, and a session of another model yields to it.
Every batcher gets the engine-lifetime radix prefix store
(``engine/prefixstore.py``; on by default, ``SUTRO_PREFIX_STORE=0``
turns it off) and, with ``kv_tiers=True``, the host/disk KV tiers
(``engine/kvtier.py``; ``SUTRO_KV_TIERS``), one of each per resident
runner. ``fleet_state`` is the load report the server's
``/fleet-state`` frame carries.

Stage graphs (a ``stages`` payload, ``engine/stagegraph.py``) run as
one job through ``StageGraphRunner``. The live SLO monitor
(``telemetry/monitor.py``) runs whenever telemetry is on and
``SUTRO_MONITOR`` is not 0; the control plane (``engine/control.py``:
per-tenant admission buckets, the preemptive priority ladder, the
autotuner driven by the monitor's tick) whenever ``SUTRO_CONTROL`` /
``EngineConfig.control`` resolve on.

With ``EngineConfig.profile_dir`` set, every generation job runs under
``profiling.job_trace``: a ``torch.profiler`` trace (the card's kernels
and the CPU's ops) in ``{profile_dir}/{job_id}/trace.json``, entered on
the worker thread that drives the job's batcher.

Data parallelism (``engine/dphost.py``): with ``SUTRO_DP_WORLD`` above
1 in its environment, each engine process is one rank of a job that
spans them all. Every rank runs its share of the rows on its own
device; rank 0 merges every rank's rows through its jobstore, and its
elastic rounds requeue a dead, stalled or drained rank's rows.
``job_fleet`` is the round's membership view (``jobs/<id>/fleet.json``
after the round), and the workers' telemetry shards merge into rank 0's
job document (``telemetry/distributed.py``).
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import queue
import threading
import time
import traceback
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from .. import telemetry
from ..telemetry import distributed
from ..telemetry import monitor as tmonitor
from ..common import MODEL_CATALOG, read_csv_text, read_parquet_columns
from ..interfaces import JobStatus
from ..models.configs import MODEL_CONFIGS, ModelConfig
from . import faults
from .config import EngineConfig, load_engine_config
from .datasets import DatasetStore
from .dphost import (
    DPWorld,
    EmbResult,
    _accepts_kwarg,
    configure_channel,
    fleet_view,
    run_dp_coordinator,
    run_dp_worker,
    serve_resume_round,
    shard_requests,
)
from .jobstore import JobStore, estimate_cost
from .metrics import BatchedProgress, MetricsBus, Throughput
from .profiling import StepTimer
from .runner import ModelRunner
from .scheduler import ContinuousBatcher, GenRequest, GenResult, JobCtx
from .tokenizer import BaseTokenizer, encode_chat_batch, load_tokenizer

_PARTIAL_FLUSH_EVERY = 256

# close() sentinel: sorts ahead of every real queue entry (priorities
# are small non-negative ints), and its job_id None is never compared
# because the (priority, seq) prefix is unique
_WORKER_STOP = (-(1 << 60), -1, None)


def _read_url_rows(url: str, column: "str | None") -> list:
    """An http(s) CSV (``.csv``, ``.csv.gz``) or parquet URL -> its
    column's rows as strings, as the JAX engine's ``pd.read_csv`` /
    ``pd.read_parquet`` and ``astype(str)`` give them (CSV by
    ``common.read_csv_text``; parquet needs pyarrow)."""
    import io
    from urllib.request import urlopen

    path = url.split("?")[0]
    try:
        with urlopen(url, timeout=120) as resp:
            body = resp.read()
        if path.endswith((".csv", ".csv.gz")):
            if path.endswith(".gz"):
                import gzip

                body = gzip.decompress(body)
            columns, _ = read_csv_text(body.decode("utf-8"))
        else:
            columns = {
                name: ["nan" if v is None else str(v) for v in vals]
                for name, vals in read_parquet_columns(io.BytesIO(body)).items()
            }
    except Exception as e:
        raise ValueError(f"Could not fetch input URL {url!r}: {e}") from e
    if column is None:
        if len(columns) != 1:
            raise ValueError(
                f"URL input has columns {list(columns)}; pass `column` "
                "to select one"
            )
        column = next(iter(columns))
    if column not in columns:
        raise ValueError(
            f"URL input has no column {column!r} (has {list(columns)})"
        )
    return columns[column]


def _token_bytes_of(tok):
    """The tokenizer's byte view of a token id (stop-sequence detection),
    or None when it has none: base-class stubs raise, so probe once."""
    token_bytes = getattr(tok, "token_bytes", None)
    if token_bytes is not None:
        try:
            token_bytes(0)
        except Exception:  # graftlint: disable=silent-except
            # any raise means no byte view
            token_bytes = None
    return token_bytes


def _env_switch(name: str, default: bool) -> bool:
    """An engine kill switch: ``$name`` overrides ``default``; ``0``,
    ``off``, ``false`` and empty mean off."""
    env = os.environ.get(name)
    if env is None:
        return bool(default)
    return env.strip().lower() not in ("0", "off", "false", "")


def resolve_model(model: str) -> Tuple[str, ModelConfig, Dict[str, Any]]:
    """Public model name (or raw engine key) -> (engine_key, config, meta)."""
    meta = MODEL_CATALOG.get(model)
    if meta is not None:
        key = meta["engine_key"]
    elif model in MODEL_CONFIGS:
        key, meta = model, {"engine_key": model, "thinking": False,
                            "embedding": MODEL_CONFIGS[model].head == "embedding"}
    else:
        raise ValueError(
            f"Unknown model {model!r}. Catalog: {sorted(MODEL_CATALOG)} "
            f"(or an engine key from models.configs.MODEL_CONFIGS)"
        )
    return key, MODEL_CONFIGS[key], meta


class LocalEngine:
    """The job API. Its runners live on ``device``: the CUDA card by
    default; tests pass ``device="cpu"``, which every ``ModelRunner``
    and checkpoint load then takes (``EngineConfig`` has no device
    field). A list of devices, one a rank, runs each runner on a mesh
    (``EngineConfig.tp/ep/sp/pp``; engine/runner.py), and each rank
    loads its own block of a checkpoint."""

    def __init__(self, ecfg: Optional[EngineConfig] = None, *, device="cuda"):
        self.ecfg = ecfg or load_engine_config()
        self.device = device
        # per-job fault-injection activation (EngineConfig.fault_plan or
        # SUTRO_FAULT_PLAN; None clears — a fresh engine with no plan
        # runs injection-free at zero overhead)
        faults.configure(self.ecfg.fault_plan)
        # dp channel liveness knobs (validated >= 0 here; the
        # SUTRO_DP_* environment variables still override when set)
        configure_channel(
            stall_timeout=self.ecfg.dp_stall_timeout,
            heartbeat=self.ecfg.dp_heartbeat,
        )
        self.jobs = JobStore(
            io_retries=self.ecfg.io_retries,
            io_backoff=self.ecfg.io_backoff_base,
            io_backoff_cap=self.ecfg.io_backoff_cap,
        )
        self.metrics = MetricsBus()
        self.datasets = DatasetStore()
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = 0
        self._cancel: set = set()
        self._queued: set = set()
        self._queued_prio: Dict[str, int] = {}  # queued job -> priority
        self._current_job: Optional[str] = None
        # jobs pulled out of the queue into the RUNNING co-batched
        # session — busy for resume purposes
        self._attached: set = set()
        # job_id -> (attach engine key | None,) — immutable verdicts
        # cached so the scheduler-cadence queue scans don't re-read
        # job records from disk
        self._attach_info: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._runner_cache: Dict[str, Tuple[ModelRunner, BaseTokenizer]] = {}
        self._tok_cache: Dict[str, BaseTokenizer] = {}
        # Engine-lifetime radix prefix stores and tiered KV pools, one of
        # each per resident runner (engine/prefixstore.py,
        # engine/kvtier.py): their pages and payloads belong to that
        # runner's KV pool, so evicting the runner closes both
        self._prefix_stores: Dict[str, Any] = {}
        self._kv_tiers: Dict[str, Any] = {}
        # the interactive serving tier exists only with a slot budget
        self.gateway = None
        if getattr(self.ecfg, "interactive_slots", 0) > 0:
            from ..serving.gateway import InteractiveGateway

            self.gateway = InteractiveGateway(self)
        # Live SLO monitor (telemetry/monitor.py): per-engine sampler, so
        # parallel engines don't share alert state. Constructed only when
        # telemetry AND the monitor switch are on; with either off, zero
        # threads and zero work.
        self.monitor = None
        if telemetry.ENABLED and tmonitor.monitor_enabled():
            self.monitor = tmonitor.Monitor(
                jobs_provider=self._monitor_jobs,
                alert_dump=self._monitor_alert_dump,
            ).start()
        # SLO enforcement control plane (engine/control.py): per-tenant
        # admission buckets + preemptive priority ladder + closed-loop
        # autotuner. Constructed ONLY when SUTRO_CONTROL /
        # EngineConfig.control resolves on — at the default None every
        # hot path is an is-None check. A construction failure means
        # OFF, never a broken engine.
        self.control = None
        from . import control as _control

        _spec = _control.resolve_spec(getattr(self.ecfg, "control", None))
        if _spec is not None:
            try:
                self.control = _control.ControlPlane(
                    _spec,
                    ecfg=self.ecfg,
                    jobs=self.jobs,
                    jobs_provider=self._monitor_jobs,
                    tier_pools=self._live_kv_tiers,
                )
                # terminal accounting refunds the unused reserve
                self.jobs.on_terminal = self.control.on_terminal
                # the autotuner closes the loop off the monitor's tick
                if self.monitor is not None:
                    self.monitor.on_tick = self.control.on_monitor_tick
            except Exception:  # noqa: BLE001 — enforcement is opt-in
                # armor, never a reason the engine fails to come up
                logger.warning(
                    "control plane failed to construct — running "
                    "without enforcement", exc_info=True,
                )
                self.control = None
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True, name="sutro-engine"
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # Public API (the wire endpoints, as methods)
    # ------------------------------------------------------------------

    def submit_batch_inference(self, payload: Dict[str, Any]) -> str:
        """POST /batch-inference equivalent. Returns job_id (for dry runs the
        job completes with a cost_estimate in its record). A ``submit``
        span times the whole call."""
        t0 = time.monotonic()
        job_id = self._submit_batch_inference(payload)
        if telemetry.ENABLED:
            telemetry.RECORDER.record(
                "submit", job_id, t0, time.monotonic() - t0, None
            )
        return job_id

    def _submit_batch_inference(self, payload: Dict[str, Any]) -> str:
        model = payload.get("model", "qwen-3-4b")
        engine_key, mcfg, meta = resolve_model(model)
        inputs = payload["inputs"]
        if isinstance(inputs, str) and inputs.startswith("dataset-"):
            inputs = self.datasets.read_rows(
                inputs, column=payload.get("column")
            )
        elif isinstance(inputs, str) and inputs.startswith(
            ("http://", "https://")
        ):
            # prepare_input_data passes URLs through for the engine
            inputs = _read_url_rows(inputs, payload.get("column"))
        if not isinstance(inputs, list):
            raise ValueError(
                "inputs must be a list of strings, a dataset-<id>, or an "
                "http(s) URL to a parquet/csv file"
            )
        inputs = [str(x) for x in inputs]

        sampling = dict(payload.get("sampling_params") or {})
        sampling.setdefault("max_new_tokens", self.ecfg.max_new_tokens)
        if payload.get("output_schema"):
            # The schema guarantee ("output_schema => complete JSON")
            # must stay feasible: raise the row cap to the schema's
            # shortest accepting output BEFORE quota/cost accounting, so
            # the effective cap is what gets admitted, estimated, and
            # persisted. Schema compile errors surface when the job runs.
            try:
                from .constrain import schema_constraint_factory
                from .constrain.fsm import constraint_room

                probe = schema_constraint_factory(
                    payload["output_schema"],
                    self._get_tokenizer(engine_key, mcfg),
                )()
                room = constraint_room(probe)
                if int(sampling["max_new_tokens"]) < room:
                    sampling["max_new_tokens"] = room
            except Exception:
                # deliberate: a schema that fails to compile here fails
                # the JOB with a real error when it runs; the submit
                # path only loses the feasibility cap raise
                logger.debug(
                    "schema feasibility probe failed at submit; "
                    "surfacing when the job runs",
                    exc_info=True,
                )
        tenant = str(payload.get("tenant") or "default").strip() or "default"
        # job_priority indexes the quota table, so an out-of-range value
        # is a structured caller error (InvalidPriority) BEFORE any
        # record exists — never silently clamped
        job_priority = self.jobs.validate_priority(
            payload.get("job_priority", 0)
        )
        # Stage-graph jobs (engine/stagegraph.py): validate the DAG
        # BEFORE any record exists — a cyclic or dangling-edge graph is
        # a structured InvalidGraph (HTTP 400), as InvalidPriority is. A
        # stage-less payload takes none of these branches.
        graph = None
        if payload.get("stages") is not None:
            from .stagegraph import graph_cost_bounds, initial_stages_state
            from .stagegraph import parse_graph

            graph = parse_graph(
                payload["stages"], default_model=model,
                resolve=resolve_model,
            )
        rec = self.jobs.create(
            name=payload.get("name"),
            description=payload.get("description"),
            model=model,
            engine_key=engine_key,
            num_rows=len(inputs),
            job_priority=job_priority,
            output_schema=payload.get("output_schema"),
            system_prompt=payload.get("system_prompt"),
            sampling_params=sampling,
            truncate_rows=bool(payload.get("truncate_rows", True)),
            dry_run=bool(payload.get("dry_run", False)),
            random_seed_per_input=bool(
                payload.get("random_seed_per_input", False)
            ),
            tenant=tenant,
            stages=graph.to_payload() if graph is not None else None,
            stages_state=(
                initial_stages_state(graph, len(inputs))
                if graph is not None else None
            ),
        )
        if telemetry.ENABLED:
            telemetry.job(rec.job_id).attrs["tenant"] = tenant
            telemetry.TENANT_REQUESTS_TOTAL.inc(1.0, tenant, "batch")
        self.jobs.write_inputs(rec.job_id, inputs)

        # Quota gate. A BPE token consumes >= 1 UTF-8 byte, so byte
        # length is a sound upper bound — jobs whose bound fits the
        # quota pass immediately; only jobs near the quota pay exact
        # tokenize-and-count.
        max_new_total = len(inputs) * int(sampling["max_new_tokens"])
        overhead = len(
            (rec.system_prompt or "").encode("utf-8")
        ) + 64  # per-row chat-template + system-prompt bound
        overhead_extra = 0
        if graph is not None:
            # price the WHOLE DAG at submit: downstream map stages add
            # their own input (bounded by upstream max_new + template
            # overhead) and output tokens to the quota/admission draw
            overhead_extra, extra_new = graph_cost_bounds(
                graph, len(inputs), int(sampling["max_new_tokens"])
            )
            max_new_total += extra_new
        bound = (
            sum(len(r.encode("utf-8")) for r in inputs)
            + len(inputs) * overhead
            + max_new_total
            + overhead_extra
        )
        # row quota first on its own: tokenizing cannot change a
        # row-count failure, so never pay the exact pass for one
        quota_err = self.jobs.check_quota(rec.job_priority, len(inputs), 0)
        if quota_err is None:
            quota_err = self.jobs.check_quota(rec.job_priority, 0, bound)
            if quota_err:
                tok = self._get_tokenizer(engine_key, mcfg)
                exact = sum(
                    len(ids)
                    for ids in encode_chat_batch(
                        tok,
                        inputs,
                        rec.system_prompt,
                        mcfg.chat_template,
                        threads=self.ecfg.tokenize_threads,
                    )
                ) + max_new_total + overhead_extra  # stage inputs: bound only
                quota_err = self.jobs.check_quota(
                    rec.job_priority, 0, exact
                )
        if quota_err:
            self.jobs.append_failure_log(
                rec.job_id, {"event": "job_failed", "error": quota_err}
            )
            self.jobs.set_status(
                rec.job_id,
                JobStatus.FAILED,
                failure_reason={"message": quota_err},
            )
            return rec.job_id

        # Control-plane admission (engine/control.py): the per-SUBMIT
        # quota above is a size cap; this is the per-tenant sustained
        # RATE — a token-bucket draw with bounded-wait backpressure.
        # Dry runs cost nothing real and skip the draw.
        if self.control is not None and not rec.dry_run:
            admit_err = self.control.admit_batch(
                tenant, rec.job_priority, len(inputs), float(bound),
                job_id=rec.job_id,
            )
            if admit_err:
                self.jobs.append_failure_log(
                    rec.job_id,
                    {"event": "admission_rejected", "error": admit_err},
                )
                self.jobs.set_status(
                    rec.job_id,
                    JobStatus.FAILED,
                    failure_reason={
                        "message": admit_err,
                        "code": "QUOTA_EXCEEDED",
                    },
                )
                return rec.job_id

        self._enqueue(rec.job_priority, rec.job_id)
        return rec.job_id

    def _higher_priority_waiting(self, my_priority: int) -> bool:
        """True when a strictly-higher-priority (lower number) job sits
        in the queue — the preemption predicate, read under the lock so
        it is race-free against the worker's pop/requeue windows."""
        with self._lock:
            return any(
                p < my_priority for p in self._queued_prio.values()
            )

    def _attach_key(self, jid: str) -> Optional[str]:
        """The engine key a queued job would attach under, or None when
        it can never attach (different head, dry run, stage graph,
        unresolvable). Cached: the verdict is immutable per job, and
        this runs on the scheduler loop's cadence. A stage-graph job
        runs its own waves (``StageGraphRunner``); the JAX engine lets
        it attach to a same-model session, where it would run as a
        plain job over its inputs."""
        if jid.startswith("serve:"):
            # serving-wake sentinel (_enqueue_serving): attaches to a
            # same-key session; for any other session it reads as an
            # unattachable higher-priority entry, forcing the yield that
            # gets the interactive request onto the device
            return jid[6:]
        cached = self._attach_info.get(jid)
        if cached is not None:
            return cached[0]
        try:
            rec = self.jobs.get(jid)
            key, mcfg, _meta = resolve_model(rec.model)
            info = (
                None
                if (rec.dry_run or rec.stages or mcfg.head == "embedding")
                else key,
            )
        except Exception:
            info = (None,)
        if len(self._attach_info) > 4096:  # bound a long-lived daemon
            self._attach_info.clear()
        self._attach_info[jid] = info
        return info[0]

    def _unattachable_higher_waiting(
        self, my_priority: int, engine_key: str
    ) -> bool:
        """Preemption predicate for a CO-BATCHED generation session: a
        strictly-higher-priority queued job forces a yield ONLY when it
        cannot simply attach to the running session (different model,
        embedding head, or dry run). Same-model generation jobs ride
        free slots with priority-ordered admission instead."""
        with self._lock:
            items = [
                (j, p)
                for j, p in self._queued_prio.items()
                if p < my_priority
            ]
        for jid, _p in items:
            if jid in self._cancel:
                continue  # will be discarded at pop, not run
            if self._attach_key(jid) != engine_key:
                return True
        return False

    def _pop_attachable(self, engine_key: str):
        """Remove and return ``(job_id, seq)`` for the NEXT queued
        generation job that can join the running co-batched session
        (same engine model, not embedding, not a dry run), or None.

        FIFO fairness: the scan walks the queue in (priority, seq)
        order and STOPS at the first unattachable entry — a same-model
        job submitted after a different-model job must not jump it.
        Only the worker thread calls this, so there is no concurrent
        ``get``; submitters' ``put`` calls serialize on the queue
        mutex."""
        import heapq

        with self._queue.mutex:
            cands = sorted(self._queue.queue)
        for item in cands:
            _prio, seq, jid = item
            if jid is None:
                # _WORKER_STOP sentinel (sorts first): the engine is
                # closing — a live session stops adopting new jobs
                break
            if self._attach_key(jid) != engine_key:
                if jid in self._cancel:
                    continue  # discarded at pop — doesn't hold a turn
                break  # FIFO: don't attach past an unattachable job
            with self._queue.mutex:
                try:
                    self._queue.queue.remove(item)
                except ValueError:
                    continue  # taken since the snapshot
                heapq.heapify(self._queue.queue)
            with self._lock:
                self._queued.discard(jid)
                self._queued_prio.pop(jid, None)
            self._attach_info.pop(jid, None)
            if jid.startswith("serve:"):
                # same-key serving sentinel: the running session polls
                # the gateway directly (poll_new), so the wake-up is
                # already served — consume it and keep scanning
                if self.gateway is not None:
                    self.gateway.sentinel_popped(engine_key)
                continue
            if jid in self._cancel:
                # mirrors the worker-pop cancel check
                self.jobs.set_status(jid, JobStatus.CANCELLED)
                continue
            return jid, seq
        return None

    def _reserve_queue_entry(self, priority: int, job_id: str) -> int:
        """Caller must hold ``self._lock``. Registers the job as queued
        and returns its FIFO sequence number; the caller must follow up
        with ``self._queue.put((priority, seq, job_id))`` or roll back."""
        self._seq += 1
        self._queued.add(job_id)
        self._queued_prio[job_id] = priority
        return self._seq

    def _enqueue(self, priority: int, job_id: str) -> None:
        with self._lock:
            seq = self._reserve_queue_entry(priority, job_id)
            self._queue.put((priority, seq, job_id))

    def _enqueue_serving(self, engine_key: str) -> None:
        """Wake the worker for a parked interactive request: a
        ``serve:<engine_key>`` sentinel at priority -1 — ahead of every
        batch priority (all non-negative), so an idle worker starts a
        serving session immediately and a busy different-model session
        sees an unattachable higher entry and yields."""
        self._enqueue(-1, f"serve:{engine_key}")

    def job_status(self, job_id: str) -> str:
        return self.jobs.status(job_id).value

    def get_job(self, job_id: str) -> Dict[str, Any]:
        d = self.jobs.get(job_id).to_dict()
        d["has_telemetry_dump"] = (
            self.jobs._dir(job_id) / "telemetry.json"
        ).exists()
        return d

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self.jobs.list_jobs()

    def cancel_job(self, job_id: str) -> Dict[str, Any]:
        status = self.jobs.status(job_id)
        if status.is_terminal():
            return {"status": status.value}
        # monotonic one-way flag, polled by the worker at pop/row
        # boundaries; it never un-sets while a job is live
        self._cancel.add(job_id)  # graftlint: disable=shared-state-unlocked
        if status == JobStatus.QUEUED:
            self.jobs.set_status(job_id, JobStatus.CANCELLED)
            return {"status": JobStatus.CANCELLED.value}
        return {"status": self.jobs.set_cancelling(job_id).value}

    def job_results(
        self,
        job_id: str,
        include_inputs: bool = False,
        include_cumulative_logprobs: bool = False,
    ) -> Dict[str, Any]:
        """POST /job-results equivalent: {outputs[, errors, inputs,
        cumulative_logprobs, gen_tokens]} aligned 1:1 with inputs,
        order-preserving."""
        cols = self.jobs.read_results(job_id)
        ids = cols["row_id"]
        if any(a > b for a, b in zip(ids, ids[1:])):
            order = sorted(range(len(ids)), key=ids.__getitem__)
            cols = {k: [v[i] for i in order] for k, v in cols.items()}
        out: Dict[str, Any] = {"outputs": cols["outputs"]}
        errors = cols.get("error")
        if errors is not None and any(e is not None for e in errors):
            # quarantined rows (row-level failure domain): 1:1 with
            # outputs, None for clean rows
            out["errors"] = [None if e is None else str(e) for e in errors]
        if include_inputs:
            out["inputs"] = self.jobs.read_inputs(job_id)
        if include_cumulative_logprobs and "cumulative_logprobs" in cols:
            out["cumulative_logprobs"] = cols["cumulative_logprobs"]
            if "gen_tokens" in cols:  # sampled-token counts per row
                out["gen_tokens"] = [int(x or 0) for x in cols["gen_tokens"]]
        return out

    def stream_job_progress(self, job_id: str) -> Iterator[Dict[str, Any]]:
        """GET /stream-job-progress equivalent (NDJSON update dicts)."""
        status = self.jobs.status(job_id)
        jm = self.metrics.job(job_id)
        if status.is_terminal():
            rec = self.jobs.get(job_id)
            yield {"update_type": "progress", "result": rec.num_rows
                   if status == JobStatus.SUCCEEDED else jm.rows_completed}
            return
        yield from jm.subscribe()

    def resume_job(self, job_id: str) -> Dict[str, Any]:
        """Row-granular resume: re-queue a FAILED/CANCELLED job — or one
        left RUNNING/STARTING by a dead engine process. Rows already
        flushed to the partial store are not recomputed."""
        status = self.jobs.status(job_id)
        deadline = time.monotonic() + 5.0
        while True:
            # Atomic not-busy check AND re-queue under ONE lock hold:
            # two concurrent resume calls must not both observe not-busy
            # and double-enqueue the job.
            with self._lock:
                busy = (
                    job_id in self._queued
                    or job_id == self._current_job
                    or job_id in self._attached
                )
                if not busy:
                    # re-read status under the lock: a stale pre-lock
                    # read could race job completion and re-run a
                    # SUCCEEDED job
                    status = self.jobs.status(job_id)
                    if (
                        status == JobStatus.SUCCEEDED
                        and DPWorld.from_env() is None
                    ):
                        return {
                            "status": status.value,
                            "resumed": False,
                            "detail": "job already succeeded",
                        }
                    # Under DP, EVERY rank re-queues on resume —
                    # including rank 0 and even when locally
                    # SUCCEEDED. A worker's SUCCEEDED only means "my
                    # shard streamed" (the authoritative state is the
                    # coordinator's), and a refusing coordinator would
                    # leave re-queued workers retrying a port nobody
                    # serves until timeout. The re-run is a cheap no-op
                    # round: the coordinator's resume set already
                    # contains every row, so all shards are empty and
                    # the job re-finalizes identically.
                    # fetch BEFORE registering as queued: a raise here
                    # must not leave the id poisoning _queued
                    rec = self.jobs.get(job_id)
                    seq = self._reserve_queue_entry(
                        rec.job_priority, job_id
                    )
                    break
            # terminal status + still "current": the worker is in its
            # epilogue — wait for it to let go rather than refusing a
            # resume the caller can see is legitimate
            if not status.is_terminal() or time.monotonic() > deadline:
                return {"status": status.value, "resumed": False,
                        "detail": "job is already queued or running"}
            time.sleep(0.02)
            status = self.jobs.status(job_id)
        try:
            self._cancel.discard(job_id)
            self.metrics.drop(job_id)  # fresh stream for the re-run
            self.jobs.set_status(
                job_id, JobStatus.QUEUED, failure_reason=None
            )
            self._queue.put((rec.job_priority, seq, job_id))
        except Exception:
            with self._lock:
                self._queued.discard(job_id)
                self._queued_prio.pop(job_id, None)
            raise
        # mirror the session's resume filter: cancelled-truncated rows
        # are regenerated, so they don't count as already done
        done = sum(
            1
            for reason in self.jobs.read_partial_meta(job_id).values()
            if reason != "cancelled"
        )
        return {
            "status": JobStatus.QUEUED.value,
            "resumed": True,
            "rows_already_done": done,
        }

    def get_quotas(self) -> List[Dict[str, int]]:
        return self.jobs.get_quotas()

    def try_authentication(self) -> Dict[str, Any]:
        return {"authenticated": True}  # local engine needs no key

    def _dump_telemetry(self, job_id: str) -> None:
        """Flight-recorder postmortem on job failure (best-effort)."""
        if telemetry.enabled():
            telemetry.TRACES.end_trace(f"tr-{job_id}", "error")
        telemetry.dump_job(self.jobs._dir(job_id), job_id)

    def job_telemetry(
        self, job_id: str, write: bool = True
    ) -> Dict[str, Any]:
        """Per-job telemetry document: the flight recorder's span
        timeline for this job plus its exact counters (rows by outcome,
        tokens in/out). ``write`` persists it as
        ``jobs/<job_id>/telemetry.json`` (the same artifact the engine
        dumps when a job FAILs). Falls back to a previously persisted
        dump when this process has no live state for the job (engine
        restarted)."""
        self.jobs.get(job_id)  # KeyError when unknown
        doc = telemetry.job_doc(job_id)
        if not doc["spans"] and not doc["counters"]:
            persisted = telemetry.load_job_dump(self.jobs._dir(job_id))
            if persisted is not None:
                return persisted
        if write and telemetry.enabled():
            telemetry.dump_job(self.jobs._dir(job_id), job_id)
        return doc

    def get_trace(self, ident: str) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable) for ``ident``: a
        forensics trace id (``tr-...``), a job id whose trace is still
        in the ring, or a plain job id, which renders the job's whole
        flight record instead. KeyError when unknown."""
        from ..telemetry import doctor, traceexport

        doc = telemetry.TRACES.doc(ident)
        if doc is None and not ident.startswith("tr-"):
            doc = telemetry.TRACES.doc(f"tr-{ident}")
        if doc is not None:
            chrome = traceexport.trace_to_chrome(doc)
            chrome["otherData"]["verdict"] = doctor.diagnose_request(doc)
            return chrome
        # fall back to the whole-job flight record
        jid = ident[3:] if ident.startswith("tr-") else ident
        jdoc = telemetry.job_doc(jid)
        if not jdoc["spans"] and not jdoc["counters"]:
            persisted = None
            try:
                self.jobs.get(jid)
                persisted = telemetry.load_job_dump(self.jobs._dir(jid))
            except KeyError:
                pass
            if persisted is None:
                raise KeyError(f"no trace or job telemetry for {ident!r}")
            jdoc = persisted
        return traceexport.job_doc_to_chrome(jdoc)

    def diagnose_job(self, job_id: str) -> Dict[str, Any]:
        """Bottleneck doctor: the job's telemetry document analyzed into
        stage attribution, roofline grades against the device kind the
        runner reported (``engine/roofline.py``), and one named verdict
        with evidence lines."""
        from ..telemetry import doctor

        rec = self.jobs.get(job_id)
        return doctor.diagnose(
            self.job_telemetry(job_id, write=False),
            status=rec.status,
            num_rows=rec.num_rows,
        )

    def fleet_state(self) -> Dict[str, Any]:
        """Load and readiness report (served as a ``fleet_state`` frame
        by ``GET /fleet-state``). Cheap: lock-held counter reads only."""
        with self._lock:
            queued = len([j for j in self._queued if not j.startswith("serve:")])
            running = len([j for j in self._attached if not j.startswith("serve:")])
            cur = self._current_job
            if cur is not None and not cur.startswith("serve:"):
                running += 1
            models = sorted(self._runner_cache.keys())
        gw = self.gateway
        return {
            "ready": True,
            "draining": bool(gw is not None and gw.draining),
            "load": {
                "jobs_queued": queued,
                "jobs_running": running,
                "interactive_active": gw.active_count() if gw is not None else 0,
                "interactive_slots": int(getattr(self.ecfg, "interactive_slots", 0)),
            },
            "models": models,
        }

    # -- live monitor (telemetry/monitor.py) ---------------------------

    def _monitor_jobs(self) -> List[Tuple[str, str]]:
        """RUNNING jobs for the monitor's continuous doctor: the
        worker's current job plus every co-batched attached job
        (serve-wake sentinels excluded — the interactive tier is
        monitored through its own histograms, not job records)."""
        with self._lock:
            ids = set(self._attached)
            if self._current_job is not None:
                ids.add(self._current_job)
        return [
            (jid, JobStatus.RUNNING.value)
            for jid in sorted(ids)
            if not jid.startswith("serve:")
        ]

    def _live_kv_tiers(self) -> List[Any]:
        """Live tier pools for the autotuner's kv_tier_host_pages
        actuation (pools built after a move read the knob off ecfg)."""
        with self._lock:
            return list(self._kv_tiers.values())

    def _monitor_alert_dump(
        self, job_id: str, alert: Dict[str, Any]
    ) -> None:
        """A firing alert persists the flight recorder next to the job
        — the same ``telemetry.json`` artifact FAILED leaves, written
        while the incident is live. Covered by the alert-dump leg of
        the ``telemetry.monitor`` fault site."""
        if faults.ACTIVE is not None:
            faults.inject("telemetry.monitor", job=job_id)
        telemetry.dump_job(self.jobs._dir(job_id), job_id)

    def monitor_doc(self) -> Dict[str, Any]:
        """The ``GET /monitor`` document (history + active alerts +
        live doctor verdicts, and the control plane's ``enforcement``
        section when it is on). KeyError when the monitor is disabled
        (telemetry off or SUTRO_MONITOR=0) — the server maps it to 404."""
        if self.monitor is None:
            raise KeyError(
                "live monitor disabled (SUTRO_TELEMETRY=0 or "
                "SUTRO_MONITOR=0)"
            )
        doc = self.monitor.snapshot_doc()
        if self.control is not None:
            doc["enforcement"] = self.control.snapshot()
        return doc

    def job_fleet(self, job_id: str) -> Dict[str, Any]:
        """Elastic dp fleet view: the coordinator's live membership
        snapshot while this process serves the job's round (per-rank
        state, row ownership, requeue/steal counters), else the
        snapshot persisted at round end (``jobs/<id>/fleet.json``).
        Jobs that never ran an elastic round report
        ``{"elastic": False}``."""
        self.jobs.get(job_id)  # KeyError -> 404 upstream if unknown
        snap = fleet_view(job_id)
        if snap is not None:
            snap["live"] = True
            return snap
        path = self.jobs._dir(job_id) / "fleet.json"
        if path.exists():
            try:
                snap = json.loads(path.read_text())
                snap["live"] = False
                return snap
            except (OSError, ValueError) as e:
                logger.warning(
                    "unreadable fleet.json for %s: %s", job_id, e
                )
        return {"job_id": job_id, "elastic": False}

    def _persist_fleet(self, job_id: str) -> None:
        """Coordinator round end: persist the final membership snapshot
        (``jobs/<id>/fleet.json``) and stamp a doctor-readable summary
        into the job's telemetry attrs. Best-effort — fleet bookkeeping
        must never change a round's outcome."""
        snap = fleet_view(job_id)
        if snap is None:
            return
        try:
            path = self.jobs._dir(job_id) / "fleet.json"
            tmp = path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(snap, indent=2))
            tmp.replace(path)
        except OSError:
            logger.warning(
                "fleet snapshot persist failed for %s", job_id,
                exc_info=True,
            )
        if telemetry.enabled():
            ranks = snap.get("ranks", {})
            c = snap.get("counters", {})
            telemetry.job(job_id).attrs["dp_fleet"] = {
                "live_ranks": snap.get("live_ranks", 0),
                "requeued_rows": c.get("requeued_rows", 0),
                "stolen_rows": c.get("stolen_rows", 0),
                "duplicate_results_dropped": c.get(
                    "duplicate_results_dropped", 0
                ),
                "lost_ranks": sorted(
                    r for r, v in ranks.items()
                    if v.get("state") == "lost"
                ),
                "drained_ranks": sorted(
                    r for r, v in ranks.items()
                    if v.get("state") == "drained"
                ),
                "late_joiners": sorted(
                    r for r, v in ranks.items() if v.get("late_join")
                ),
            }

    # ------------------------------------------------------------------
    # Worker
    # ------------------------------------------------------------------

    def _weights_dir_for(self, engine_key: str) -> Optional[str]:
        if self.ecfg.weights_dir:
            cand = os.path.join(self.ecfg.weights_dir, engine_key)
            if os.path.isdir(cand):
                return cand
        return None

    def _get_tokenizer(
        self, engine_key: str, mcfg: ModelConfig
    ) -> BaseTokenizer:
        """Tokenizer WITHOUT building the runner (quota gate / dry runs
        must not pay model init). Called from the worker loop AND the
        attach-build thread: cache lookups/publishes hold
        ``self._lock``; the build itself runs unlocked."""
        with self._lock:
            cached = self._runner_cache.get(engine_key)
            if cached is not None:
                return cached[1]
            tok = self._tok_cache.get(engine_key)
        if tok is None:
            tok = load_tokenizer(
                self._weights_dir_for(engine_key),
                vocab_size=mcfg.vocab_size,
            )
            with self._lock:
                tok = self._tok_cache.setdefault(engine_key, tok)
        return tok

    def _get_runner(
        self, engine_key: str, mcfg: ModelConfig
    ) -> Tuple[ModelRunner, BaseTokenizer]:
        with self._lock:
            cached = self._runner_cache.get(engine_key)
        if cached is not None:
            return cached
        # only the worker thread builds runners, so the unlocked build
        # below cannot double-build
        weights_dir = self._weights_dir_for(engine_key)
        tok = self._get_tokenizer(engine_key, mcfg)
        evicted_store = evicted_tier = None
        with self._lock:
            # keep at most two runners resident (device memory budget);
            # the evicted runner is dropped BEFORE the new one is built.
            # Its KV pool dies with it, so its prefix store and tier
            # pool close too
            if len(self._runner_cache) >= 2:
                evicted = next(iter(self._runner_cache))
                self._runner_cache.pop(evicted)
                evicted_store = self._prefix_stores.pop(evicted, None)
                evicted_tier = self._kv_tiers.pop(evicted, None)
        if evicted_store is not None:
            evicted_store.close()
        if evicted_tier is not None:
            evicted_tier.close()
        # the runner loads the checkpoint: on a mesh each rank reads its
        # own block of it
        runner = ModelRunner(
            mcfg, self.ecfg, device=self.device, checkpoint=weights_dir or None
        )
        with self._lock:
            self._runner_cache[engine_key] = (runner, tok)
        return runner, tok

    def _prefix_store_for(self, engine_key: str):
        """The engine-lifetime radix prefix store for this runner, or
        None when ``SUTRO_PREFIX_STORE`` / ``EngineConfig.prefix_store``
        turn it off — the scheduler then runs the per-job prefix path."""
        if not _env_switch("SUTRO_PREFIX_STORE", getattr(self.ecfg, "prefix_store", True)):
            return None
        with self._lock:
            store = self._prefix_stores.get(engine_key)
            if store is None:
                from .prefixstore import PrefixStore

                store = self._prefix_stores[engine_key] = PrefixStore(
                    self.ecfg.kv_page_size
                )
        return store

    def _kv_tier_for(self, engine_key: str):
        """The engine-lifetime tiered KV pool (device -> host -> disk)
        for this runner, or None when ``SUTRO_KV_TIERS`` /
        ``EngineConfig.kv_tiers`` (off by default) turn it off — every
        demote, promote and hibernate path is then dead code."""
        if not _env_switch("SUTRO_KV_TIERS", getattr(self.ecfg, "kv_tiers", False)):
            return None
        with self._lock:
            tier = self._kv_tiers.get(engine_key)
            if tier is None:
                from .config import sutro_home
                from .kvtier import KVTierPool

                disk_dir = None
                if getattr(self.ecfg, "kv_tier_disk", True):
                    disk_dir = sutro_home() / "kvtier"
                tier = self._kv_tiers[engine_key] = KVTierPool(
                    self.ecfg.kv_page_size,
                    host_pages=getattr(self.ecfg, "kv_tier_host_pages", 4096),
                    disk_dir=disk_dir,
                )
        return tier

    def prefix_warm_tokens(self, engine_key: str, ids) -> int:
        """Non-mutating warm-prefix probe for the serving gateway: how
        many leading tokens of ``ids`` already have resident KV. Zero
        when the store is off or cold — never raises."""
        with self._lock:
            store = self._prefix_stores.get(engine_key)
        if store is None:
            return 0
        try:
            return store.peek(ids)
        except Exception:  # graftlint: disable=silent-except
            # a probe never fails a submit
            return 0

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the worker thread with a bounded join. The sentinel
        sorts ahead of every real job, so an idle worker exits
        immediately; a worker mid-job finishes that job first and the
        join may time out — the thread is daemonic either way. Returns
        True when the worker actually exited. The monitor stops, the
        prefix stores close (a closed store refuses extends, so a racing
        session runs the storeless path) and the tier pools park their
        migration workers."""
        if self.monitor is not None:
            self.monitor.stop()
        self._queue.put(_WORKER_STOP)
        self._worker.join(timeout=timeout)
        with self._lock:
            stores = list(self._prefix_stores.values())
            self._prefix_stores.clear()
            tiers = list(self._kv_tiers.values())
            self._kv_tiers.clear()
        for store in stores:
            store.close()
        for tier in tiers:
            tier.close()
        return not self._worker.is_alive()

    def _worker_loop(self) -> None:
        while True:
            _, _, job_id = self._queue.get()
            if job_id is None:  # close() sentinel
                return
            with self._lock:
                self._queued.discard(job_id)
                self._queued_prio.pop(job_id, None)
                self._current_job = job_id
            if job_id.startswith("serve:"):
                # serving-wake sentinel: run an interactive session for
                # the key (no job record, no jobstore epilogue)
                engine_key = job_id[6:]
                if self.gateway is not None:
                    self.gateway.sentinel_popped(engine_key)
                try:
                    self._run_serving_session(engine_key)
                except Exception:  # noqa: BLE001 — session isolation
                    traceback.print_exc()
                finally:
                    with self._lock:
                        self._current_job = None
                continue
            if telemetry.enabled():
                with self._lock:
                    n_attached = len(self._attached)
                telemetry.JOBS_RUNNING.set(1 + n_attached)
            requeue_priority = None
            try:
                if job_id in self._cancel:
                    self.jobs.set_status(job_id, JobStatus.CANCELLED)
                    continue
                requeue_priority = self._run_job(job_id)
            except Exception as e:  # noqa: BLE001 — job isolation boundary
                traceback.print_exc()
                # terminal failure_log entry BEFORE the status flip, so
                # a watcher that sees FAILED also sees why
                self.jobs.append_failure_log(
                    job_id,
                    {"event": "job_failed",
                     "error": f"{type(e).__name__}: {e}"},
                )
                self._dump_telemetry(job_id)
                try:
                    self.jobs.set_status(
                        job_id,
                        JobStatus.FAILED,
                        failure_reason={"message": f"{type(e).__name__}: {e}"},
                    )
                except Exception:
                    pass
            finally:
                if requeue_priority is None:
                    # finish metrics BEFORE releasing _current_job:
                    # resume_job waits on _current_job
                    self.metrics.job(job_id).finish()
                else:
                    # preempted: keep the metrics stream alive and
                    # requeue BEFORE releasing _current_job so a
                    # concurrent resume_job can never double-enqueue
                    self.jobs.set_status(job_id, JobStatus.QUEUED)
                    self._enqueue(requeue_priority, job_id)
                with self._lock:
                    self._current_job = None
                if telemetry.enabled():
                    with self._lock:
                        n_attached = len(self._attached)
                    telemetry.JOBS_RUNNING.set(n_attached)

    def _run_job(self, job_id: str) -> Optional[int]:
        """Run one job to a terminal state. Returns None normally, or
        the job's priority when it yielded to a higher-priority job (the
        worker loop requeues it). Generation jobs run as a CO-BATCHED
        session (``_run_cobatch_session``)."""
        rec = self.jobs.get(job_id)
        self.jobs.set_status(job_id, JobStatus.STARTING)
        engine_key, mcfg, meta = resolve_model(rec.model)
        if rec.stages:
            # stage-graph job (engine/stagegraph.py): the whole DAG —
            # map waves, host reduces, per-stage chunk stores, resume —
            # runs inside the runner; same return contract as below
            # (None, or the job's priority on yield)
            from .stagegraph import StageGraphRunner

            return StageGraphRunner(self, job_id, rec).run()

        if rec.dry_run:
            # dry runs tokenize only: no runner is built
            tok = self._get_tokenizer(engine_key, mcfg)
            inputs = self.jobs.read_inputs(job_id)
            sampling = rec.sampling_params or {}
            max_new = int(
                sampling.get("max_new_tokens", self.ecfg.max_new_tokens)
            )
            input_tokens = int(
                sum(
                    len(ids)
                    for ids in encode_chat_batch(
                        tok,
                        inputs,
                        rec.system_prompt,
                        mcfg.chat_template,
                        threads=self.ecfg.tokenize_threads,
                    )
                )
            )
            est_out = rec.num_rows * max_new
            self.jobs.update(
                job_id,
                cost_estimate=estimate_cost(engine_key, input_tokens, est_out),
                input_tokens=input_tokens,
            )
            self.jobs.set_status(job_id, JobStatus.SUCCEEDED)
            return None

        runner, tok = self._get_runner(engine_key, mcfg)
        if telemetry.enabled():
            # the doctor's roofline denominator: device kind + model
            # byte counts land in the job's flight-recorder attrs
            telemetry.job(job_id).attrs["device"] = runner.device_info()

        if mcfg.head == "embedding":
            token_rows = [
                np.array(ids, np.int32)
                for ids in encode_chat_batch(
                    tok,
                    self.jobs.read_inputs(job_id),
                    rec.system_prompt,
                    mcfg.chat_template,
                    threads=self.ecfg.tokenize_threads,
                )
            ]
            self.jobs.set_status(job_id, JobStatus.RUNNING)
            return self._run_embedding_job(
                job_id, rec, runner, token_rows, self.metrics.job(job_id)
            )

        sess = _GenSession(self, job_id, rec, engine_key, mcfg, meta, tok)
        self.jobs.set_status(job_id, JobStatus.RUNNING)
        batcher = ContinuousBatcher(
            runner,
            stop_ids=getattr(tok, "stop_ids", lambda: [tok.eos_id])(),
            seed=self.ecfg.seed,
            token_bytes=sess.token_bytes,
            prefix_store=self._prefix_store_for(engine_key),
            kv_tier=self._kv_tier_for(engine_key),
        )
        if self.control is not None:
            batcher.ladder = self.control.ladder
        from .profiling import job_trace

        dp = DPWorld.from_env()
        # on this thread: the one that runs the batcher (torch.profiler
        # records CPU ops only on the thread that started it)
        with job_trace(self.ecfg.profile_dir, job_id, runner.device):
            if dp is not None:
                return self._run_dp_generation(job_id, rec, sess, batcher, dp)
            return self._run_cobatch_session(job_id, engine_key, sess, batcher)

    def _run_dp_generation(self, job_id, rec, sess, batcher, dp) -> Optional[int]:
        """One rank's part of a data-parallel generation job: this
        process runs its share of the rows on its own device; rank 0
        merges every rank's stream through the jobstore (order-preserving
        by row_id). Priority preemption and cross-job co-batching are
        per-rank concerns and disabled for DP jobs — yielding or
        multiplexing one rank of a job that spans them all would stall,
        not help, the job. Returns the session contract's value (None,
        or the priority after a yield)."""
        # deterministic cross-rank job identity (job_ids are
        # per-process): guards the channel against rank-queue divergence
        # merging one job's rows into another. ALL inputs feed the hash
        # (length-delimited) — two jobs differing only in middle rows
        # must not share a key. SUTRO_DP_SECRET (optional, same value on
        # every rank) seeds the hash so the key is not derivable from
        # job content alone (dphost.py trust model).
        h = hashlib.sha256(os.environ.get("SUTRO_DP_SECRET", "").encode())
        h.update(
            json.dumps(
                [
                    rec.model,
                    rec.num_rows,
                    sess.sampling,
                    rec.system_prompt,
                    rec.output_schema,
                ],
                sort_keys=True,
                default=str,
            ).encode()
        )
        for row in sess.inputs:
            rb = str(row).encode()
            h.update(f"{len(rb)}:".encode())
            h.update(rb)
        job_key = h.hexdigest()[:16]
        # row retries ride the shard-owning rank's batcher; row events
        # reach the coordinator's failure_log via the channel's fault
        # messages (dphost). job_id tags the run's spans so the
        # shipped/merged timeline is attributable to this job
        run_shard = functools.partial(
            batcher.run, row_retries=self.ecfg.row_retries, job_id=job_id,
        )
        # the whole request pool goes down — elastic rounds re-shard it
        # dynamically (rank 0 strides its own share; workers receive row
        # assignments in the handshake)
        outcome = self._dp_dispatch(
            dp, run_shard, sess.requests,
            job_id=job_id, job_key=job_key,
            on_result=sess.on_result,
            on_progress=sess.on_progress,
            should_cancel=sess.should_cancel,
            on_row_event=sess.on_row_event,
            # the coordinator's partial store holds every rank's flushed
            # rows — the done set lets relaunched workers resume
            # row-granularly
            done_rows=set(sess.done), num_rows=rec.num_rows,
        )
        if outcome is None:  # worker rank: terminal status set
            return None
        sess.flush()
        if sess.cancelled["flag"]:
            self.jobs.set_status(job_id, JobStatus.CANCELLED)
            return None
        if outcome == "yielded":
            return rec.job_priority
        sess.finalize_completed(batcher)
        return None

    def _run_serving_session(self, engine_key: str) -> None:
        """Serving-only co-batch session: no primary batch job, just
        interactive requests adopted through the gateway (plus any
        same-model batch jobs that attach mid-session through the
        queue scan)."""
        gw = self.gateway
        if gw is None or not gw.has_pending(engine_key):
            return
        mcfg = MODEL_CONFIGS.get(engine_key)
        if mcfg is None:
            return
        runner, tok = self._get_runner(engine_key, mcfg)
        batcher = ContinuousBatcher(
            runner,
            stop_ids=getattr(tok, "stop_ids", lambda: [tok.eos_id])(),
            seed=self.ecfg.seed,
            token_bytes=_token_bytes_of(tok),
            prefix_store=self._prefix_store_for(engine_key),
            kv_tier=self._kv_tier_for(engine_key),
        )
        if self.control is not None:
            batcher.ladder = self.control.ladder
        self._run_cobatch_session(None, engine_key, None, batcher)

    def _run_cobatch_session(
        self, job_id: Optional[str], engine_key: str,
        sess: "Optional[_GenSession]", batcher,
    ) -> Optional[int]:
        """Drive the primary job and any attachable queued same-model
        jobs through ONE scheduler session (cross-job co-batching).
        Returns the primary's requeue priority on preemption yield, else
        None (each job's terminal state is set as it finishes).

        ``sess=None`` runs a serving-only session
        (``_run_serving_session``): the loop starts empty and lives off
        gateway adoptions. Either way, when a gateway exists its parked
        interactive requests are adopted ahead of the queue scan — they
        are 1-row priority -1 ctxs whose results ride the per-request
        channel, not a session."""
        sessions: Dict[str, _GenSession] = {}
        if sess is not None:
            sess.session_job = job_id
            sessions[job_id] = sess
        # live interactive ctxs by request id (gateway-owned lifecycle)
        iactive: Dict[str, Any] = {}
        gw = self.gateway
        # in-flight attach build: session construction tokenizes every
        # input row, so it runs on a BACKGROUND thread — the scheduler
        # loop keeps decoding live jobs while an attach prepares. One
        # build at a time also rate-limits cascading attaches.
        build: Dict[str, Any] = {}

        def _build_session(jid: str, seq: int) -> None:
            try:
                rec2 = self.jobs.get(jid)
                self.jobs.set_status(jid, JobStatus.STARTING)
                _key2, mcfg2, meta2 = resolve_model(rec2.model)
                tok2 = self._get_tokenizer(_key2, mcfg2)
                s2 = _GenSession(
                    self, jid, rec2, _key2, mcfg2, meta2, tok2, seq=seq
                )
                s2.session_job = job_id
                self.jobs.set_status(jid, JobStatus.RUNNING)
                build["session"] = s2
            except Exception as e:  # noqa: BLE001 — job isolation
                traceback.print_exc()
                self.jobs.append_failure_log(
                    jid,
                    {"event": "job_failed",
                     "error": f"{type(e).__name__}: {e}"},
                )
                self._dump_telemetry(jid)
                try:
                    self.jobs.set_status(
                        jid,
                        JobStatus.FAILED,
                        failure_reason={
                            "message": f"{type(e).__name__}: {e}"
                        },
                    )
                except Exception:
                    pass
                self.metrics.job(jid).finish()
                with self._lock:
                    self._attached.discard(jid)
            finally:
                build["done"] = True

        def poll_new():
            # latency-priority adoption: a parked interactive request
            # enters the live window before any queued batch job
            if gw is not None:
                ictx = gw.take_pending(engine_key)
                if ictx is not None:
                    iactive[ictx.job_id] = ictx
                    return ictx
            if build:
                if not build.get("done"):
                    return None  # build in flight; keep decoding
                s2 = build.get("session")
                build.clear()
                if s2 is not None:
                    sessions[s2.job_id] = s2
                    return s2.ctx
                return None
            pop = self._pop_attachable(engine_key)
            if pop is None:
                return None
            jid, seq = pop
            with self._lock:
                self._attached.add(jid)
            t = threading.Thread(
                target=_build_session, args=(jid, seq), daemon=True,
                name=f"sutro-attach-{jid}",
            )
            build["thread"] = t
            t.start()
            return None

        def _drain_pending_build() -> None:
            """The session is ending with an attach build possibly in
            flight: wait for it, then REQUEUE the job (it was pulled
            from the queue but never ran a row — resume semantics make
            the requeue exact)."""
            if not build:
                return
            t = build.get("thread")
            if t is not None:
                t.join(timeout=600)
            s2 = build.get("session")
            build.clear()
            if s2 is None:
                return  # build failed: terminal status already set
            self.jobs.set_status(s2.job_id, JobStatus.QUEUED)
            self._enqueue(s2.rec.job_priority, s2.job_id)
            with self._lock:
                self._attached.discard(s2.job_id)

        def on_job_done(ctx, outcome: str) -> None:
            if ctx.job_id in iactive:
                iactive.pop(ctx.job_id, None)
                stats = gw.finish(ctx, outcome)
                if stats:
                    # doctor evidence: co-resident batch jobs record the
                    # interactive traffic they shared the window with
                    for s2 in sessions.values():
                        if s2.finalized or s2.jtel is None:
                            continue
                        ia = s2.jtel.attrs.setdefault(
                            "interactive",
                            {"requests": 0, "starved": 0, "ttft_max_s": 0.0},
                        )
                        ia["requests"] += 1
                        if stats.get("starved"):
                            ia["starved"] += 1
                        if stats.get("ttft_s") is not None:
                            ia["ttft_max_s"] = max(
                                ia["ttft_max_s"], round(stats["ttft_s"], 3)
                            )
                return
            s = sessions[ctx.job_id]
            if s.jtel is not None and (ctx.prefix_saved or ctx.prefix_paid):
                # saved-vs-paid shared-prefix prefill attribution
                s.jtel.attrs["prefix"] = {
                    "saved_tokens": int(ctx.prefix_saved),
                    "paid_tokens": int(ctx.prefix_paid),
                }
            if s.jtel is not None and ctx.stats.get("preempted"):
                ia = s.jtel.attrs.setdefault(
                    "interactive",
                    {"requests": 0, "starved": 0, "ttft_max_s": 0.0},
                )
                ia["preempted_rows"] = ctx.stats["preempted"]
            if s.jtel is not None and batcher._kv_tier is not None:
                # doctor evidence: the kv_pressure / resume_bound
                # verdicts key off this (telemetry/doctor.py)
                s.jtel.attrs["kv_tier"] = {
                    "demotes": int(batcher.tier_demotes),
                    "promotes": int(batcher.tier_promotes),
                    "resumes_upload": int(ctx.stats.get("resumes_upload", 0)),
                    "resumes_reprefill": int(ctx.stats.get("resumes_reprefill", 0)),
                }
            # NO try/finally: a raised finalize must leave ``finalized``
            # False so the session-error path below — or the worker
            # loop for the primary — marks the job FAILED resumably
            if outcome == "completed":
                s.finalize_completed(batcher)
            else:
                s.finalize_cancelled()
            s.finalized = True
            if ctx.job_id != job_id:
                # the worker loop's epilogue only covers the primary;
                # attached jobs close out here
                self.metrics.job(ctx.job_id).finish()
                with self._lock:
                    self._attached.discard(ctx.job_id)

        def should_yield() -> bool:
            live = [
                s.ctx.priority for s in sessions.values() if not s.finalized
            ]
            # a live interactive request (priority -1) outranks every
            # queued batch job, so min(live) = -1 pins the session
            live += [c.priority for c in iactive.values() if not c.done]
            if not live:
                return False
            return self._unattachable_higher_waiting(min(live), engine_key)

        def _fail_live_interactive(outcome: str) -> None:
            for c in list(iactive.values()):
                if not c.done:
                    gw.finish(c, outcome)
            iactive.clear()

        try:
            state = batcher.run_multi(
                [sess.ctx] if sess is not None else [],
                on_job_done=on_job_done,
                poll_new=poll_new,
                should_yield=should_yield,
            )
        except Exception:
            _drain_pending_build()
            # live interactive requests have no resumable record: their
            # channels get the error and the client retries
            _fail_live_interactive("error")
            # fail attached non-terminal jobs; the worker loop's except
            # handles the primary — unless the primary already reached a
            # terminal state, in which case swallow (don't flip it)
            for jid2, s2 in list(sessions.items()):
                if s2.finalized or jid2 == job_id:
                    continue
                try:
                    s2.flush()
                except Exception:
                    logger.warning(
                        "partial flush failed while failing attached "
                        "job %s", jid2, exc_info=True,
                    )
                self.jobs.append_failure_log(
                    jid2,
                    {"event": "job_failed",
                     "error": "co-batched session error"},
                )
                self._dump_telemetry(jid2)
                try:
                    self.jobs.set_status(
                        jid2,
                        JobStatus.FAILED,
                        failure_reason={"message": "co-batched session error"},
                    )
                except Exception:
                    pass
                self.metrics.job(jid2).finish()
                with self._lock:
                    self._attached.discard(jid2)
            if sess is None or sessions[job_id].finalized:
                # a serving-only session has no primary for the worker
                # loop's epilogue to fail: the error is handled here
                traceback.print_exc()
                return None
            raise
        _drain_pending_build()
        if state == "yielded":
            # interactive ctxs cannot suspend and resume (their consumer
            # is a live stream); only reachable if something outranks
            # priority -1, which the public surface never produces
            _fail_live_interactive("error")
            requeue = None
            for jid2, s2 in list(sessions.items()):
                if s2.finalized:
                    continue
                s2.flush()
                if jid2 == job_id:
                    requeue = s2.rec.job_priority  # worker requeues
                else:
                    # metrics stream stays alive across the preemption
                    self.jobs.set_status(jid2, JobStatus.QUEUED)
                    self._enqueue(s2.rec.job_priority, jid2)
                    with self._lock:
                        self._attached.discard(jid2)
            return requeue
        return None


    def _dp_dispatch(
        self, dp, run_shard, pool, *, job_id, job_key, on_result,
        on_progress, should_cancel, done_rows, num_rows,
        on_row_event=None,
    ) -> Optional[str]:
        """Execute one rank's share of a DP job. ``pool`` is the FULL
        request pool (not a pre-strided shard): elastic rounds re-shard
        it dynamically, so every rank needs the whole row universe —
        rank 0 strides its own share, workers run the row assignment
        received in the handshake (falling back to their stride against
        a pre-elastic coordinator). Returns the outcome on rank 0
        (coordinator: merges every rank through ``on_result``), or None
        on worker ranks after setting their terminal status — single
        policy copy for the generation AND embedding paths
        (never-served sentinel, CANCELLED-not-FAILED worker mapping,
        preemption-drain mapping, full-resume round skip).

        Distributed telemetry rides the channel here: rank 0 stamps a
        trace context into the round and ingests every worker's
        piggybacked shard (telemetry/distributed.py); worker ranks open
        the round under the received context and ship their bounded
        span/metrics shard on the terminal frame."""
        tel_on = telemetry.enabled()
        if dp.rank == 0:
            tele_ctx = None
            on_worker_tele = None
            if tel_on:
                round_no = distributed.REMOTE.next_round(job_id)
                tele_ctx = distributed.trace_context(job_id, round_no)

                def on_worker_tele(rank: int, shard: Dict) -> None:
                    distributed.REMOTE.ingest(job_id, rank, shard)

            if len(done_rows) >= num_rows:
                # resume of a fully-merged job: serve a TRIVIAL round
                # (bind, send resume-all, drain dones briefly) so
                # pod-wide re-queued workers finish as SUCCEEDED no-ops
                # instead of spinning their full accept timeout against
                # an unbound port; workers that were not re-queued are
                # not expected and not errors
                if not serve_resume_round(
                    dp, job_key=job_key, done_rows=done_rows,
                    tele_ctx=tele_ctx, on_worker_tele=on_worker_tele,
                ):
                    # port held by a dying predecessor through every
                    # bind retry: the job's rows are all merged, so
                    # still complete — record why re-queued workers
                    # may spin until their accept deadline
                    self.jobs.append_failure_log(
                        job_id,
                        {"event": "dp_resume_round_unserved",
                         "message": (
                             "coordinator port busy through bind "
                             "retries; re-queued workers retry until "
                             "their accept deadline — resume again "
                             "once the port frees"
                         )},
                    )
                return "completed"
            shard = shard_requests(pool, 0, dp.world)
            try:
                if tel_on:
                    with telemetry.RECORDER.span(
                        "dp_round", job_id, world=dp.world,
                        shard_rows=len(shard),
                    ):
                        t0 = time.monotonic()
                        try:
                            return run_dp_coordinator(
                                dp, run_shard, shard,
                                on_result=on_result,
                                on_progress=on_progress,
                                should_cancel=should_cancel,
                                job_key=job_key,
                                done_rows=done_rows,
                                on_row_event=on_row_event,
                                tele_ctx=tele_ctx,
                                on_worker_tele=on_worker_tele,
                                requests=pool,
                                job_id=job_id,
                            )
                        finally:
                            telemetry.stage_observe(
                                "dp_round", time.monotonic() - t0
                            )
                return run_dp_coordinator(
                    dp, run_shard, shard,
                    on_result=on_result,
                    on_progress=on_progress,
                    should_cancel=should_cancel,
                    job_key=job_key,
                    done_rows=done_rows,
                    on_row_event=on_row_event,
                    requests=pool,
                    job_id=job_id,
                )
            finally:
                # round over (any outcome): persist the final fleet
                # snapshot next to the job record and stamp the doctor
                # summary before the live registry entry ages out
                self._persist_fleet(job_id)
        if tel_on:
            # the worker's results leave through the channel, not
            # through the session's on_result — tally shard rows into
            # the LOCAL per-job counters so the shipped shard reports
            # what this rank executed. Registry rows_total is NOT
            # incremented here on purpose: rows count at the
            # coordinator's merge, so federated series sum to pod
            # totals instead of double-counting worker rows.
            jtel = telemetry.job(job_id)
            inner_shard = run_shard

            def run_shard(rows, *, on_result, **kw):
                def tally(res):
                    err = getattr(res, "error", None)
                    fin = str(getattr(res, "finish_reason", ""))
                    outcome = (
                        "quarantined"
                        if err is not None or fin.startswith("error")
                        else "cancelled" if fin == "cancelled"
                        else "ok"
                    )
                    jtel.add(f"rows_{outcome}")
                    on_result(res)

                # this wrapper's **kw makes dphost's signature probe
                # over-permissive; re-probe the REAL shard runner
                if "on_row_event" in kw and not _accepts_kwarg(
                    inner_shard, "on_row_event"
                ):
                    kw.pop("on_row_event")
                return inner_shard(rows, on_result=tally, **kw)

        try:
            w_outcome = run_dp_worker(
                dp, run_shard, pool,
                job_key=job_key,
                should_cancel=should_cancel,
                tele=(
                    distributed.WorkerTelemetry(job_id, dp.rank)
                    if tel_on
                    else None
                ),
                elastic=True,
            )
        except RuntimeError as e:
            if "never served" not in str(e):
                raise
            # most likely a resume of an already-complete pod job where
            # rank 0 (correctly) skipped its round. CANCELLED, not
            # FAILED: nothing ran, the record is non-authoritative, and
            # CANCELLED stays resumable.
            self.jobs.set_status(
                job_id,
                JobStatus.CANCELLED,
                failure_reason={"message": str(e)},
            )
            return None
        # worker stores are not authoritative: results live on rank 0;
        # mark the local record terminal honestly (a cancelled shard,
        # e.g. coordinator death, is not a success)
        if w_outcome == "drained":
            self.jobs.set_status(
                job_id,
                JobStatus.CANCELLED,
                failure_reason={
                    "message": (
                        "worker preempted: drained in-flight rows "
                        "to the coordinator"
                    )
                },
            )
            return None
        self.jobs.set_status(
            job_id,
            JobStatus.SUCCEEDED
            if w_outcome == "completed"
            else JobStatus.CANCELLED,
        )
        return None

    def _run_embedding_job(
        self, job_id, rec, runner, token_rows, jm
    ) -> Optional[int]:
        """Embedding path: the pooled head over length-sorted batches of
        ``max(decode_batch_size, 8)`` rows (``ModelRunner.embed_batch``).

        Row-granular durability like the generation path: vectors flush
        to the partial store every ``_PARTIAL_FLUSH_EVERY`` rows, and a
        resumed job embeds only the rows not flushed. The same mechanism
        serves cancel and preemption: between batches the job stops on
        its cancel flag, or yields (returning its priority) when a
        strictly higher-priority job is queued. Under dp the rows go
        through ``_dp_dispatch`` (rank 0 merges, workers stream theirs
        and return None). The record's ``perf`` holds this rank's
        ``embed`` device calls and the jobstore's host time."""
        bs = max(self.ecfg.decode_batch_size, 8)
        results: Dict[int, Any] = {
            i: r["outputs"] for i, r in self.jobs.read_partial(job_id).items()
        }
        pending_flush: List[Dict[str, Any]] = []
        timer = StepTimer()

        def flush() -> None:
            if pending_flush:
                with timer.time("jobstore_flush"):
                    self.jobs.flush_partial(job_id, list(pending_flush))
                pending_flush.clear()

        todo = [i for i in range(len(token_rows)) if i not in results]
        # length-sorted batches: rows in a batch pad to the batch max,
        # so similar lengths cut padding (results are keyed by row id,
        # so the output order is unaffected)
        todo.sort(key=lambda i: len(token_rows[i]))
        jm.progress(len(results))
        dp = DPWorld.from_env()
        # the runner's mesh ranks (one device each) times the dp ranks:
        # under dp the merged progress stream carries every rank's
        # throughput
        n_chips = mesh_world(runner) * (dp.world if dp is not None else 1)
        row_progress = BatchedProgress(jm, every_rows=bs)
        tel_on = telemetry.enabled()
        jtel = telemetry.job(job_id) if tel_on else None

        def record_result(r: EmbResult) -> None:
            if tel_on:
                jtel.add("rows_ok")
                telemetry.ROWS_TOTAL.inc(1.0, "ok")
            results[r.row_id] = r.vector
            pending_flush.append(
                {"row_id": r.row_id, "outputs": r.vector,
                 "cumulative_logprobs": 0.0, "finish_reason": "stop"}
            )
            if len(pending_flush) >= _PARTIAL_FLUSH_EVERY:
                flush()
            row_progress.update(len(results))

        # rows/s over the MERGED stream — under dp the coordinator's
        # rate over every rank
        rows_rate = Throughput(1)

        def embed_progress(p: Dict[str, Any]) -> None:
            tps = p.get("total_tokens_processed_per_second", 0.0)
            if tel_on:
                rows_rate.note_total(p.get("rows_completed", 0))
                telemetry.ROWS_PER_SECOND.set(
                    rows_rate.per_second(),
                    "dp" if dp is not None else "embed",
                )
                telemetry.TOKENS_PER_SECOND.set(tps)
                telemetry.TOKENS_PER_SECOND_PER_CHIP.set(tps / n_chips)
            jm.tokens(
                {
                    "input_tokens": p.get("input_tokens", 0),
                    "output_tokens": 0,
                    "total_tokens_processed_per_second": tps,
                    "tokens_per_second_per_chip": tps / n_chips,
                }
            )

        def embed_rows(
            pairs, *, on_result, on_progress=None, should_cancel=None,
            should_yield=None,
        ) -> str:
            """Embed ``pairs`` [(row_id, ids), ...] batch-wise. The one
            execution path for single-host, DP-coordinator-local, and
            DP-worker shards (dphost run_shard signature)."""
            done_n = in_toks = 0
            t0 = time.monotonic()
            for off in range(0, len(pairs), bs):
                if should_cancel and should_cancel():
                    return "cancelled"
                if should_yield and should_yield():
                    return "yielded"
                grp = pairs[off : off + bs]
                t0e = time.monotonic()
                with timer.time("embed"):
                    emb = runner.embed_batch(
                        [list(map(int, ids)) for _, ids in grp]
                    )
                if tel_on:
                    dte = time.monotonic() - t0e
                    telemetry.stage_observe("embed", dte)
                    telemetry.RECORDER.record(
                        "embed", job_id, t0e, dte, {"rows": len(grp)}
                    )
                for (i, ids), vec in zip(grp, emb.tolist()):
                    on_result(EmbResult(row_id=i, vector=vec))
                    done_n += 1
                    in_toks += len(ids)
                if on_progress:
                    dt = max(time.monotonic() - t0, 1e-9)
                    on_progress(
                        {
                            "rows_completed": done_n,
                            "input_tokens": in_toks,
                            "output_tokens": 0,
                            "total_tokens_processed_per_second":
                                in_toks / dt,
                        }
                    )
            return "completed"

        if dp is not None:
            # cross-rank identity from the tokenized rows (identical on
            # every rank: same inputs, same tokenizer); SUTRO_DP_SECRET
            # seeds it like the generation path (dphost.py trust model)
            h = hashlib.sha256(
                os.environ.get("SUTRO_DP_SECRET", "").encode()
            )
            h.update(f"embed:{rec.model}:{rec.num_rows}".encode())
            for r in token_rows:
                rb = np.asarray(r, np.int32).tobytes()
                h.update(f"{len(rb)}:".encode())
                h.update(rb)
            # full pool, not a pre-strided shard: elastic rounds
            # re-shard it dynamically (see _dp_dispatch)
            pool = [(i, token_rows[i]) for i in todo]
            outcome = self._dp_dispatch(
                dp, embed_rows, pool,
                job_id=job_id, job_key=h.hexdigest()[:16],
                on_result=record_result,
                on_progress=embed_progress,
                should_cancel=lambda: job_id in self._cancel,
                done_rows=set(results), num_rows=rec.num_rows,
                on_row_event=lambda ev: self.jobs.append_failure_log(
                    job_id, ev
                ),
            )
            if outcome is None:  # worker rank: terminal status set
                return None
        else:
            outcome = embed_rows(
                [(i, token_rows[i]) for i in todo],
                on_result=record_result,
                on_progress=embed_progress,
                should_cancel=lambda: job_id in self._cancel,
                should_yield=lambda: self._higher_priority_waiting(
                    rec.job_priority
                ),
            )
        flush()
        if outcome == "cancelled":
            self.jobs.set_status(job_id, JobStatus.CANCELLED)
            return None
        if outcome == "yielded":
            return rec.job_priority
        row_progress.flush(len(results))  # terminal count always lands
        input_tokens = int(sum(len(r) for r in token_rows))
        if tel_on:
            jtel.set("input_tokens", input_tokens)
            jtel.set("output_tokens", 0)
            telemetry.TOKENS_TOTAL.inc(float(input_tokens), "in")
        self.jobs.update(
            job_id,
            input_tokens=input_tokens,
            output_tokens=0,
            job_cost=estimate_cost(rec.engine_key, input_tokens, 0),
        )
        n = len(token_rows)
        t_fin = time.monotonic()

        def record_perf() -> None:
            # written before the status flips to SUCCEEDED
            timer.add("jobstore_finalize", time.monotonic() - t_fin)
            self.jobs.update(job_id, perf=timer.summary())

        self.jobs.finalize_results(
            job_id,
            {
                "row_id": list(range(n)),
                "outputs": [results[i] for i in range(n)],
                "cumulative_logprobs": [0.0] * n,
                "finish_reason": ["stop"] * n,
            },
            on_written=record_perf,
        )
        return None


def mesh_world(runner) -> int:
    """The devices ``runner`` runs on: its mesh's ranks, one device each
    (the reference's ``jax.device_count()`` under its default mesh over
    every device), or 1."""
    mesh = getattr(runner, "mesh", None)
    return mesh.size if mesh is not None else 1


class _GenSession:
    """Engine-side context for ONE generation job inside a (possibly
    co-batched) batcher session: prompt build, resume filter, result
    rendering/flushing, metrics, and terminal-state transitions. The
    scheduler-side half is the ``JobCtx`` this owns."""

    def __init__(
        self, eng: "LocalEngine", job_id: str, rec, engine_key: str,
        mcfg, meta, tok, seq: int = 0,
    ):
        self.eng = eng
        self.job_id = job_id
        self.rec = rec
        self.engine_key = engine_key
        self.tok = tok
        self.jm = eng.metrics.job(job_id)
        self.row_progress = BatchedProgress(
            self.jm, every_rows=eng.ecfg.decode_batch_size
        )
        self.finalized = False
        # the primary job of the session this one runs in (itself when
        # it started the session; set by the engine), recorded in perf
        self.session_job: Optional[str] = None
        # host time in the jobstore (partial flushes, finalization):
        # phases of the job's perf record
        self.store_timer = StepTimer()
        self.thinking = bool(meta.get("thinking"))
        inputs = eng.jobs.read_inputs(job_id)
        self.inputs = inputs
        sampling = rec.sampling_params or {}
        self.sampling = sampling
        max_new = int(
            sampling.get("max_new_tokens", eng.ecfg.max_new_tokens)
        )
        # stop sequences (vLLM-style sampling_params["stop"]): engine
        # detects via a rolling byte tail; exact truncation happens at
        # render time where the full decoded string exists
        raw_stop = sampling.get("stop") or []
        if isinstance(raw_stop, str):
            raw_stop = [raw_stop]
        if not all(isinstance(s, str) for s in raw_stop):
            raise ValueError(
                "sampling_params['stop'] must be a string or list of "
                f"strings, got {raw_stop!r}"
            )
        stop_strs = [s for s in raw_stop if s]
        if stop_strs and rec.output_schema:
            # a stop string can cut the constrained output mid-JSON —
            # the guaranteed-valid-JSON contract outranks it
            warnings.warn(
                "sampling_params['stop'] is ignored for output_schema "
                "jobs: stopping mid-JSON would break the schema "
                "guarantee (the schema's own closure ends generation)"
            )
            stop_strs = []
        self.stop_strs = stop_strs
        stop_seqs = [s.encode() for s in stop_strs] or None
        self.stop_seqs = stop_seqs
        # byte view of the vocab (probed once): the batcher needs it for
        # stop-seq detection of ANY co-batched job
        token_bytes = self.token_bytes = _token_bytes_of(tok)
        if stop_seqs and token_bytes is None:
            warnings.warn(
                "tokenizer lacks token_bytes; stop sequences only "
                "truncate output, they cannot end generation early"
            )

        # Prompt build: system prompt + chat template, then ONE
        # prefix-aware batched tokenize. Row-level failure domain: if
        # the batched pass raises, fall back to per-row encodes and
        # QUARANTINE only the failing rows.
        self._tel_on = telemetry.enabled()
        self.jtel = telemetry.job(job_id) if self._tel_on else None
        self.pre_quarantined: Dict[int, str] = {}
        t_tok = time.monotonic()
        self.token_rows = [
            np.array(ids, np.int32)
            for ids in self._encode_rows(inputs, rec, mcfg)
        ]
        if self._tel_on:
            telemetry.RECORDER.record(
                "tokenize", job_id, t_tok,
                time.monotonic() - t_tok, {"rows": len(inputs)},
            )
        self.input_tokens = int(sum(len(r) for r in self.token_rows))

        constraint_factory = None
        if rec.output_schema:
            from .constrain import schema_constraint_factory

            constraint_factory = schema_constraint_factory(
                rec.output_schema, tok
            )

        # cancelled rows carry truncated output — regenerate on resume.
        # Only row ids + finish reasons are held in memory; row CONTENT
        # lives in the partial chunk store and is merged back at
        # finalize (write_results_streamed).
        self.done: Dict[int, str] = {
            i: reason
            for i, reason in eng.jobs.read_partial_meta(job_id).items()
            if reason != "cancelled"
        }
        self.pending_flush: List[Dict[str, Any]] = []
        # rows whose tokenize failed never reach the scheduler: they
        # quarantine straight into the partial store as error rows
        for i, msg in self.pre_quarantined.items():
            if i in self.done:
                continue
            self.done[i] = "error"
            self.pending_flush.append(
                {"row_id": i, "outputs": None,
                 "cumulative_logprobs": 0.0, "gen_tokens": 0,
                 "finish_reason": "error", "error": msg}
            )
            self.on_row_event(
                {"event": "row_quarantined", "row_id": i,
                 "attempt": 0, "error": msg}
            )
            if self._tel_on:
                self.jtel.add("rows_quarantined")
                telemetry.ROWS_TOTAL.inc(1.0, "quarantined")

        # the resident runner's mesh ranks (one device each) times the
        # dp ranks: under engine-level DP the merged progress stream
        # carries every rank's throughput
        dp = DPWorld.from_env()
        with eng._lock:
            cached = eng._runner_cache.get(engine_key)
        self.n_chips = mesh_world(cached[0] if cached else None) * (dp.world if dp else 1)
        self._dp = dp is not None
        self.tput = Throughput(self.n_chips)
        self.rows_rate = Throughput(1)
        self.cancelled = {"flag": False}

        requests = []
        for i, ids in enumerate(self.token_rows):
            if i in self.done:
                continue
            requests.append(
                GenRequest(
                    row_id=i,
                    prompt_ids=ids,
                    max_new_tokens=max_new,
                    temperature=float(
                        sampling.get("temperature", eng.ecfg.temperature)
                    ),
                    top_p=float(sampling.get("top_p", eng.ecfg.top_p)),
                    top_k=int(sampling.get("top_k", eng.ecfg.top_k)),
                    # lazy: the FSM instantiates at ADMISSION time, on
                    # the batcher's prep thread while the device runs
                    constraint_factory=constraint_factory,
                    allow_truncate=rec.truncate_rows,
                    row_seed=(i if rec.random_seed_per_input else None),
                    stop_seqs=stop_seqs,
                    presence_penalty=float(
                        sampling.get("presence_penalty", 0.0)
                    ),
                    frequency_penalty=float(
                        sampling.get("frequency_penalty", 0.0)
                    ),
                    repetition_penalty=float(
                        sampling.get("repetition_penalty", 1.0)
                    ),
                )
            )
        self.requests = requests
        self.ctx = JobCtx(
            job_id=job_id,
            pending=list(requests),
            on_result=self.on_result,
            on_progress=self.on_progress,
            should_cancel=self.should_cancel,
            priority=int(rec.job_priority or 0),
            seq=seq,
            row_retries=eng.ecfg.row_retries,
            on_row_event=self.on_row_event,
            trace_enq_mono=time.monotonic() if self._tel_on else 0.0,
        )

    def _encode_rows(self, inputs, rec, mcfg) -> List[List[int]]:
        """Batched chat tokenize with per-row quarantine fallback.
        Quarantined rows land in ``self.pre_quarantined`` and get an
        empty token row (never admitted)."""
        eng, tok = self.eng, self.tok
        try:
            if faults.ACTIVE is not None:
                for i in range(len(inputs)):
                    faults.inject("tokenizer.encode", row=i, job=self.job_id)
            return encode_chat_batch(
                tok,
                inputs,
                rec.system_prompt,
                mcfg.chat_template,
                threads=eng.ecfg.tokenize_threads,
            )
        except Exception:  # noqa: BLE001 — row isolation: retry per row
            logger.warning(
                "batched tokenize failed for %s; per-row fallback",
                self.job_id, exc_info=True,
            )
        rows: List[List[int]] = []
        for i, row in enumerate(inputs):
            try:
                if faults.ACTIVE is not None:
                    faults.inject("tokenizer.encode", row=i, job=self.job_id)
                rows.append(
                    encode_chat_batch(
                        tok, [row], rec.system_prompt, mcfg.chat_template
                    )[0]
                )
            except Exception as e:  # noqa: BLE001 — quarantine the row
                self.pre_quarantined[i] = f"{type(e).__name__}: {e}"
                rows.append([])
        return rows

    # -- streaming callbacks (scheduler thread) ------------------------

    def on_row_event(self, event: Dict[str, Any]) -> None:
        """failure_log sink: every scheduler retry/quarantine decision
        lands on the durable job record."""
        self.eng.jobs.append_failure_log(self.job_id, dict(event))

    def render_output(self, token_ids) -> str:
        text = self.tok.decode(token_ids)
        stop_cut = False
        if self.stop_strs:
            # truncate at the FIRST occurrence of any stop string (the
            # stop string itself is excluded, vLLM semantics)
            cut = min(
                (
                    p
                    for p in (text.find(s) for s in self.stop_strs)
                    if p >= 0
                ),
                default=-1,
            )
            if cut >= 0:
                text = text[:cut]
                stop_cut = True
        if self.thinking:
            # thinking models emit {content, reasoning_content} JSON so
            # the SDK's unpack contract applies
            reasoning, sep, content = text.partition("</think>")
            if sep:
                reasoning = reasoning.replace("<think>", "").strip()
                content = content.strip()
            elif stop_cut:
                # the stop hit INSIDE the reasoning section: keep the
                # chain of thought in reasoning_content
                reasoning = text.replace("<think>", "").strip()
                content = ""
            else:
                content, reasoning = text, ""
            import json as _json

            return _json.dumps(
                {"content": content, "reasoning_content": reasoning}
            )
        return text

    def on_result(self, res: GenResult) -> None:
        # row-level failure domain: quarantined rows (finish_reason
        # "error*") carry a null output + the error message; a decode
        # failure in the RENDERER is itself quarantined per row
        err = res.error
        if err is None and res.finish_reason.startswith("error"):
            err = res.finish_reason
        if err is not None:
            outputs = None
        else:
            try:
                outputs = self.render_output(res.token_ids)
            except Exception as e:  # noqa: BLE001 — row isolation
                err = f"{type(e).__name__}: {e}"
                outputs = None
                self.on_row_event(
                    {"event": "row_quarantined", "row_id": res.row_id,
                     "attempt": 0, "error": err}
                )
        row = {
            "row_id": res.row_id,
            "outputs": outputs,
            "cumulative_logprobs": res.cumulative_logprob,
            # true sampled-token count: the denominator matching
            # cumulative_logprobs
            "gen_tokens": len(res.token_ids),
            "finish_reason": res.finish_reason if err is None or
            res.finish_reason.startswith("error") else "error",
            "error": err,
        }
        if self._tel_on:
            outcome = (
                "quarantined" if err is not None
                else "cancelled" if res.finish_reason == "cancelled"
                else "ok"
            )
            self.jtel.add(f"rows_{outcome}")
            telemetry.ROWS_TOTAL.inc(1.0, outcome)
        self.done[res.row_id] = row["finish_reason"]
        self.pending_flush.append(row)
        if len(self.pending_flush) >= _PARTIAL_FLUSH_EVERY:
            self.flush()
        self.row_progress.update(len(self.done))

    def on_progress(self, p: Dict[str, Any]) -> None:
        self.row_progress.flush(len(self.done))
        self.tput.note_total(p["input_tokens"] + p["output_tokens"])
        if self._tel_on:
            telemetry.TOKENS_PER_SECOND.set(
                p["total_tokens_processed_per_second"]
            )
            telemetry.TOKENS_PER_SECOND_PER_CHIP.set(
                p["total_tokens_processed_per_second"] / self.n_chips
            )
            self.rows_rate.note_total(len(self.done))
            telemetry.ROWS_PER_SECOND.set(
                self.rows_rate.per_second(),
                "dp" if self._dp else "generate",
            )
        self.jm.tokens(
            {
                "input_tokens": p["input_tokens"],
                "output_tokens": p["output_tokens"],
                "total_tokens_processed_per_second": p[
                    "total_tokens_processed_per_second"
                ],
                "tokens_per_second_per_chip": p[
                    "total_tokens_processed_per_second"
                ]
                / self.n_chips,
            }
        )

    def should_cancel(self) -> bool:
        if self.job_id in self.eng._cancel:
            self.cancelled["flag"] = True
            return True
        return False

    # -- terminal transitions (engine worker thread) -------------------

    def flush(self) -> None:
        if self.pending_flush:
            with self.store_timer.time("jobstore_flush"):
                self.eng.jobs.flush_partial(
                    self.job_id, list(self.pending_flush)
                )
            self.pending_flush.clear()

    def finalize_cancelled(self) -> None:
        self.flush()
        self.eng.jobs.set_status(self.job_id, JobStatus.CANCELLED)

    def finalize_completed(self, batcher) -> None:
        """Order, account, and persist final results (the 1:1
        input-order contract) via the jobstore's merge-on-read streamed
        writer. Output-token accounting rides the same pass
        (``on_chunk``). ``batcher.timer`` is the SESSION's timer: under
        co-batching the perf profile spans every job that shared the
        batch."""
        self.flush()
        rec = self.rec
        counted = {"output_tokens": 0}

        def _count_chunk(cols) -> None:
            if cols["row_id"] and cols["row_id"][0] == 0:
                counted["output_tokens"] = 0  # a retried pass restarts
            counted["output_tokens"] += int(
                sum(
                    len(self.tok.encode(o)) if o else 0
                    for o in cols["outputs"]
                )
            )

        with self.store_timer.time("jobstore_finalize"):
            self.eng.jobs.write_results_streamed(
                self.job_id, rec.num_rows, on_chunk=_count_chunk
            )
        output_tokens = counted["output_tokens"]
        perf = dict(batcher.timer.summary())
        perf.update(self.store_timer.summary())
        perf["cobatch"] = {"session_job": self.session_job}
        drafted = self.ctx.stats.get("spec_drafted", 0)
        if drafted:
            # n-gram speculative acceptance rate
            accepted = self.ctx.stats.get("spec_accepted", 0)
            perf["spec_ngram"] = {
                "drafted": drafted,
                "accepted": accepted,
                "acceptance_rate": round(accepted / drafted, 3),
            }
        ff = self.ctx.stats.get("ff_forced", 0)
        if ff:
            # FSM fast-forward: scaffold tokens committed through
            # parallel verify forwards instead of per-step windows
            perf["fastforward"] = {"forced_tokens": ff}
        if self._tel_on:
            self.jtel.set("input_tokens", self.input_tokens)
            self.jtel.set("output_tokens", output_tokens)
            telemetry.TOKENS_TOTAL.inc(float(self.input_tokens), "in")
            telemetry.TOKENS_TOTAL.inc(float(output_tokens), "out")
            telemetry.TRACES.end_trace(f"tr-{self.job_id}", "ok")
        self.eng.jobs.update(
            self.job_id,
            input_tokens=self.input_tokens,
            output_tokens=output_tokens,
            job_cost=estimate_cost(
                self.engine_key, self.input_tokens, output_tokens
            ),
            perf=perf,
        )
        self.jm.progress(rec.num_rows)
        # results are fully written (atomic rename) — flipping to
        # SUCCEEDED last keeps the results-before-status invariant
        self.eng.jobs.set_status(self.job_id, JobStatus.SUCCEEDED)


# ---------------------------------------------------------------------------
# Singleton
# ---------------------------------------------------------------------------

_engine: Optional[LocalEngine] = None
_engine_lock = threading.Lock()


def get_engine(ecfg: Optional[EngineConfig] = None, *, device="cuda") -> LocalEngine:
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = LocalEngine(ecfg, device=device)
        return _engine


def reset_engine() -> None:
    """Test hook: drop the singleton. The outgoing worker gets a
    bounded stop (idle workers exit immediately; a worker mid-job is
    left to finish on its daemon thread rather than blocking the
    reset)."""
    global _engine
    with _engine_lock:
        old, _engine = _engine, None
    if old is not None:
        old.close(timeout=2.0)
