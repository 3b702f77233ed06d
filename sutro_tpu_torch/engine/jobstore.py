"""Job store: records, states, durable results, quotas, cost model.

The job control plane of ``sutro_tpu/engine/jobstore.py`` with the same
records, status funnel, failure log, quotas, partial store and results
contract. Layout under ``$SUTRO_HOME/jobs/<job_id>/``:

- ``record.json``  — the job record (status, counters, timestamps, config)
- ``inputs.jsonl`` — the input rows, one ``{"row_id", "inputs"}`` per line
- ``partial/``     — completed rows flushed during the run as immutable
  chunk files ``b<bucket>-s<seq>.jsonl`` (bucket = row_id // chunk_rows,
  seq = per-flush monotonic counter; later seq wins on duplicate
  row_ids). Each chunk ends with a ``{"__rows__": n}`` footer line, so a
  torn file (a crash mid-write on a non-durable filesystem) is detected,
  quarantined and its rows regenerate on resume.
- ``results.jsonl`` — final ordered results, one row per line, written
  by ``write_results_streamed`` one bucket at a time from the partial
  chunks (peak host memory O(chunk_rows), not O(job)).

Storage format, a difference by design: the JAX package writes parquet
through pandas/pyarrow; the port writes JSON-lines with the standard
library only, so the engine runs where neither package is installed.
``read_results`` returns the columns as a dict of lists (the JAX
package returns a DataFrame). Every file lands by a temp-file write and
an atomic rename.

Invariants:

- single writer: only the engine worker thread mutates a running job;
- ``results.jsonl`` is fully written *before* the record flips to
  SUCCEEDED, so "status==SUCCEEDED" implies "results readable".
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

from .. import telemetry
from ..interfaces import JobStatus
from ..validation import config_dir
from . import faults
from .faults import retry_transient

# ---------------------------------------------------------------------------
# Cost model (USD per 1M tokens), the JAX package's table: priced by
# parameter count; the port claims no cost model of its own for the GPU.
# ---------------------------------------------------------------------------

COST_PER_MTOK: Dict[str, Dict[str, float]] = {
    # engine_key prefix -> {input, output}
    "qwen3-0.6b": {"input": 0.01, "output": 0.02},
    "qwen3-4b": {"input": 0.04, "output": 0.08},
    "qwen3-8b": {"input": 0.07, "output": 0.15},
    "qwen3-14b": {"input": 0.12, "output": 0.25},
    "qwen3-32b": {"input": 0.25, "output": 0.50},
    "qwen3-30b-a3b": {"input": 0.10, "output": 0.20},
    "qwen3-235b-a22b": {"input": 0.50, "output": 1.00},
    "llama-3.2-3b": {"input": 0.03, "output": 0.06},
    "llama-3.1-8b": {"input": 0.07, "output": 0.15},
    "llama-3.3-70b": {"input": 0.45, "output": 0.90},
    "gemma3-4b": {"input": 0.04, "output": 0.08},
    "gemma3-12b": {"input": 0.10, "output": 0.22},
    "gemma3-27b": {"input": 0.22, "output": 0.45},
    "gpt-oss-20b": {"input": 0.06, "output": 0.12},
    "gpt-oss-120b": {"input": 0.25, "output": 0.50},
    "qwen3-emb-0.6b": {"input": 0.01, "output": 0.01},
    "qwen3-emb-6b": {"input": 0.05, "output": 0.05},
    "qwen3-emb-8b": {"input": 0.07, "output": 0.07},
}
_DEFAULT_COST = {"input": 0.10, "output": 0.20}

# Per-priority quotas (rows, tokens): a list indexed by priority, each
# {row_quota, token_quota}; priority selects the quota table and the
# scheduling precedence.
DEFAULT_QUOTAS: List[Dict[str, int]] = [
    {"row_quota": 500_000, "token_quota": 500_000_000},
    {"row_quota": 5_000_000, "token_quota": 5_000_000_000},
]


class InvalidPriority(ValueError):
    """Out-of-range ``job_priority`` at submit. Priorities index the
    quota table, so a value outside it is a caller error, not something
    to silently clamp. An HTTP layer maps this to 400 with
    ``code=INVALID_PRIORITY``."""

    code = "INVALID_PRIORITY"
    status = 400

    def __init__(self, priority: Any, n_levels: int) -> None:
        self.priority = priority
        self.n_levels = n_levels
        super().__init__(
            f"job_priority {priority!r} is out of range: the quota "
            f"table defines priorities 0..{n_levels - 1}"
        )


def estimate_cost(
    engine_key: str, input_tokens: int, output_tokens: int
) -> float:
    rates = COST_PER_MTOK.get(engine_key, _DEFAULT_COST)
    return (
        input_tokens * rates["input"] + output_tokens * rates["output"]
    ) / 1e6


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _json_default(o: Any) -> Any:
    """numpy scalars and arrays (row results carry them) as plain JSON."""
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def _dumps(obj: Any) -> str:
    return json.dumps(obj, default=_json_default)


def _write_atomic(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    # small local record write; when reached from ``JobStore.update`` it
    # runs under the store lock, whose read-modify-write it is
    # graftlint: disable=lock-blocking-call
    tmp.write_text(text)
    tmp.replace(path)  # atomic on POSIX


@dataclasses.dataclass
class JobRecord:
    job_id: str
    status: str = JobStatus.QUEUED.value
    name: Optional[str] = None
    description: Optional[str] = None
    model: str = ""
    engine_key: str = ""
    num_rows: int = 0
    job_priority: int = 0
    datetime_created: str = dataclasses.field(default_factory=_now)
    datetime_started: Optional[str] = None
    datetime_completed: Optional[str] = None
    input_tokens: int = 0
    output_tokens: int = 0
    cost_estimate: Optional[float] = None
    job_cost: Optional[float] = None
    failure_reason: Optional[Dict[str, Any]] = None
    # structured, bounded event trail: every retry / per-row quarantine /
    # terminal failure appends here
    failure_log: Optional[List[Dict[str, Any]]] = None
    output_schema: Optional[Dict[str, Any]] = None
    system_prompt: Optional[str] = None
    sampling_params: Optional[Dict[str, Any]] = None
    truncate_rows: bool = True
    dry_run: bool = False
    random_seed_per_input: bool = False
    # tenant attribution: submit-time identity every series and terminal
    # accounting row is keyed by; "default" when the caller names none
    tenant: Optional[str] = None
    # per-job latency profile (engine/profiling.py StepTimer.summary())
    perf: Optional[Dict[str, Any]] = None
    # stage-graph jobs (engine/stagegraph.py): the validated DAG and its
    # per-stage rollup
    stages: Optional[List[Dict[str, Any]]] = None
    stages_state: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class JobStore:
    # failure_log entries kept per job (oldest dropped first): the log is
    # an incident trail, not a metrics store
    _FAILURE_LOG_CAP = 200

    def __init__(
        self,
        root: Optional[Path] = None,
        chunk_rows: Optional[int] = None,
        io_retries: Optional[int] = None,
        io_backoff: Optional[float] = None,
        io_backoff_cap: Optional[float] = None,
    ):
        import os

        self.root = Path(root) if root else (config_dir() / "jobs")
        self.root.mkdir(parents=True, exist_ok=True)
        # result/partial chunk granularity: the unit of per-flush I/O
        # AND the peak materialized row count during finalization
        self.chunk_rows = int(
            chunk_rows
            if chunk_rows is not None
            else os.environ.get("SUTRO_RESULT_CHUNK", "1024")
        )
        if self.chunk_rows < 1:
            self.chunk_rows = 1
        # transient-I/O retry policy (exponential backoff + jitter,
        # bounded attempts — engine/faults.retry_transient)
        self.io_retries = int(
            io_retries
            if io_retries is not None
            else os.environ.get("SUTRO_IO_RETRIES", "4")
        )
        self.io_backoff = float(
            io_backoff
            if io_backoff is not None
            else os.environ.get("SUTRO_IO_BACKOFF", "0.05")
        )
        self.io_backoff_cap = float(
            io_backoff_cap
            if io_backoff_cap is not None
            else os.environ.get("SUTRO_IO_BACKOFF_CAP", "2.0")
        )
        self._lock = threading.Lock()
        self._flush_seq: Dict[str, int] = {}  # job_id -> next chunk seq
        # terminal-transition hook, called once per terminal transition
        # with the fresh JobRecord; best-effort — a hook error must never
        # corrupt the status funnel
        self.on_terminal: Optional[Callable[[JobRecord], None]] = None

    # -- paths -----------------------------------------------------------
    def _dir(self, job_id: str) -> Path:
        return self.root / job_id

    def _record_path(self, job_id: str) -> Path:
        return self._dir(job_id) / "record.json"

    # -- record lifecycle ------------------------------------------------
    def create(self, **fields: Any) -> JobRecord:
        job_id = fields.pop("job_id", None) or f"job-{uuid.uuid4().hex[:16]}"
        rec = JobRecord(job_id=job_id, **fields)
        self._dir(job_id).mkdir(parents=True, exist_ok=True)
        self._write_record(rec)
        return rec

    def _write_record(self, rec: JobRecord) -> None:
        # when reached from ``update`` it runs under the store lock —
        # that read-modify-write IS the lock's critical section
        _write_atomic(
            self._record_path(rec.job_id), json.dumps(rec.to_dict(), indent=2)
        )

    def get(self, job_id: str) -> JobRecord:
        path = self._record_path(job_id)
        if not path.exists():
            raise KeyError(f"Unknown job: {job_id}")
        # tiny local JSON; under the lock only via ``update`` (the RMW)
        # graftlint: disable=lock-blocking-call
        data = json.loads(path.read_text())
        fields = {f.name for f in dataclasses.fields(JobRecord)}
        return JobRecord(**{k: v for k, v in data.items() if k in fields})

    def update(self, job_id: str, **fields: Any) -> JobRecord:
        with self._lock:
            rec = self.get(job_id)
            for k, v in fields.items():
                setattr(rec, k, v)
            self._write_record(rec)
            return rec

    def set_status(self, job_id: str, status: JobStatus, **extra: Any) -> None:
        fields: Dict[str, Any] = {"status": status.value, **extra}
        if status == JobStatus.RUNNING:
            fields.setdefault("datetime_started", _now())
        if status.is_terminal():
            fields.setdefault("datetime_completed", _now())
        rec = self.update(job_id, **fields)
        if telemetry.ENABLED and status in (
            JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.CANCELLED
        ):
            # terminal TRANSITIONS (a resumed-then-failed job counts
            # twice — each is a real lifecycle event)
            telemetry.JOBS_TOTAL.inc(1.0, status.value.lower())
            # tenant attribution settles at the same funnel
            tenant = str(rec.tenant or "default")
            jc = telemetry.JOBS.peek(job_id)
            if jc is not None:
                d = jc.to_dict()
                if d.get("rows_ok"):
                    telemetry.TENANT_ROWS_TOTAL.inc(
                        float(d["rows_ok"]), tenant, "ok"
                    )
                if d.get("rows_quarantined"):
                    telemetry.TENANT_ROWS_TOTAL.inc(
                        float(d["rows_quarantined"]), tenant,
                        "quarantined",
                    )
            if rec.input_tokens:
                telemetry.TENANT_TOKENS_TOTAL.inc(
                    float(rec.input_tokens), tenant, "in"
                )
            if rec.output_tokens:
                telemetry.TENANT_TOKENS_TOTAL.inc(
                    float(rec.output_tokens), tenant, "out"
                )
        if telemetry.ENABLED and status == JobStatus.CANCELLED:
            # CANCELLED dumps the flight recorder like FAILED does (the
            # engine handles FAILED at its failure boundaries)
            telemetry.dump_job(self._dir(job_id), job_id)
        if status.is_terminal() and self.on_terminal is not None:
            try:
                self.on_terminal(rec)
            except Exception:  # noqa: BLE001 — the hook is best-effort;
                # the status funnel is not
                logger.warning(
                    "on_terminal hook failed for %s", job_id,
                    exc_info=True,
                )

    def status(self, job_id: str) -> JobStatus:
        return JobStatus(self.get(job_id).status)

    def set_cancelling(self, job_id: str) -> JobStatus:
        """``CANCELLING`` unless the job reached a terminal state first,
        read and written under the store lock: a cancel that read
        ``RUNNING`` can otherwise cross the worker's terminal write and
        leave the record ``CANCELLING`` with no worker left to end it.
        Returns the status the record now holds."""
        with self._lock:
            rec = self.get(job_id)
            status = JobStatus(rec.status)
            if status.is_terminal():
                return status
            rec.status = JobStatus.CANCELLING.value
            self._write_record(rec)
            return JobStatus.CANCELLING

    def append_failure_log(
        self, job_id: str, event: Dict[str, Any]
    ) -> None:
        """Append one structured event to the job's bounded
        ``failure_log[]`` (retry / quarantine / terminal failure).
        Best-effort by design: recording a recovery must never itself
        become a new failure. ``ts`` is stamped here."""
        ev = {"ts": _now(), **event}
        if telemetry.ENABLED:
            kind = event.get("event")
            telemetry.ROW_EVENTS_TOTAL.inc(
                1.0, kind if isinstance(kind, str) else "unknown"
            )
        try:
            # inline RMW (``update`` would re-take the non-reentrant
            # store lock); the record write IS the critical section
            with self._lock:
                rec = self.get(job_id)
                log = list(rec.failure_log or [])
                log.append(ev)
                if len(log) > self._FAILURE_LOG_CAP:
                    log = log[-self._FAILURE_LOG_CAP :]
                rec.failure_log = log
                self._write_record(rec)
        except Exception:
            logger.warning(
                "failure_log append failed for %s (event %r)",
                job_id, event.get("event"), exc_info=True,
            )

    def list_jobs(self) -> List[Dict[str, Any]]:
        """Newest-first job records."""
        out = []
        for d in self.root.iterdir():
            if (d / "record.json").exists():
                try:
                    out.append(self.get(d.name).to_dict())
                except (KeyError, TypeError, ValueError, OSError) as e:
                    # a torn/foreign record must not break the listing,
                    # but the skip has to be visible
                    logger.warning(
                        "skipping unreadable job record %s: %s", d.name, e
                    )
                    continue
        out.sort(key=lambda r: r.get("datetime_created") or "", reverse=True)
        return out

    # -- inputs / results -------------------------------------------------
    def write_inputs(self, job_id: str, rows: List[str]) -> None:
        _write_atomic(
            self._dir(job_id) / "inputs.jsonl",
            "".join(
                _dumps({"row_id": i, "inputs": r}) + "\n"
                for i, r in enumerate(rows)
            ),
        )

    def read_inputs(self, job_id: str) -> List[str]:
        with open(self._dir(job_id) / "inputs.jsonl") as f:
            rows = [json.loads(line) for line in f if line.strip()]
        rows.sort(key=lambda r: r["row_id"])
        return [r["inputs"] for r in rows]

    def _partial_dir(self, job_id: str) -> Path:
        return self._dir(job_id) / "partial"

    def _partial_chunks(self, job_id: str) -> List[tuple]:
        """All partial chunk files as ``(bucket, seq, path)``, unsorted.
        Filenames are ``b<bucket>-s<seq>.jsonl``; later seq wins on
        duplicate row_ids (a resumed run regenerating a cancelled row
        flushes a fresh entry with a higher seq)."""
        d = self._partial_dir(job_id)
        if not d.is_dir():
            return []
        out = []
        for p in d.iterdir():
            name = p.name
            if not (name.startswith("b") and name.endswith(".jsonl")):
                continue
            try:
                b_part, s_part = name[1 : -len(".jsonl")].split("-s")
                out.append((int(b_part), int(s_part), p))
            except ValueError:
                continue
        return out

    def _next_flush_seq(self, job_id: str) -> int:
        with self._lock:
            seq = self._flush_seq.get(job_id)
            if seq is None:  # first flush this process: resume the count
                seq = (
                    max(
                        (s for _, s, _ in self._partial_chunks(job_id)),
                        default=-1,
                    )
                    + 1
                )
            self._flush_seq[job_id] = seq + 1
            return seq

    def flush_partial(self, job_id: str, rows: List[Dict[str, Any]]) -> None:
        """Append-flush completed rows for row-granular resume.

        O(len(rows)) per call: each flush lands as immutable chunk files
        under ``partial/`` split by row_id bucket.

        Transient-fault domain: OSError flushes retry with exponential
        backoff + jitter, bounded by ``io_retries``, each retry recorded
        in the job's ``failure_log[]``; chunks are idempotent (a fresh
        seq per attempt, later seq wins on duplicate row_ids), so a
        half-landed attempt is harmless."""
        if not rows:
            return
        t0 = time.monotonic()
        retry_transient(
            lambda: self._flush_partial_once(job_id, rows),
            attempts=self.io_retries,
            base=self.io_backoff,
            cap=self.io_backoff_cap,
            retry_on=(OSError,),
            on_retry=lambda attempt, delay, exc: self.append_failure_log(
                job_id,
                {"event": "io_retry", "site": "jobstore.flush_partial",
                 "attempt": attempt,
                 "error": f"{type(exc).__name__}: {exc}"},
            ),
            what=f"flush_partial[{job_id}]",
        )
        if telemetry.ENABLED:
            dt = time.monotonic() - t0
            telemetry.stage_observe("flush", dt)
            telemetry.RECORDER.record(
                "flush", job_id, t0, dt, {"rows": len(rows)}
            )

    @staticmethod
    def _chunk_text(rows: List[Dict[str, Any]]) -> str:
        rows = sorted(rows, key=lambda r: int(r["row_id"]))
        return "".join(_dumps(r) + "\n" for r in rows) + _dumps(
            {"__rows__": len(rows)}
        ) + "\n"

    def _flush_partial_once(
        self, job_id: str, rows: List[Dict[str, Any]]
    ) -> None:
        if faults.ACTIVE is not None:
            spec = faults.fire("jobstore.flush_partial", job=job_id)
            if spec is not None:
                if spec.kind == "torn":
                    # simulate a crash mid-flush on a non-durable fs: a
                    # chunk file exists at its FINAL name with only part
                    # of its bytes (readers skip+quarantine it; the retry
                    # lands a good chunk at a higher seq)
                    self._write_torn_chunk(job_id, rows)
                spec.trigger()
        d = self._partial_dir(job_id)
        d.mkdir(parents=True, exist_ok=True)
        seq = self._next_flush_seq(job_id)
        by_bucket: Dict[int, List[Dict[str, Any]]] = {}
        for r in rows:
            by_bucket.setdefault(
                int(r["row_id"]) // self.chunk_rows, []
            ).append(r)
        for bucket, rs in by_bucket.items():
            _write_atomic(
                d / f"b{bucket:08d}-s{seq:08d}.jsonl", self._chunk_text(rs)
            )

    def _write_torn_chunk(
        self, job_id: str, rows: List[Dict[str, Any]]
    ) -> None:
        """Fault-plan helper (kind ``torn``): land a truncated chunk file
        at a real chunk name, as a crash between write and fsync would
        on a non-durable filesystem."""
        d = self._partial_dir(job_id)
        d.mkdir(parents=True, exist_ok=True)
        seq = self._next_flush_seq(job_id)
        bucket = int(rows[0]["row_id"]) // self.chunk_rows
        data = self._chunk_text(rows).encode()
        (d / f"b{bucket:08d}-s{seq:08d}.jsonl").write_bytes(
            data[: max(8, len(data) // 2)]
        )

    @staticmethod
    def _parse_chunk(path: Path) -> List[Dict[str, Any]]:
        """One chunk's rows; raises ValueError on a torn or corrupt file
        (undecodable line, or a missing or wrong ``__rows__`` footer)."""
        lines = path.read_text().splitlines()
        if not lines:
            raise ValueError("empty chunk")
        footer = json.loads(lines[-1])
        rows = [json.loads(line) for line in lines[:-1]]
        if not isinstance(footer, dict) or footer.get("__rows__") != len(rows):
            raise ValueError("chunk footer missing or wrong")
        return rows

    def _read_chunk(
        self, job_id: str, path: Path
    ) -> Optional[List[Dict[str, Any]]]:
        """Read one partial chunk, tolerating a torn/corrupt file (crash
        mid-flush): the bad chunk is quarantined to ``partial/.corrupt/``
        and logged instead of failing the WHOLE store — its rows simply
        regenerate on resume. Returns None for a quarantined chunk."""
        try:
            return self._parse_chunk(path)
        except (ValueError, UnicodeDecodeError) as e:
            logger.warning(
                "quarantining corrupt partial chunk %s: %s", path, e
            )
            try:
                cdir = path.parent / ".corrupt"
                cdir.mkdir(exist_ok=True)
                path.replace(cdir / path.name)
            except OSError:
                logger.warning(
                    "could not quarantine %s", path, exc_info=True
                )
            self.append_failure_log(
                job_id,
                {"event": "torn_chunk_quarantined", "chunk": path.name,
                 "error": f"{type(e).__name__}: {e}"},
            )
            return None

    def _partial_rows(self, job_id: str):
        """Every flushed row, chunks in seq order (later writes win when
        the caller keys by row_id)."""
        for _, _, p in sorted(
            self._partial_chunks(job_id), key=lambda t: t[1]
        ):
            rows = self._read_chunk(job_id, p)
            if rows is not None:
                yield from rows

    def read_partial(self, job_id: str) -> Dict[int, Dict[str, Any]]:
        """Full partial rows (chunks in seq order, later writes
        winning). O(done rows) memory — callers that only need row
        ids/reasons use ``read_partial_meta``."""
        return {int(r["row_id"]): r for r in self._partial_rows(job_id)}

    def read_partial_meta(self, job_id: str) -> Dict[int, str]:
        """row_id -> finish_reason for every flushed row (the resume
        filter and done-set bootstrap keep no outputs)."""
        return {
            int(r["row_id"]): r["finish_reason"]
            for r in self._partial_rows(job_id)
        }

    def _write_rows(self, job_id: str, rows) -> None:
        """results.jsonl from an iterable of row dicts, by a temp file
        and an atomic rename."""
        tmp = self._dir(job_id) / "results.jsonl.tmp"
        with open(tmp, "w") as f:
            for row in rows:
                f.write(_dumps(row) + "\n")
        tmp.replace(self._dir(job_id) / "results.jsonl")

    def finalize_results(
        self, job_id: str, results: Dict[str, List[Any]], on_written=None
    ) -> None:
        """Write final results THEN flip to SUCCEEDED (ordering
        invariant). Materializes the whole job; generation jobs use
        ``write_results_streamed``. ``on_written()``, when given, runs
        between the write and the status flip (accounting that a
        watcher of SUCCEEDED must see)."""
        t0 = time.monotonic()
        cols = list(results)
        n = len(results[cols[0]]) if cols else 0
        self._write_rows(
            job_id, ({c: results[c][i] for c in cols} for i in range(n))
        )
        if telemetry.ENABLED:
            dt = time.monotonic() - t0
            telemetry.stage_observe("finalize", dt)
            telemetry.RECORDER.record(
                "finalize", job_id, t0, dt, {"rows": n}
            )
        if on_written is not None:
            on_written()
        self.set_status(job_id, JobStatus.SUCCEEDED)

    # generation result schema: one definition so every bucket of a
    # streamed results file agrees. ``error`` carries a quarantined
    # row's failure message (null for clean rows).
    _GEN_COLS = (
        "row_id",
        "outputs",
        "cumulative_logprobs",
        "gen_tokens",
        "finish_reason",
        "error",
    )

    # columns absent from older partial rows that backfill with a
    # default instead of raising (anything else missing is a bug)
    _GEN_BACKFILL = ("gen_tokens", "error")

    def write_results_streamed(
        self,
        job_id: str,
        num_rows: int,
        on_chunk=None,
    ) -> None:
        """Merge-on-read finalization: assemble ``results.jsonl`` in
        row_id order directly from the partial chunk store, one bucket
        at a time. Rows never flushed (cancelled before running) fill as
        ``finish_reason="cancelled"`` with null outputs. Does NOT flip
        job status: callers update accounting first, then set SUCCEEDED
        (the final file only appears at the atomic rename).

        ``on_chunk(cols)`` sees each ordered bucket as a dict of column
        lists — accounting hooks (output-token counts) ride the same
        single pass. On a TRANSIENT I/O failure the whole pass retries
        from scratch (bounded, backed off), so ``on_chunk`` observers
        must reset when they see the bucket starting at row 0 again.
        """
        t0 = time.monotonic()
        retry_transient(
            lambda: self._write_results_streamed_once(
                job_id, num_rows, on_chunk
            ),
            attempts=self.io_retries,
            base=self.io_backoff,
            cap=self.io_backoff_cap,
            retry_on=(OSError,),
            on_retry=lambda attempt, delay, exc: self.append_failure_log(
                job_id,
                {"event": "io_retry", "site": "jobstore.finalize",
                 "attempt": attempt,
                 "error": f"{type(exc).__name__}: {exc}"},
            ),
            what=f"finalize[{job_id}]",
        )
        if telemetry.ENABLED:
            dt = time.monotonic() - t0
            telemetry.stage_observe("finalize", dt)
            telemetry.RECORDER.record(
                "finalize", job_id, t0, dt, {"rows": num_rows}
            )

    def _bucket_rows(self, job_id: str, lo: int, hi: int, chunks) -> Dict[str, list]:
        """Rows lo..hi-1 as ordered columns, later chunk seq winning."""
        by_row: Dict[int, Dict[str, Any]] = {}
        for _seq, p in sorted(chunks):
            rows = self._read_chunk(job_id, p)
            for r in rows or ():
                missing = [
                    c for c in self._GEN_COLS
                    if c not in self._GEN_BACKFILL and c not in r
                ]
                if missing:
                    # anything but the backfillable columns missing is a
                    # bug and must raise, not record nulls
                    raise ValueError(
                        f"partial rows for {job_id} lack columns {missing}"
                    )
                by_row[int(r["row_id"])] = r
        cols: Dict[str, list] = {c: [] for c in self._GEN_COLS}
        for i in range(lo, hi):
            r = by_row.get(i)
            ran = r is not None and r.get("finish_reason") is not None
            err = r.get("error") if r is not None else None
            logp = r.get("cumulative_logprobs") if r is not None else None
            gen = r.get("gen_tokens") if r is not None else None
            cols["row_id"].append(i)
            cols["outputs"].append(r.get("outputs") if r is not None else None)
            cols["cumulative_logprobs"].append(
                0.0 if logp is None or logp != logp else float(logp)
            )
            cols["gen_tokens"].append(0 if gen is None else int(gen))
            cols["finish_reason"].append(r["finish_reason"] if ran else "cancelled")
            cols["error"].append(None if err is None else str(err))
        return cols

    def _write_results_streamed_once(
        self,
        job_id: str,
        num_rows: int,
        on_chunk=None,
    ) -> None:
        if faults.ACTIVE is not None:
            faults.inject("jobstore.finalize", job=job_id)
        by_bucket: Dict[int, List[tuple]] = {}
        for bucket, seq, p in self._partial_chunks(job_id):
            by_bucket.setdefault(bucket, []).append((seq, p))
        n_buckets = max(
            1, (num_rows + self.chunk_rows - 1) // self.chunk_rows
        )

        def rows():
            for bucket in range(n_buckets):
                lo = bucket * self.chunk_rows
                hi = min(lo + self.chunk_rows, num_rows)
                cols = self._bucket_rows(
                    job_id, lo, hi, by_bucket.get(bucket, ())
                )
                if on_chunk is not None:
                    on_chunk(cols)
                for i in range(hi - lo):
                    yield {c: cols[c][i] for c in self._GEN_COLS}

        self._write_rows(job_id, rows())

    def read_results(self, job_id: str) -> Dict[str, List[Any]]:
        """The job's results as ``{column: [value per row]}`` in file
        (row_id) order. Gated on SUCCEEDED, not just file existence:
        the results file lands a few ms BEFORE the record flips (the
        accounting updates sit between), and a concurrent reader must
        not observe results on a still-RUNNING job."""
        path = self._dir(job_id) / "results.jsonl"
        status = self.status(job_id)
        if status != JobStatus.SUCCEEDED or not path.exists():
            raise FileNotFoundError(
                f"Results for {job_id} not available (status={status.value})"
            )
        cols: Dict[str, List[Any]] = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                for k, v in row.items():
                    cols.setdefault(k, []).append(v)
        # a job of no rows (a stage graph whose sink kept none) still
        # has its columns, as the JAX store's empty parquet does
        return cols or {c: [] for c in self._GEN_COLS}

    # -- quotas ----------------------------------------------------------
    def get_quotas(self) -> List[Dict[str, int]]:
        path = config_dir() / "quotas.json"
        if path.exists():
            try:
                return json.loads(path.read_text())
            except (OSError, ValueError) as e:
                logger.warning(
                    "quotas.json unreadable (%s); using default quotas", e
                )
        return [dict(q) for q in DEFAULT_QUOTAS]

    def validate_priority(
        self, priority: Any, quotas: Optional[List[Dict[str, int]]] = None
    ) -> int:
        """The submit-time ``job_priority`` gate: an int indexing the
        quota table, or :class:`InvalidPriority`. No clamping."""
        if quotas is None:
            quotas = self.get_quotas()
        try:
            p = int(priority)
        except (TypeError, ValueError):
            raise InvalidPriority(priority, len(quotas)) from None
        if not 0 <= p < len(quotas):
            raise InvalidPriority(priority, len(quotas))
        return p

    def check_quota(
        self, priority: int, num_rows: int, est_tokens: int
    ) -> Optional[str]:
        quotas = self.get_quotas()
        q = quotas[self.validate_priority(priority, quotas)]
        if num_rows > q["row_quota"]:
            return (
                f"Row count {num_rows} exceeds priority-{priority} quota "
                f"{q['row_quota']}"
            )
        if est_tokens > q["token_quota"]:
            return (
                f"Estimated tokens {est_tokens} exceed priority-{priority} "
                f"quota {q['token_quota']}"
            )
        return None
