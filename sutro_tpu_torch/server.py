"""Local engine daemon: the Sutro wire contract over HTTP.

The port of ``sutro_tpu/server.py``: the same routes, status codes and
JSON bodies over the CUDA engine (``engine/api.py``), so an HTTP client
cannot tell the two servers apart. Start it on the card with

    python -m sutro_tpu_torch.server [--host 127.0.0.1] [--port 8642]

and point clients at it: ``Sutro(backend="remote",
base_url="http://127.0.0.1:8642")`` (``sdk.py``), or an OpenAI client at
``http://127.0.0.1:8642/v1`` when the engine has
``interactive_slots > 0`` (``$SUTRO_HOME/engine.json`` or
``SUTRO_*`` environment settings, ``engine/config.py``).

- detach/attach works across processes: jobs survive client exits, and
  any number of clients share one engine that keeps its runners and
  weights warm between jobs;
- stdlib only (``ThreadingHTTPServer``): one engine worker thread
  executes jobs (LocalEngine's queue discipline is unchanged); HTTP
  threads only enqueue, poll the jobstore, or tail the metrics bus —
  all thread-safe surfaces.

Endpoints: POST /batch-inference, GET /stream-job-progress/{id}
(NDJSON), POST /job-results, GET /jobs/{id}, GET /job-status/{id}, GET
/job-cancel/{id}, GET /job-resume/{id}, GET /list-jobs, GET
/create-dataset, POST /upload-to-dataset (multipart), POST
/list-datasets, POST /list-dataset-files, POST /download-from-dataset,
GET /try-authentication, GET /get-quotas, POST /functions/run; the
interactive tier's POST /v1/chat/completions and /v1/completions (SSE
or collected); GET /metrics (Prometheus text), /job-telemetry/{id},
/job-doctor/{id}, /trace/{id}; GET /job-fleet/{id} (a data-parallel
job's fleet view, ``{"fleet": ...}``); GET /monitor (the live SLO monitor's
document, with the control plane's ``enforcement`` section when it is
on) and GET /monitor/stream (NDJSON, one record per sampler tick;
``?ticks=N`` bounds it), both 404 when the monitor is disabled; the
fleet frames GET /fleet-state, POST /fleet-warm, GET /metrics-snapshot,
GET /trace-doc/{id}; GET /healthz.

A ``stages`` payload on POST /batch-inference submits a stage graph; an
invalid graph is a 400 with ``code: INVALID_GRAPH`` and a ``reason``. A
batch submit the control plane refuses answers 429 with ``code:
QUOTA_EXCEEDED`` and the FAILED job's id in ``results`` (the JAX server
answers 200 with the id; both leave the same FAILED record).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from email.message import Message
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .engine import faults
from .engine.api import LocalEngine
from .fleet.frames import ListeningServer
from .interfaces import JobStatus

logger = logging.getLogger(__name__)

DEFAULT_PORT = 8642


class _BadRequest(Exception):
    """Malformed request body (400) — distinct from unknown resources
    (KeyError -> 404)."""


def _require(req: Dict[str, Any], field: str) -> Any:
    try:
        return req[field]
    except KeyError:
        raise _BadRequest(f"missing required field {field!r}") from None


def _parse_multipart(content_type: str, body: bytes) -> Dict[str, Any]:
    """Parse a multipart/form-data body into {field: value} where file
    fields become (filename, bytes)."""
    parser = BytesParser()
    msg = parser.parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
    )
    out: Dict[str, Any] = {}
    if not msg.is_multipart():
        return out
    for part in msg.get_payload():
        assert isinstance(part, Message)
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        filename = part.get_filename()
        payload = part.get_payload(decode=True)
        if filename is not None:
            out[name] = (filename, payload or b"")
        else:
            out[name] = (payload or b"").decode("utf-8", "replace")
    return out


class EngineHTTPHandler(BaseHTTPRequestHandler):
    # set by make_server; None until the engine is warm (serve() binds
    # the socket before the slow engine build so /healthz can answer
    # 503-warming instead of connection-refused)
    engine: Optional[LocalEngine]
    protocol_version = "HTTP/1.1"
    server_version = "sutro-tpu-engine"

    # -- plumbing ------------------------------------------------------

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _json(self, obj: Any, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _bytes(self, data: bytes, status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str) -> None:
        self._json({"detail": message}, status=status)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _read_json(self) -> Dict[str, Any]:
        body = self._read_body()
        return json.loads(body) if body else {}

    def _route(self) -> Tuple[str, Optional[str]]:
        path = self.path.split("?")[0].strip("/")
        head, _, rest = path.partition("/")
        return head, (rest or None)

    def _query(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for kv in self.path.partition("?")[2].split("&"):
            k, _, v = kv.partition("=")
            if k:
                out[k] = v
        return out

    # -- chaos: simulated replica death (fleet.replica_crash) ----------

    def _crash_fault(self, job: str) -> bool:
        """fleet.replica_crash fault site: a firing spec makes this
        daemon act dead — connection closed abruptly with NO response
        or terminal frame, HTTP loop shut down. ``job`` is
        ``dispatch:<path>`` at request entry or ``stream:<id>`` inside
        a streaming loop, so plans can pin either."""
        spec = faults.fire("fleet.replica_crash", job=job)
        if spec is None:
            return False
        self._simulate_crash()
        return True

    def _simulate_crash(self) -> None:
        threading.Thread(
            target=self.server.shutdown, daemon=True, name="fleet-crash"
        ).start()
        self.close_connection = True
        try:
            self.connection.close()
        except OSError:
            pass  # already torn down — the point is an abrupt close

    def _warming_503(self, head: str) -> None:
        """Socket is up but the engine is still building (compile /
        weight load): readiness gate for routers and external LBs."""
        if head == "healthz" or head == "fleet-state":
            self._json({"ok": False, "state": "warming", "v": 1}, status=503)
        else:
            self._error(503, "engine warming up")

    # -- verbs ---------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        try:
            head, rest = self._route()
            if faults.ACTIVE is not None and self._crash_fault(
                "dispatch:" + self.path
            ):
                return
            eng = self.engine
            if eng is None:
                self._warming_503(head)
                return
            if head == "stream-job-progress" and rest:
                self._stream_progress(rest)
            elif head == "jobs" and rest:
                self._json({"job": eng.get_job(rest)})
            elif head == "job-status" and rest:
                self._json({"job_status": {rest: eng.job_status(rest)}})
            elif head == "job-cancel" and rest:
                self._json(eng.cancel_job(rest))
            elif head == "job-resume" and rest:
                self._json(eng.resume_job(rest))
            elif head == "list-jobs":
                self._json({"jobs": eng.list_jobs()})
            elif head == "create-dataset":
                self._json({"dataset_id": eng.datasets.create()})
            elif head == "try-authentication":
                self._json(eng.try_authentication())
            elif head == "get-quotas":
                self._json({"quotas": eng.get_quotas()})
            elif head == "metrics":
                self._metrics()
            elif head == "metrics-snapshot":
                self._metrics_snapshot()
            elif head == "trace-doc" and rest:
                self._trace_doc(rest)
            elif head == "job-telemetry" and rest:
                self._json({"telemetry": eng.job_telemetry(rest)})
            elif head == "job-doctor" and rest:
                self._json({"doctor": eng.diagnose_job(rest)})
            elif head == "trace" and rest:
                # Chrome trace-event JSON served RAW (not wrapped):
                # `curl .../trace/<id> > t.json` loads in Perfetto as-is
                self._json(eng.get_trace(rest))
            elif head == "job-fleet" and rest:
                self._json({"fleet": eng.job_fleet(rest)})
            elif head == "monitor" and rest == "stream":
                self._stream_monitor()
            elif head == "monitor" and rest is None:
                # monitor disabled -> KeyError -> the 404 arm below
                self._json({"monitor": eng.monitor_doc()})
            elif head == "healthz":
                self._healthz()
            elif head == "fleet-state":
                self._fleet_state()
            else:
                self._error(404, f"Unknown endpoint GET /{head}")
        except (KeyError, FileNotFoundError) as e:
            self._error(404, f"Not found: {e}")
        except NotImplementedError as e:
            self._error(501, str(e))
        except Exception as e:  # noqa: BLE001 — request isolation boundary
            self._error(500, f"{type(e).__name__}: {e}")

    def do_POST(self) -> None:  # noqa: N802
        try:
            head, rest = self._route()
            if faults.ACTIVE is not None and self._crash_fault(
                "dispatch:" + self.path
            ):
                return
            eng = self.engine
            if eng is None:
                self._warming_503(head)
                return
            if head == "fleet-warm":
                self._fleet_warm()
            elif head == "v1" and rest == "chat/completions":
                self._serve_openai(chat=True)
            elif head == "v1" and rest == "completions":
                self._serve_openai(chat=False)
            elif head == "batch-inference":
                from .engine.jobstore import InvalidPriority
                from .engine.stagegraph import InvalidGraph

                payload = self._read_json()
                try:
                    self._submit_batch(payload)
                except InvalidGraph as e:
                    # a cyclic or dangling-edge DAG is a caller error
                    # with a machine-readable reason, never a 500
                    self._json(
                        {
                            "error": {
                                "message": str(e),
                                "code": e.code,
                                "reason": e.reason,
                            }
                        },
                        status=e.status,
                    )
                except InvalidPriority as e:
                    # structured 400: the SDK surfaces code + valid
                    # range, no job record was created
                    self._json(
                        {
                            "error": {
                                "message": str(e),
                                "code": e.code,
                                "priority": e.priority,
                                "valid_range": [0, e.n_levels - 1],
                            }
                        },
                        status=e.status,
                    )
            elif head == "job-results":
                req = self._read_json()
                res = eng.job_results(
                    _require(req, "job_id"),
                    include_inputs=bool(req.get("include_inputs")),
                    include_cumulative_logprobs=bool(
                        req.get("include_cumulative_logprobs")
                    ),
                )
                self._json({"results": res})
            elif head == "upload-to-dataset":
                form = _parse_multipart(
                    self.headers.get("Content-Type", ""), self._read_body()
                )
                dataset_id = form.get("dataset_id")
                file_field = form.get("file")
                if not dataset_id or not isinstance(file_field, tuple):
                    self._error(400, "need multipart fields file+dataset_id")
                    return
                fname, data = file_field
                eng.datasets.upload_bytes(dataset_id, fname, data)
                self._json({"uploaded": fname})
            elif head == "list-datasets":
                self._json({"datasets": eng.datasets.list_datasets()})
            elif head == "list-dataset-files":
                req = self._read_json()
                self._json(
                    {
                        "files": eng.datasets.list_files(
                            _require(req, "dataset_id")
                        )
                    }
                )
            elif head == "download-from-dataset":
                req = self._read_json()
                path = eng.datasets.file_path(
                    _require(req, "dataset_id"), _require(req, "file_name")
                )
                self._bytes(path.read_bytes())
            elif head == "functions" and self.path.rstrip("/").endswith(
                "run"
            ):
                self._functions_run()
            else:
                self._error(404, f"Unknown endpoint POST /{head}")
        except _BadRequest as e:
            self._error(400, str(e))
        except (KeyError, FileNotFoundError) as e:
            self._error(404, f"Not found: {e}")
        except json.JSONDecodeError as e:
            self._error(400, f"Invalid JSON body: {e}")
        except NotImplementedError as e:
            self._error(501, str(e))
        except Exception as e:  # noqa: BLE001
            self._error(500, f"{type(e).__name__}: {e}")

    # -- endpoint bodies ----------------------------------------------

    def _submit_batch(self, payload: Dict[str, Any]) -> None:
        """POST /batch-inference: the job id in ``results``; a submit
        the control plane refused (its job FAILED at submit with code
        QUOTA_EXCEEDED) answers 429 with the id and the structured
        error."""
        job_id = self.engine.submit_batch_inference(payload)
        from .engine.control import QUOTA_EXCEEDED

        reason = None
        if self.engine.control is not None:
            rec = self.engine.jobs.get(job_id)
            if rec.status == JobStatus.FAILED.value:
                reason = rec.failure_reason or {}
        if reason and reason.get("code") == QUOTA_EXCEEDED:
            self._json(
                {
                    "results": job_id,
                    "error": {
                        "message": reason.get("message"),
                        "code": QUOTA_EXCEEDED,
                    },
                },
                status=429,
            )
            return
        self._json({"results": job_id})

    def _stream_monitor(self) -> None:
        """NDJSON live-monitor stream (chunked): one record per sampler
        tick (telemetry/monitor.py ``Monitor.stream``), same transfer
        mechanics as ``_stream_progress``. ``?ticks=N`` bounds the
        stream; unbounded streams end when the monitor stops or the
        client detaches."""
        mon = getattr(self.engine, "monitor", None)
        if mon is None:
            self._error(
                404,
                "live monitor disabled (SUTRO_TELEMETRY=0 or "
                "SUTRO_MONITOR=0)",
            )
            return
        max_ticks: Optional[int] = None
        q = self.path.partition("?")[2]
        for kv in q.split("&"):
            k, _, v = kv.partition("=")
            if k == "ticks" and v.isdigit():
                max_ticks = int(v)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_chunk(obj: Dict[str, Any]) -> None:
            line = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(line):X}\r\n".encode() + line + b"\r\n")
            self.wfile.flush()

        try:
            for rec in mon.stream(max_ticks=max_ticks):
                send_chunk(rec)
        except (BrokenPipeError, ConnectionResetError):
            return  # client detached — the monitor keeps sampling
        except Exception:  # noqa: BLE001 — headers already sent; end
            # the chunked body cleanly instead of corrupting it
            logger.warning("monitor stream aborted", exc_info=True)
        try:
            send_chunk({"t": "end", "degraded": mon.failed})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _is_draining(self) -> bool:
        gw = getattr(self.engine, "gateway", None)
        return bool(
            getattr(self.server, "draining", False)
            or (gw is not None and gw.draining)
        )

    def _healthz(self) -> None:
        """3-state readiness: 200 ready, 503 draining (SIGTERM drain in
        progress — stop sending new work, in-flight finishes), 503
        warming (handled before dispatch when engine is None). The
        legacy ``ok`` key keeps pre-fleet probes working."""
        if self._is_draining():
            self._json(
                {"ok": False, "state": "draining", "v": 1}, status=503
            )
        else:
            self._json({"ok": True, "state": "ready", "v": 1})

    def _fleet_state(self) -> None:
        """Fleet router probe: readiness + load report + model list
        (fleet/frames.py ``fleet_state`` frame). 503 while draining so
        plain HTTP health checks agree with the in-band state."""
        from .fleet import frames as fleet_frames

        doc = self.engine.fleet_state()
        draining = self._is_draining() or bool(doc.get("draining"))
        frame = fleet_frames.fleet_state_frame(
            state="draining" if draining else "ready",
            draining=draining,
            ready=bool(doc.get("ready", True)),
            load=doc.get("load") or {},
            models=doc.get("models") or [],
        )
        self._json(frame, status=503 if draining else 200)

    def _fleet_warm(self) -> None:
        """Warm-prefix probe (fleet/frames.py ``warm_probe`` ->
        ``warm_report``): tokenizes the carried OpenAI body exactly as
        submit would and peeks the radix prefix store — side-effect
        free, no admission, no KV mutation. 404 when the interactive
        tier is off (the router treats that as no-affinity)."""
        gw = getattr(self.engine, "gateway", None)
        if gw is None:
            self._error(404, "interactive serving is disabled")
            return
        from .fleet import frames as fleet_frames
        from .serving import openai as oai

        req = self._read_json()
        body = req.get("body")
        if not isinstance(body, dict):
            self._error(400, "warm_probe frame needs a 'body' object")
            return
        try:
            sreq = oai.parse_request(body, chat=bool(req.get("chat", True)))
        except oai.BadServingRequest as e:
            self._error(400, str(e))
            return
        warm, total = gw.probe_warm(sreq)
        self._json(fleet_frames.warm_report_frame(warm, total))

    def _metrics(self) -> None:
        """Prometheus text exposition (0.0.4) of the engine registry."""
        from . import telemetry

        data = telemetry.REGISTRY.to_prometheus().encode()
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _metrics_snapshot(self) -> None:
        """Raw registry snapshot for fleet-router federation
        (fleet/frames.py ``metrics_snapshot``): the router ships
        per-scrape DELTAS of this into its replica-labelled federated
        registry, so the frame stays the plain cumulative export. An
        old router never calls this; an old replica 404s it and the
        router skips federation for that replica."""
        import time

        from . import telemetry
        from .fleet import frames as fleet_frames

        self._json(
            fleet_frames.metrics_snapshot_frame(
                time.time(), telemetry.REGISTRY.export_snapshot()
            )
        )

    def _trace_doc(self, trace_id: str) -> None:
        """One raw per-request trace document (NOT Chrome-rendered —
        that's GET /trace/{id}) for the fleet router's cross-process
        stitcher, with this replica's wall clock for skew
        re-anchoring. 404 when evicted/unknown: the router degrades
        the stitch to router-spans-only."""
        import time

        from . import telemetry
        from .fleet import frames as fleet_frames

        doc = telemetry.TRACES.doc(trace_id)
        if doc is None:
            raise KeyError(trace_id)
        self._json(fleet_frames.trace_doc_frame(time.time(), doc))

    def _stream_progress(self, job_id: str) -> None:
        """NDJSON progress stream (chunked).
        ``?cursor=N`` suppresses progress records at or below N rows
        done, so a reconnecting client (SDK restart-resume, fleet
        router failover) resumes where its last stream dropped instead
        of replaying the history."""
        self.engine.job_status(job_id)  # 404 before headers if unknown
        cursor = 0
        cq = self._query().get("cursor", "")
        if cq.isdigit():
            cursor = int(cq)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_chunk(obj: Dict[str, Any]) -> None:
            line = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(line):X}\r\n".encode() + line + b"\r\n")
            self.wfile.flush()

        status: Optional[str] = None
        try:
            for update in self.engine.stream_job_progress(job_id):
                if faults.ACTIVE is not None and self._crash_fault(
                    "stream:" + job_id
                ):
                    return
                if cursor and update.get("update_type") == "progress":
                    try:
                        if int(update.get("result") or 0) <= cursor:
                            continue
                    except (TypeError, ValueError):
                        pass
                send_chunk(update)
        except (BrokenPipeError, ConnectionResetError):
            return  # client detached — job keeps running
        except Exception:  # noqa: BLE001 — headers already sent: a second
            # response would corrupt the chunked body; record the error
            # in the terminal frame instead.
            logger.warning(
                "progress stream for %s aborted", job_id, exc_info=True
            )
            status = "error"
        # explicit terminal record: clients can tell a finished stream
        # from a dropped connection (old clients ignore the extra line)
        try:
            if status is None:
                try:
                    status = self.engine.job_status(job_id)
                except Exception:  # graftlint: disable=silent-except
                    # terminal frame is best-effort; the stream ended
                    status = "unknown"
            send_chunk({"t": "end", "status": status})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass

    # -- interactive tier (/v1/* — serving/openai.py shapes) -----------

    def _openai_error(
        self, status: int, message: str, etype: str = "invalid_request_error"
    ) -> None:
        self._json(
            {"error": {"message": message, "type": etype, "code": status}},
            status=status,
        )

    def _serve_openai(self, *, chat: bool) -> None:
        gw = getattr(self.engine, "gateway", None)
        if gw is None:
            # interactive tier off: identical 404 surface to a server
            # built before this tier existed
            self._error(
                404,
                "interactive serving is disabled "
                "(set EngineConfig.interactive_slots > 0)",
            )
            return
        from .serving import openai as oai
        from .serving.gateway import GatewayRejected

        try:
            body = self._read_json()
        except json.JSONDecodeError as e:
            self._openai_error(400, f"invalid JSON body: {e}")
            return
        try:
            sreq = oai.parse_request(body, chat=chat)
        except oai.BadServingRequest as e:
            self._openai_error(400, str(e))
            return
        # cross-process trace propagation (fleet/router.py front door):
        # a router-assigned X-Sutro-Trace id is ADOPTED by the gateway
        # instead of minting tr-<rid>, so the router's GET /trace/{id}
        # stitches router + replica spans into one timeline. Malformed
        # or oversized values are ignored (defensive: the header is an
        # open surface), degrading to a replica-minted id.
        ext_tid = self.headers.get("X-Sutro-Trace")
        if ext_tid is not None and not (
            ext_tid.startswith("tr-") and 3 < len(ext_tid) <= 64
        ):
            ext_tid = None
        try:
            ir = gw.submit(sreq, trace_id=ext_tid)
        except GatewayRejected as e:
            self._openai_error(
                e.status,
                str(e),
                "invalid_request_error"
                if e.status in (400, 404)
                else "rate_limit_error"
                if e.status == 429
                else "service_unavailable"
                if e.status == 503
                else "server_error",
            )
            return
        except Exception as e:  # noqa: BLE001 — request isolation
            logger.warning("interactive submit failed", exc_info=True)
            self._openai_error(500, f"{type(e).__name__}: {e}", "server_error")
            return
        if sreq.stream:
            self._stream_openai(ir, chat)
        else:
            self._collect_openai(ir, chat)

    def _collect_openai(self, ir: Any, chat: bool) -> None:
        from .serving import openai as oai

        try:
            self._json(oai.collect(ir, chat=chat))
        except RuntimeError as e:
            self._openai_error(500, str(e), "server_error")
        except Exception as e:  # noqa: BLE001 — request isolation: a
            # non-RuntimeError (decoder bug, malformed record) used to
            # propagate past the channel teardown and wedge the row
            logger.warning("openai collect failed", exc_info=True)
            self._openai_error(
                500, f"{type(e).__name__}: {e}", "server_error"
            )

    def _stream_openai(self, ir: Any, chat: bool) -> None:
        """SSE token stream over manual chunked framing (same transfer
        mechanics as ``_stream_progress``). Heartbeat pings double as
        disconnect probes: a dead socket raises on the write, which
        cancels the request — the scheduler then frees its slot and KV
        pages on the next loop iteration."""
        import time

        from . import telemetry
        from .engine import faults
        from .serving import openai as oai

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        # forensics: each SSE flush lands as a stream_flush span in the
        # request's trace — the leg the stream_flush_bound verdict
        # grades (a slow consumer shows up HERE, not in decode)
        tel_tid = (
            getattr(ir.channel, "trace_id", None)
            if telemetry.ENABLED
            else None
        )

        def send(data: bytes) -> None:
            t0 = time.monotonic()
            self.wfile.write(
                f"{len(data):X}\r\n".encode() + data + b"\r\n"
            )
            self.wfile.flush()
            if tel_tid is not None:
                telemetry.TRACES.add(
                    tel_tid, "stream_flush", t0,
                    time.monotonic() - t0, {"bytes": len(data)},
                )

        try:
            for obj in oai.iter_stream(ir, chat=chat):
                # fault sites count TOKEN frames only: heartbeat pings
                # (obj None) are timing-dependent, and a seeded plan's
                # nth must mean the same frame on every run
                if obj is not None and faults.ACTIVE is not None:
                    if self._crash_fault("stream:" + ir.id):
                        ir.channel.cancel()
                        return
                    faults.inject("serving.stream", job=ir.id)
                send(oai.sse_frame(obj))
        except (BrokenPipeError, ConnectionResetError):
            # client disconnect mid-stream: per-request cancellation
            ir.channel.cancel()
            return
        except Exception:  # noqa: BLE001 — injected stream fault or a
            # channel error: tear this request down; the co-resident
            # batch session never sees it
            logger.warning(
                "interactive stream %s aborted", ir.id, exc_info=True
            )
            ir.channel.cancel()
        try:
            send(oai.SSE_DONE)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            ir.channel.cancel()

    def _functions_run(self) -> None:
        """Synchronous single-input serving call ({response, confidence,
        predictions, run_id, usage})."""
        req = self._read_json()
        name = _require(req, "name")
        input_data = req.get("input_data")
        text = (
            json.dumps(input_data)
            if isinstance(input_data, dict)
            else str(input_data)
        )
        eng = self.engine
        job_id = eng.submit_batch_inference(
            {
                "model": name,
                "inputs": [text],
                "job_priority": 0,
                "truncate_rows": False,
            }
        )
        import time

        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            if JobStatus(eng.job_status(job_id)).is_terminal():
                break
            time.sleep(0.05)
        if eng.job_status(job_id) != JobStatus.SUCCEEDED.value:
            self._error(500, f"function job {eng.job_status(job_id)}")
            return
        res = eng.job_results(job_id)
        rec = eng.get_job(job_id)
        self._json(
            {
                "response": res["outputs"][0],
                "confidence": None,
                "predictions": [],
                "run_id": job_id,
                "usage": {
                    "input_tokens": rec.get("input_tokens"),
                    "output_tokens": rec.get("output_tokens"),
                },
            }
        )


def make_server(
    engine: Optional[LocalEngine],
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    verbose: bool = False,
) -> ThreadingHTTPServer:
    """engine=None binds the socket in the warming state (healthz 503);
    flip it live later with ``bind_engine``."""
    handler = type(
        "BoundEngineHandler", (EngineHTTPHandler,), {"engine": engine}
    )
    server = ListeningServer((host, port), handler)
    server.verbose = verbose  # type: ignore[attr-defined]
    server.draining = False  # type: ignore[attr-defined]
    server.daemon_threads = True
    return server


def bind_engine(server: ThreadingHTTPServer, engine: LocalEngine) -> None:
    """Attach a warm engine to a server started with engine=None:
    /healthz flips from 503-warming to 200-ready."""
    server.RequestHandlerClass.engine = engine  # type: ignore[attr-defined]


def start_server_thread(
    engine: LocalEngine, host: str = "127.0.0.1", port: int = 0
) -> Tuple[ThreadingHTTPServer, threading.Thread, str]:
    """Start a daemon server thread; returns (server, thread, base_url).
    port=0 picks a free port (tests)."""
    server = make_server(engine, host, port)
    thread = threading.Thread(
        target=server.serve_forever, daemon=True, name="sutro-http"
    )
    thread.start()
    return server, thread, f"http://{host}:{server.server_address[1]}"


def _graceful_shutdown(
    engine: LocalEngine, server: ThreadingHTTPServer, grace: float
) -> None:
    """Drain the interactive tier, then stop the HTTP loop. New
    interactive submits are refused (503) immediately; in-flight streams
    get up to ``grace`` seconds to finish naturally (their handlers send
    the final SSE ``[DONE]``); stragglers are hard-cancelled so the
    scheduler frees their slots before the server stops. Idempotent —
    ``server.shutdown()`` is a no-op once the serve loop has exited."""
    # flip /healthz to 503-draining FIRST so fleet routers / LBs stop
    # sending new work before the gateway starts refusing it
    server.draining = True  # type: ignore[attr-defined]
    gw = getattr(engine, "gateway", None)
    if gw is not None:
        gw.begin_drain()
        if not gw.wait_idle(grace):
            logger.warning(
                "graceful drain timed out after %.1fs; cancelling %d "
                "interactive request(s)", grace, gw.active_count(),
            )
            gw.cancel_all()
            gw.wait_idle(2.0)
    server.shutdown()


def install_graceful_sigterm(
    engine: LocalEngine, server: ThreadingHTTPServer, grace: float
) -> bool:
    """SIGTERM → background drain + server stop, CHAINING any handler
    already installed (one that raises SystemExit, for instance)
    instead of
    clobbering it. Returns False outside the main thread, where signal
    handlers cannot be installed."""
    import signal

    prev = signal.getsignal(signal.SIGTERM)
    started = threading.Event()

    def _handler(signum: int, frame: Any) -> None:
        if not started.is_set():
            started.set()
            threading.Thread(
                target=_graceful_shutdown,
                args=(engine, server, grace),
                daemon=True,
                name="sutro-serve-drain",
            ).start()
        if callable(prev):
            # chained handler may raise (SystemExit) — serve() catches
            # it and finishes the drain synchronously before exiting
            prev(signum, frame)

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        return False  # not the main thread (embedded/test use)
    return True


def serve(
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    ecfg: Optional[Any] = None,
    verbose: bool = True,
) -> None:
    """Blocking entry point (``python -m sutro_tpu_torch.server``; the
    reference's ``sutro serve``, whose CLI needs ``click``)."""
    from .engine.api import get_engine

    # bind + answer BEFORE the slow engine build: /healthz serves
    # 503-warming during the weight load, so a router or LB gates
    # traffic on readiness instead of seeing connection-refused
    server = make_server(None, host, port, verbose=verbose)
    http_thread = threading.Thread(
        target=server.serve_forever, daemon=True, name="sutro-http"
    )
    http_thread.start()
    print(f"sutro engine daemon listening on http://{host}:{port} "
          "(warming)", flush=True)
    engine = get_engine(ecfg)
    bind_engine(server, engine)
    # drain budget mirrors the dp stall policy, capped for interactive
    # use (a 10-minute SIGTERM drain would outlive most supervisors)
    grace = min(float(engine.ecfg.dp_stall_timeout or 30.0), 30.0)
    install_graceful_sigterm(engine, server, grace)
    print("engine ready; point clients at it with: Sutro(backend="
          f"'remote', base_url='http://{host}:{port}')", flush=True)
    try:
        while http_thread.is_alive():
            http_thread.join(timeout=1.0)
    except (KeyboardInterrupt, SystemExit):
        # a chained SIGTERM handler may raise SystemExit: finish the
        # drain (bounded) and keep its exit code
        _graceful_shutdown(engine, server, grace)
        if not isinstance(sys.exc_info()[1], KeyboardInterrupt):
            raise


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m sutro_tpu_torch.server",
        description="Serve the Sutro wire contract from the CUDA engine.",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = ap.parse_args(argv)
    from .parallel.mesh import init_distributed

    launch = init_distributed()
    if launch is not None and launch[0] > 0:
        # a torchrun launch's rank above 0: one rank of rank 0's mesh
        # runners (EngineConfig.tp/ep/sp/pp), not a server
        from .parallel.ranks import torchrun_worker

        torchrun_worker()
        return
    serve(args.host, args.port)


if __name__ == "__main__":
    main()
