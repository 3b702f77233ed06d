"""Replica fleet front door: one stable endpoint over N engines.

The port of ``sutro_tpu/fleet/router.py``. Its upstream transport is
``http.client`` (``frames._open``), not ``requests``, which the card's
machine lacks; what ``requests`` did for the router, it does the same
way: a replica's non-2xx answer (its 404, its 503 while draining, the
control plane's 429 ``QUOTA_EXCEEDED``) is relayed with its status and
body; NDJSON progress and SSE are relayed line by line and chunk by
chunk as they arrive; the connect has ``CONNECT_TIMEOUT_S`` and each
read after it its own timeout (the stall timeout on streams), so a
stall raises ``socket.timeout``; and a replica that dies mid-stream
(``http.client.IncompleteRead``, a reset, or an early EOF) lands on the
same ``except OSError`` branches as ``requests``'
``ChunkedEncodingError`` (``frames.UpstreamError``), never on the
``BrokenPipeError``/``ConnectionResetError`` branches, which mean that
the router's own client detached.
``serve_fleet(replica_urls, host, port)`` serves it until interrupted.

The router serves the SAME batch + OpenAI HTTP contract as a
single engine daemon (server.py) — clients point ``backend="fleet"``
(or plain ``remote``) at the router and never learn the fleet exists.
Behind it:

- **Membership + breakers** (membership.py / health.py): heartbeat
  probes of ``GET /fleet-state`` per replica, per-replica circuit
  breaker closed→open→half-open with bounded backoff, draining
  replicas excluded from routing without failover.
- **Interactive routing** (affinity.py): warm-prefix affinity first
  (replicas report ``prefixstore.peek`` warm tokens), least-loaded
  tie-break. A replica that dies BEFORE the first relayed byte is
  retried transparently on another replica; after the first byte the
  client gets a structured SSE error frame within the stall timeout —
  never a silent hang.
- **Batch failover**: replicas share one jobstore (same SUTRO_HOME).
  A replica death mid-job leaves the partial chunk store intact; the
  router re-submits the job as ``resume_job`` on a healthy replica.
  Chunk-granular first-result-wins (round 11) means zero rows lost or
  duplicated — resumed work skips every row already flushed.

- **Observability plane** (obs.py): every relayed interactive request
  gets a router trace (``route_pick`` → ``affinity_probe`` →
  ``upstream_connect`` → ``first_byte``) whose id travels to the
  picked replica in the ``X-Sutro-Trace`` header; ``GET /trace/{id}``
  stitches both halves into one Perfetto timeline. ``GET /metrics``
  federates every replica's registry snapshot under a ``replica``
  label next to the router's own series; ``GET /fleet-monitor`` (and
  ``/stream``) serve the fleet SLO monitor; ``GET /replay-log`` drains
  the trace ring as a replayable workload (``so.get_replay_log``).

Fault sites: ``fleet.route`` (router pick — a raising kind fails the
chosen replica for one request), ``fleet.probe`` (health.py), and
``fleet.replica_crash`` (server.py, simulated replica death) drive the
chaos suite in tests/test_fleet.py.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .. import telemetry
from ..engine import faults
from ..telemetry.monitor import monitor_enabled
from . import frames
from .affinity import WarmAffinity
from .health import HealthProber
from .membership import OPEN, FleetMembership
from .obs import FleetMonitor, FleetObservability

logger = logging.getLogger(__name__)

DEFAULT_PORT = 8640

#: upstream connect timeout (s) — replicas are LAN/localhost peers
CONNECT_TIMEOUT_S = 5.0
#: mid-stream silence longer than this returns a structured error
#: instead of hanging the client
STALL_TIMEOUT_S = 30.0
#: non-streaming upstream read timeout (job submit / results can be
#: slow on a loaded replica; the jobstore read itself is local-fast)
READ_TIMEOUT_S = 600.0
#: attempts across distinct replicas before giving up on a request
MAX_ROUTE_ATTEMPTS = 3


def pick_batch(replicas: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Least-loaded-first candidate order for batch submits. Pure —
    the op-census leg in profile_host_overhead.py prices this."""
    return sorted(replicas, key=lambda r: (r.get("load", 0), r.get("rid", "")))


def pick_interactive(
    replicas: List[Dict[str, Any]], scores: Dict[str, int]
) -> List[Dict[str, Any]]:
    """Warmest-first, least-loaded tie-break candidate order for
    interactive requests. Pure (see pick_batch)."""
    return sorted(
        replicas,
        key=lambda r: (
            -scores.get(r.get("rid", ""), 0),
            r.get("load", 0),
            r.get("rid", ""),
        ),
    )


class FleetRouter:
    """Routing brain; the HTTP handler below is transport only."""

    def __init__(
        self,
        replica_urls: List[str],
        probe_interval: float = 1.0,
        probe_timeout: float = 2.0,
        stall_timeout: float = STALL_TIMEOUT_S,
        monitor_interval: Optional[float] = None,
        monitor_window: Optional[float] = None,
    ):
        self.stall_timeout = float(stall_timeout)
        self.membership = FleetMembership(
            replica_urls,
            probe_interval=probe_interval,
            on_transition=self._on_transition,
        )
        self.prober = HealthProber(self.membership, timeout=probe_timeout)
        self.affinity = WarmAffinity(timeout=max(0.25, probe_timeout / 2))
        self._jobs_lock = threading.Lock()
        self._job_owner: Dict[str, str] = {}
        self._counter_lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "interactive_routed": 0,
            "batch_routed": 0,
            "prefix_hits": 0,
            "failover_batch": 0,
            "failover_interactive": 0,
            "failover_stream_error": 0,
            "probe_only_routes": 0,
        }
        # observability plane: always constructed (every entry point
        # early-returns when telemetry is off — zero per-request cost);
        # the scrape cache rides the probe cadence so federation lag
        # tracks membership lag
        self.obs = FleetObservability(
            scrape_interval_s=max(float(probe_interval), 0.05),
            scrape_timeout=probe_timeout,
        )
        self.monitor: Optional[FleetMonitor] = None
        if telemetry.ENABLED and monitor_enabled():
            self.monitor = FleetMonitor(
                self,
                interval_s=monitor_interval,
                window_s=monitor_window,
            )

    # -- lifecycle -----------------------------------------------------

    def start(self, warm: bool = True) -> None:
        if warm:
            # one synchronous sweep so the first request after start
            # sees real membership instead of all-unprobed
            self.prober.sweep_once()
        self.prober.start()
        if self.monitor is not None:
            self.monitor.start()

    def stop(self) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        self.prober.stop()

    # -- bookkeeping ---------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def job_owner(self, job_id: str) -> Optional[str]:
        with self._jobs_lock:
            return self._job_owner.get(job_id)

    def set_job_owner(self, job_id: str, rid: str) -> None:
        with self._jobs_lock:
            self._job_owner[job_id] = rid

    def snapshot(self) -> Dict[str, Any]:
        from ..telemetry import doctor

        doc = self.membership.snapshot()
        with self._counter_lock:
            doc["counters"] = dict(self.counters)
        doc["failovers"] = {
            "batch": doc["counters"]["failover_batch"],
            "interactive": doc["counters"]["failover_interactive"],
            "stream_error": doc["counters"]["failover_stream_error"],
        }
        with self._jobs_lock:
            doc["jobs_tracked"] = len(self._job_owner)
        doc["doctor"] = doctor.diagnose_fleet(doc)
        doc["stall_timeout_s"] = self.stall_timeout
        # observability surfacing: degraded-protocol routes at top
        # level (a status view prints them) + route latency from
        # the router's own sutro_fleet_route_seconds series
        doc["probe_only_routes"] = doc["counters"]["probe_only_routes"]
        doc["route_latency"] = self.obs.route_latency_summary()
        return doc

    # -- candidate selection -------------------------------------------

    def _route_fault(self, rid: str) -> bool:
        """fleet.route fault site: a firing spec fails replica ``rid``
        for THIS request only (forces the retry path)."""
        if faults.ACTIVE is None:
            return False
        try:
            faults.inject("fleet.route", job=rid)
        except (faults.InjectedFault, OSError):
            return True
        return False

    def candidates_batch(self) -> List[Dict[str, Any]]:
        return pick_batch(self.membership.healthy())

    def candidates_interactive(
        self, body: Dict[str, Any], chat: bool
    ) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
        healthy = self.membership.healthy()
        scores = self.affinity.scores(body, chat, healthy)
        return pick_interactive(healthy, scores), scores

    # -- batch failover ------------------------------------------------

    def _on_transition(self, rid: str, old: str, new: str) -> None:
        if new == OPEN and old != OPEN:
            # run the jobstore failover off the prober thread: resume
            # round-trips must not delay the next probe sweep
            threading.Thread(
                target=self.failover_replica,
                args=(rid,),
                daemon=True,
                name=f"fleet-failover-{rid}",
            ).start()

    def failover_replica(self, rid: str) -> int:
        """Re-home every router-tracked job owned by a dead replica:
        non-terminal (or FAILED — a crash mid-epilogue records FAILED)
        jobs are re-submitted as ``resume_job`` on a healthy replica.
        The shared chunked partial store makes this zero-loss and
        zero-duplication: resume skips every row already flushed.
        Returns the number of jobs moved."""
        with self._jobs_lock:
            owned = [j for j, o in self._job_owner.items() if o == rid]
        moved = 0
        for job_id in owned:
            try:
                if self._failover_job(job_id, dead_rid=rid):
                    moved += 1
            except Exception:
                logger.warning(
                    "fleet: failover of job %s off %s failed",
                    job_id, rid, exc_info=True,
                )
        return moved

    def _failover_job(self, job_id: str, dead_rid: str) -> bool:
        for r in self.candidates_batch():
            if r["rid"] == dead_rid:
                continue
            try:
                st = frames._open(
                    "get", f"{r['url']}/job-status/{job_id}",
                    connect_timeout=CONNECT_TIMEOUT_S, read_timeout=30.0,
                )
                status = (st.json().get("job_status") or {}).get(job_id)
                if status == "SUCCEEDED":
                    return False  # epilogue landed before the crash
                resp = frames._open(
                    "get", f"{r['url']}/job-resume/{job_id}",
                    connect_timeout=CONNECT_TIMEOUT_S, read_timeout=30.0,
                )
                if resp.status_code != 200:
                    continue
                doc = resp.json()
                self.set_job_owner(job_id, r["rid"])
                self.membership.bump_load(r["rid"])
                self._count("failover_batch")
                if telemetry.ENABLED:
                    telemetry.FLEET_FAILOVERS_TOTAL.inc(1.0, "batch")
                logger.warning(
                    "fleet: job %s failed over %s -> %s (%s rows already "
                    "done)", job_id, dead_rid, r["rid"],
                    doc.get("rows_already_done", "?"),
                )
                return True
            except (OSError, ValueError):
                continue
        logger.warning(
            "fleet: no healthy replica could adopt job %s (owner %s dead)",
            job_id, dead_rid,
        )
        return False


# -- HTTP front door ---------------------------------------------------

#: GET endpoints that are job-scoped (path tail = job id): routed to
#: the job's owner when healthy, else any healthy replica (the
#: jobstore is shared, and resume/cancel handle orphans)
_JOB_GET_HEADS = frozenset(
    {
        "jobs",
        "job-status",
        "job-cancel",
        "job-resume",
        "job-telemetry",
        "job-doctor",
        "trace",
        "job-fleet",
    }
)
#: GET endpoints forwarded to any healthy replica
_ANY_GET_HEADS = frozenset(
    {"list-jobs", "create-dataset", "try-authentication", "get-quotas",
     "monitor"}
)
#: POST endpoints forwarded to any healthy replica (all read from or
#: idempotently write the shared dataset/jobstore tree)
_ANY_POST_HEADS = frozenset(
    {"job-results", "list-datasets", "list-dataset-files",
     "download-from-dataset", "upload-to-dataset", "functions"}
)


class FleetHTTPHandler(BaseHTTPRequestHandler):
    router: FleetRouter  # bound by make_fleet_server
    protocol_version = "HTTP/1.1"
    server_version = "sutro-tpu-fleet"

    # -- plumbing (same transfer mechanics as server.py) ---------------

    def log_message(self, fmt: str, *args: Any) -> None:
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _json(self, obj: Any, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str) -> None:
        self._json({"detail": message}, status=status)

    def _openai_error(
        self, status: int, message: str, etype: str = "server_error"
    ) -> None:
        self._json(
            {"error": {"message": message, "type": etype, "code": status}},
            status=status,
        )

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _route(self) -> Tuple[str, Optional[str]]:
        path = self.path.split("?")[0].strip("/")
        head, _, rest = path.partition("/")
        return head, (rest or None)

    def _relay_response(self, resp: Any) -> None:
        """Relay a completed upstream response byte-faithfully."""
        data = resp.content
        self.send_response(resp.status_code)
        ctype = resp.headers.get("Content-Type", "application/json")
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # -- verbs ---------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        try:
            head, rest = self._route()
            if head == "healthz":
                self._healthz()
            elif head == "fleet":
                self._json({"fleet": self.router.snapshot()})
            elif head == "metrics":
                self._metrics()
            elif head == "fleet-monitor":
                self._fleet_monitor(rest)
            elif head == "replay-log":
                self._replay_log()
            elif head == "stream-job-progress" and rest:
                self._relay_progress(rest)
            elif (
                head == "trace"
                and rest
                and self.router.obs.has_trace(rest)
            ):
                # a ROUTER trace id: stitch router + replica spans into
                # one Perfetto-loadable timeline. Engine trace ids fall
                # through to the job-scoped forward below.
                self._stitched_trace(rest)
            elif head in _JOB_GET_HEADS and rest:
                self._forward_job_get(head, rest)
            elif head in _ANY_GET_HEADS:
                self._forward_any("get", self.path)
            else:
                self._error(404, f"Unknown endpoint GET /{head}")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client detached mid-relay
        except Exception as e:  # noqa: BLE001 — request isolation
            try:
                self._error(500, f"{type(e).__name__}: {e}")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

    def do_POST(self) -> None:  # noqa: N802
        try:
            head, rest = self._route()
            body = self._read_body()
            if head == "v1" and rest in ("chat/completions", "completions"):
                self._relay_interactive(rest, body)
            elif head == "batch-inference":
                self._relay_batch_submit(body)
            elif head in _ANY_POST_HEADS:
                self._forward_any("post", self.path, body)
            else:
                self._error(404, f"Unknown endpoint POST /{head}")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — request isolation
            try:
                self._error(500, f"{type(e).__name__}: {e}")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

    # -- router-local endpoints ----------------------------------------

    def _healthz(self) -> None:
        snap = self.router.membership.snapshot()
        ok = snap["n_healthy"] > 0
        self._json(
            {
                "ok": ok,
                "state": "ready" if ok else "no_healthy_replicas",
                "role": "fleet-router",
                "n_healthy": snap["n_healthy"],
                "n_replicas": snap["n_replicas"],
                "v": 1,
            },
            status=200 if ok else 503,
        )

    def _metrics(self) -> None:
        """Federated fleet scrape: pull every obs-capable replica's
        registry snapshot (cache-bounded), fold the deltas in under a
        ``replica`` label, refresh the router's census gauges, render
        the federated registry — one scrape shows per-replica TTFT/ITL
        next to the fleet aggregate and the router's own series."""
        obs = self.router.obs
        obs.federate(self.router.membership)
        obs.refresh_router_gauges(self.router.membership.snapshot())
        data = obs.registry.to_prometheus().encode()
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _stitched_trace(self, trace_id: str) -> None:
        """Chrome trace-event JSON served RAW (same contract as the
        engine's /trace/{id}): ``curl .../trace/<id> > t.json`` loads
        in Perfetto with one process lane group per participant."""
        from ..telemetry import traceexport

        doc = self.router.obs.stitch_trace(trace_id)
        if doc is None:
            self._error(404, f"unknown trace {trace_id}")
            return
        self._json(traceexport.stitched_to_chrome(doc))

    def _fleet_monitor(self, rest: Optional[str]) -> None:
        mon = self.router.monitor
        if mon is None:
            self._error(
                404,
                "fleet monitor disabled (SUTRO_TELEMETRY=0 or "
                "SUTRO_MONITOR=0)",
            )
            return
        if rest == "stream":
            self._stream_fleet_monitor(mon)
        elif rest is None:
            self._json({"fleet_monitor": mon.snapshot_doc()})
        else:
            self._error(404, f"Unknown endpoint GET /fleet-monitor/{rest}")

    def _stream_fleet_monitor(self, mon: Any) -> None:
        """NDJSON fleet-monitor stream (chunked), one record per
        sampler tick — same transfer mechanics and ``?ticks=N`` bound
        as the engine daemon's /monitor/stream."""
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
            logger.warning("fleet monitor stream aborted", exc_info=True)
        try:
            send_chunk({"t": "end", "degraded": mon.failed})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _replay_log(self) -> None:
        """The trace ring as replayable records (``so.get_replay_log``
        reads them; ``replay.dump_jsonl`` writes them to a file)."""
        from . import replay as replay_mod

        self._json(
            {
                "records": replay_mod.records_from_traces(
                    self.router.obs.traces
                )
            }
        )

    # -- forwarding ----------------------------------------------------

    def _upstream(
        self,
        method: str,
        url: str,
        body: Optional[bytes] = None,
        stream: bool = False,
        read_timeout: float = READ_TIMEOUT_S,
        content_type: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> frames.UpstreamResponse:
        headers = {}
        ct = content_type or self.headers.get("Content-Type")
        if ct and method == "post":
            headers["Content-Type"] = ct
        if trace_id is not None:
            # cross-process trace propagation: the replica's gateway
            # adopts this id instead of minting its own (old replicas
            # ignore the header — stitch degrades, never breaks)
            headers["X-Sutro-Trace"] = trace_id
        return frames._open(
            method, url, (body or b"") if method == "post" else None,
            headers, connect_timeout=CONNECT_TIMEOUT_S,
            read_timeout=read_timeout, stream=stream,
        )

    def _forward_any(
        self, method: str, path: str, body: Optional[bytes] = None
    ) -> None:
        """Forward to any healthy replica, retrying connection-level
        failures on the next candidate (shared-store endpoints are
        replica-agnostic)."""
        last_err: Optional[str] = None
        for r in self.router.candidates_batch()[:MAX_ROUTE_ATTEMPTS]:
            if self.router._route_fault(r["rid"]):
                last_err = f"route fault injected for {r['rid']}"
                continue
            try:
                resp = self._upstream(method, r["url"] + path, body)
            except OSError as e:
                last_err = f"{r['rid']}: {e}"
                continue
            self._relay_response(resp)
            return
        self._error(
            503, f"no healthy replica for {path} ({last_err or 'none up'})"
        )

    def _forward_job_get(self, head: str, rest: str) -> None:
        """Job-scoped GET: owner-preferred (cancel/resume act on the
        engine actually running the job), any healthy fallback."""
        job_id = rest.split("/")[0]
        owner = self.router.job_owner(job_id)
        cands = self.router.candidates_batch()
        if owner is not None:
            cands.sort(key=lambda r: 0 if r["rid"] == owner else 1)
        last_err: Optional[str] = None
        for r in cands[:MAX_ROUTE_ATTEMPTS]:
            try:
                resp = self._upstream("get", r["url"] + self.path)
            except OSError as e:
                last_err = f"{r['rid']}: {e}"
                continue
            if resp.status_code == 200 and head == "job-resume":
                # an explicit client resume re-homes the job here
                self.router.set_job_owner(job_id, r["rid"])
            self._relay_response(resp)
            return
        self._error(
            503,
            f"no healthy replica for /{head}/{job_id} "
            f"({last_err or 'none up'})",
        )

    # -- batch submit + progress relay ---------------------------------

    def _relay_batch_submit(self, body: bytes) -> None:
        t_arrival = time.monotonic()
        last_err: Optional[str] = None
        for r in self.router.candidates_batch()[:MAX_ROUTE_ATTEMPTS]:
            if self.router._route_fault(r["rid"]):
                last_err = f"route fault injected for {r['rid']}"
                continue
            try:
                resp = self._upstream(
                    "post", r["url"] + "/batch-inference", body,
                    content_type="application/json",
                )
            except OSError as e:
                last_err = f"{r['rid']}: {e}"
                continue
            if resp.status_code == 200:
                try:
                    job_id = resp.json().get("results")
                except ValueError:
                    job_id = None
                if isinstance(job_id, str):
                    self.router.set_job_owner(job_id, r["rid"])
                    self.router.membership.bump_load(r["rid"])
                    self.router._count("batch_routed")
                self.router.obs.observe_route(
                    time.monotonic() - t_arrival, "batch"
                )
            self._relay_response(resp)
            return
        self._error(
            503, f"no healthy replica for batch submit "
            f"({last_err or 'none up'})"
        )

    def _relay_progress(self, rest: str) -> None:
        """Relay the NDJSON progress stream, surviving replica death:
        on an upstream drop without a terminal ``{"t":"end"}`` frame
        the router reconnects (to the job's new owner after failover)
        with ``?cursor=<rows done>`` so the client sees one monotone
        stream across the crash."""
        job_id = rest.split("/")[0]
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_line(raw: bytes) -> None:
            self.wfile.write(
                f"{len(raw) + 1:X}\r\n".encode() + raw + b"\n\r\n"
            )
            self.wfile.flush()

        cursor = 0
        attempts = 0
        deadline = time.monotonic() + READ_TIMEOUT_S
        while time.monotonic() < deadline:
            owner = self.router.job_owner(job_id)
            cands = self.router.candidates_batch()
            if owner is not None:
                cands.sort(key=lambda r: 0 if r["rid"] == owner else 1)
            if not cands:
                attempts += 1
                if attempts > 2 * MAX_ROUTE_ATTEMPTS:
                    break
                time.sleep(
                    faults.backoff_delay(attempts, 0.1, 2.0, job_id)
                )
                continue
            r = cands[0]
            try:
                resp = self._upstream(
                    "get",
                    f"{r['url']}/stream-job-progress/{job_id}"
                    f"?cursor={cursor}",
                    stream=True,
                    read_timeout=self.router.stall_timeout,
                )
                if resp.status_code != 200:
                    # job unknown upstream (or warming): surface as-is
                    self._relay_after_headers_error(resp, send_line)
                    return
                for raw in resp.iter_lines():
                    if not raw:
                        continue
                    try:
                        update = json.loads(raw)
                    except ValueError:
                        update = {}
                    if update.get("t") == "end":
                        send_line(raw)
                        self.wfile.write(b"0\r\n\r\n")
                        return
                    if update.get("update_type") == "progress":
                        try:
                            cursor = max(cursor, int(update.get("result")))
                        except (TypeError, ValueError):
                            pass
                    send_line(raw)
                # stream closed WITHOUT an end frame: replica died
            except (BrokenPipeError, ConnectionResetError):
                return  # our client detached
            except OSError:
                pass  # upstream connect/read failure — retry below
            attempts += 1
            if attempts > 2 * MAX_ROUTE_ATTEMPTS:
                break
            time.sleep(faults.backoff_delay(attempts, 0.1, 2.0, job_id))
        # could not reattach: explicit terminal frame, never a hang
        try:
            status = self._poll_status(job_id) or "unknown"
            send_line(
                json.dumps({"t": "end", "status": status}).encode()
            )
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def _relay_after_headers_error(self, resp: Any, send_line: Any) -> None:
        """Our chunked headers are already out; turn an upstream error
        into a terminal NDJSON frame instead of a second status line."""
        try:
            detail = resp.json().get("detail", "")
        except ValueError:
            detail = ""
        send_line(
            json.dumps(
                {"t": "end", "status": "error",
                 "detail": detail or f"upstream {resp.status_code}"}
            ).encode()
        )
        try:
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def _poll_status(self, job_id: str) -> Optional[str]:
        for r in self.router.candidates_batch()[:MAX_ROUTE_ATTEMPTS]:
            try:
                resp = self._upstream(
                    "get", f"{r['url']}/job-status/{job_id}",
                    read_timeout=10.0,
                )
                if resp.status_code == 200:
                    return (resp.json().get("job_status") or {}).get(job_id)
            except (OSError, ValueError):
                continue
        return None

    # -- interactive relay ---------------------------------------------

    def _relay_interactive(self, tail: str, body: bytes) -> None:
        t_arrival = time.monotonic()
        chat = tail == "chat/completions"
        try:
            doc = json.loads(body) if body else {}
        except ValueError as e:
            self._openai_error(
                400, f"invalid JSON body: {e}", "invalid_request_error"
            )
            return
        wants_stream = bool(doc.get("stream"))
        obs = self.router.obs
        from . import replay as replay_mod

        tid = obs.trace_begin(
            "interactive",
            replay_mod.replay_attrs(
                doc, chat, wants_stream, time.time(), len(body)
            ),
            t0_mono=t_arrival,
        )
        t_probe = time.monotonic()
        cands, scores = self.router.candidates_interactive(doc, chat)
        t_picked = time.monotonic()
        obs.span(
            tid, "affinity_probe", t_probe, t_picked - t_probe,
            {"n_healthy": len(cands)},
        )
        obs.span(
            tid, "route_pick", t_arrival, t_picked - t_arrival,
            {"n_candidates": len(cands)},
        )
        if not cands:
            obs.end(tid, "error")
            self._openai_error(
                503, "no healthy replica available", "service_unavailable"
            )
            return
        tried = 0
        last_err: Optional[str] = None
        for r in cands:
            if tried >= MAX_ROUTE_ATTEMPTS:
                break
            if self.router._route_fault(r["rid"]):
                last_err = f"route fault injected for {r['rid']}"
                obs.event(
                    tid, "retry_failover",
                    {"rid": r["rid"], "reason": "route fault injected"},
                )
                self._note_interactive_retry(tried)
                tried += 1
                continue
            tried += 1
            t_conn = time.monotonic()
            try:
                resp = self._upstream(
                    "post",
                    f"{r['url']}/v1/{tail}",
                    body,
                    stream=wants_stream,
                    read_timeout=self.router.stall_timeout
                    if wants_stream
                    else READ_TIMEOUT_S,
                    content_type="application/json",
                    trace_id=tid,
                )
            except OSError as e:
                # died before ANY response: transparent retry
                last_err = f"{r['rid']}: {e}"
                obs.event(
                    tid, "retry_failover",
                    {"rid": r["rid"], "reason": f"{type(e).__name__}"},
                )
                self._note_interactive_retry(tried - 1)
                continue
            obs.span(
                tid, "upstream_connect", t_conn,
                time.monotonic() - t_conn,
                {"rid": r["rid"], "status": resp.status_code},
            )
            obs.annotate(
                tid, {"replica": r["rid"], "replica_url": r["url"]}
            )
            self.router._count("interactive_routed")
            self.router.membership.bump_load(r["rid"])
            if scores.get(r["rid"], 0) > 0:
                self.router._count("prefix_hits")
                if telemetry.ENABLED:
                    telemetry.FLEET_ROUTED_PREFIX_HITS_TOTAL.inc(1.0)
            if not r.get("fleet_protocol"):
                self.router._count("probe_only_routes")
            obs.observe_route(
                time.monotonic() - t_arrival, "interactive", tid
            )
            if wants_stream and resp.status_code == 200:
                self._relay_sse(r["rid"], resp, tid=tid)
            else:
                obs.event(tid, "first_byte", {"rid": r["rid"]})
                self._relay_response(resp)
                obs.end(
                    tid, "ok" if resp.status_code == 200 else "error"
                )
            return
        obs.end(tid, "error")
        self._openai_error(
            503,
            f"no replica answered after {tried} attempt(s) "
            f"({last_err or 'no candidates'})",
            "service_unavailable",
        )

    def _note_interactive_retry(self, prior_attempts: int) -> None:
        if prior_attempts >= 0:
            self.router._count("failover_interactive")
            if telemetry.ENABLED:
                telemetry.FLEET_FAILOVERS_TOTAL.inc(1.0, "interactive")

    def _relay_sse(
        self, rid: str, resp: Any, tid: Optional[str] = None
    ) -> None:
        """Relay an upstream SSE stream. The first relayed byte commits
        us to this replica: after it, an upstream death or stall
        becomes a structured error frame + [DONE] within the stall
        timeout — the mid-stream contract is 'never a silent hang',
        not 'hide the failure' (a transparent mid-stream retry would
        replay tokens)."""
        obs = self.router.obs
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        clean_done = False
        first = True
        failed: Optional[str] = None
        try:
            for chunk in resp.iter_content():
                if not chunk:
                    continue
                if first:
                    first = False
                    obs.event(tid, "first_byte", {"rid": rid})
                send(chunk)
                if b"[DONE]" in chunk:
                    clean_done = True
        except (BrokenPipeError, ConnectionResetError):
            obs.end(tid, "client_detached")
            return  # our client detached; upstream cancels via its ping
        except OSError as e:
            failed = f"replica connection lost mid-stream: {e}"
        except Exception as e:  # noqa: BLE001 — a garbled upstream
            failed = f"mid-stream relay error: {type(e).__name__}: {e}"
        if not clean_done and failed is None:
            failed = "replica closed the stream without [DONE]"
        obs.end(tid, "ok" if failed is None else "stream_error")
        if failed is not None:
            self.router._count("failover_stream_error")
            if telemetry.ENABLED:
                telemetry.FLEET_FAILOVERS_TOTAL.inc(1.0, "stream_error")
            err = {
                "error": {
                    "message": failed,
                    "type": "server_error",
                    "code": 502,
                    "replica": rid,
                }
            }
            try:
                send(f"data: {json.dumps(err)}\n\n".encode())
            except (BrokenPipeError, ConnectionResetError, OSError):
                return
        try:
            if failed is not None:
                # the upstream's own [DONE] ended a clean stream; the
                # JAX router sends a second one after it
                send(b"data: [DONE]\n\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass


# -- construction ------------------------------------------------------


def make_fleet_server(
    router: FleetRouter,
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    verbose: bool = False,
) -> ThreadingHTTPServer:
    handler = type(
        "BoundFleetHandler", (FleetHTTPHandler,), {"router": router}
    )
    server = frames.ListeningServer((host, port), handler)
    server.verbose = verbose  # type: ignore[attr-defined]
    server.daemon_threads = True
    return server


def start_fleet_thread(
    replica_urls: List[str],
    host: str = "127.0.0.1",
    port: int = 0,
    probe_interval: float = 0.25,
    probe_timeout: float = 2.0,
    stall_timeout: float = STALL_TIMEOUT_S,
    monitor_interval: Optional[float] = None,
    monitor_window: Optional[float] = None,
) -> Tuple[FleetRouter, ThreadingHTTPServer, threading.Thread, str]:
    """Start a router + HTTP thread (tests/benchmarks); returns
    (router, server, thread, base_url)."""
    router = FleetRouter(
        replica_urls,
        probe_interval=probe_interval,
        probe_timeout=probe_timeout,
        stall_timeout=stall_timeout,
        monitor_interval=monitor_interval,
        monitor_window=monitor_window,
    )
    router.start()
    server = make_fleet_server(router, host, port)
    thread = threading.Thread(
        target=server.serve_forever, daemon=True, name="sutro-fleet-http"
    )
    thread.start()
    return (
        router,
        server,
        thread,
        f"http://{host}:{server.server_address[1]}",
    )


def serve_fleet(
    replica_urls: List[str],
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    probe_interval: float = 1.0,
    verbose: bool = True,
) -> None:
    """Blocking entry point (the reference's ``sutro fleet serve``)."""
    import signal

    router = FleetRouter(replica_urls, probe_interval=probe_interval)
    router.start()
    server = make_fleet_server(router, host, port, verbose=verbose)

    stopping = threading.Event()

    def _stop(signum: int, frame: Any) -> None:
        if not stopping.is_set():
            stopping.set()
            threading.Thread(
                target=server.shutdown, daemon=True, name="fleet-stop"
            ).start()

    try:
        signal.signal(signal.SIGTERM, _stop)
    except ValueError:
        pass  # not the main thread
    print(
        f"sutro-tpu-torch fleet router on http://{host}:{port} fronting "
        f"{len(replica_urls)} replica(s)"
    )
    for u in replica_urls:
        print(f"  - {u}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()

