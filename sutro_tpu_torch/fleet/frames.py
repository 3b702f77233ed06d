"""Router↔replica wire frames for the replica fleet.

The port of ``sutro_tpu/fleet/frames.py``. Its transports are the
standard library's (the card's machine has no ``requests``): one
transport, ``_open`` over ``http.client`` (``UpstreamResponse``), with
``requests``' split of a connect timeout from a per-read one, and one
place that maps its failures (``_io``). ``_send`` is its small JSON
exchange, for the prober, affinity and obs.

The fleet front door (``fleet/router.py``) talks to engine replicas
over three tiny JSON surfaces, all strictly additive (the same
protocol-versioning contract as the dp/elastic frames in
``engine/dphost.py`` — graftlint's wire passes cover this module
because it defines ``_send``):

- ``GET /fleet-state``  -> a ``fleet_state`` frame: readiness/drain
  state plus a load report the router's least-loaded policy consumes.
  An old replica 404s here; the router degrades that replica to
  health-probe-only routing (``GET /healthz``) — never a crash.
- ``POST /fleet-warm``  -> body is a ``warm_probe`` frame carrying the
  ORIGINAL OpenAI request body; the replica answers with a
  ``warm_report`` frame: how many prompt tokens its radix prefix store
  already holds warm (``prefixstore.peek`` — side-effect free). The
  router routes interactive traffic to the warmest replica.

Parsers here use ``.get`` everywhere: unknown keys from a newer peer
are ignored, missing keys from an older peer default — a version skew
between router and replica degrades routing fidelity, never liveness.
"""

from __future__ import annotations

from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional

#: protocol revision carried in every frame (additive: a reader never
#: rejects a frame over ``v`` — it only gates optional features)
FLEET_WIRE_V = 1


# -- send-side frame constructors (the schema source of truth) ---------


def fleet_state_frame(
    state: str,
    draining: bool,
    ready: bool,
    load: Dict[str, Any],
    models: List[str],
) -> Dict[str, Any]:
    """Replica -> router: readiness + load report (``GET /fleet-state``)."""
    return {
        "t": "fleet_state",
        "v": FLEET_WIRE_V,
        "ok": bool(ready and not draining),
        "state": state,  # warming | ready | draining
        "draining": bool(draining),
        "ready": bool(ready),
        "load": load,
        "models": list(models),
        # feature flags the router gates on (additive: old routers
        # ignore them, old replicas simply don't send them)
        "warm_probe": True,
        # observability plane: X-Sutro-Trace adoption plus the
        # /metrics-snapshot and /trace-doc scrape endpoints
        "fleet_obs": True,
    }


def warm_probe_frame(
    body: Dict[str, Any], chat: bool, model: Optional[str] = None
) -> Dict[str, Any]:
    """Router -> replica: warm-prefix probe (``POST /fleet-warm``).
    Carries the ORIGINAL OpenAI request body so the replica tokenizes
    exactly what a subsequent submit would — the reported warm count is
    the one the gateway will observe."""
    return {
        "t": "warm_probe",
        "v": FLEET_WIRE_V,
        "chat": bool(chat),
        "model": model or body.get("model"),
        "body": body,
    }


def warm_report_frame(warm_tokens: int, prompt_tokens: int) -> Dict[str, Any]:
    """Replica -> router: answer to a ``warm_probe``."""
    return {
        "t": "warm_report",
        "v": FLEET_WIRE_V,
        "warm_tokens": int(warm_tokens),
        "prompt_tokens": int(prompt_tokens),
    }


def metrics_snapshot_frame(
    epoch_unix: float, snapshot: Dict[str, Any]
) -> Dict[str, Any]:
    """Replica -> router: the replica's own registry snapshot
    (``GET /metrics-snapshot``) — ``MetricsRegistry.export_snapshot``
    output plus the wall clock the router's federation layer needs to
    re-anchor by skew. The router ships per-scrape *deltas* into its
    federated registry (``snapshot_delta``), so the frame stays the
    raw cumulative snapshot."""
    return {
        "t": "metrics_snapshot",
        "v": FLEET_WIRE_V,
        "epoch_unix": float(epoch_unix),
        "snapshot": snapshot,
    }


def trace_doc_frame(
    epoch_unix: float, doc: Dict[str, Any]
) -> Dict[str, Any]:
    """Replica -> router: one raw per-request trace document
    (``GET /trace-doc/{id}``) for cross-process stitching. Carries the
    replica's wall clock so the router can re-anchor the replica's
    span offsets onto its own timeline (round-10 skew convention)."""
    return {
        "t": "trace_doc",
        "v": FLEET_WIRE_V,
        "epoch_unix": float(epoch_unix),
        "doc": doc,
    }


# -- recv-side tolerant parsers ----------------------------------------


def parse_fleet_state(doc: Any) -> Optional[Dict[str, Any]]:
    """Tolerant read of a ``fleet_state`` frame (or a bare ``/healthz``
    document from a replica that predates the fleet protocol). Returns
    a normalized dict or None when the document is unusable."""
    if not isinstance(doc, dict):
        return None
    t = doc.get("t")
    if t is not None and t != "fleet_state":
        return None
    load = doc.get("load")
    return {
        "ok": bool(doc.get("ok", False)),
        "state": str(doc.get("state") or ("ready" if doc.get("ok") else "")),
        "draining": bool(doc.get("draining", False)),
        "ready": bool(doc.get("ready", doc.get("ok", False))),
        "load": load if isinstance(load, dict) else {},
        "models": list(doc.get("models") or []),
        # legacy /healthz docs carry no "t": mark them so the router
        # knows this replica speaks only the health-probe protocol
        "fleet_protocol": t == "fleet_state",
        "warm_probe": bool(doc.get("warm_probe", False)),
        "fleet_obs": bool(doc.get("fleet_obs", False)),
    }


def parse_warm_report(doc: Any) -> int:
    """Tolerant read of a ``warm_report``; anything unusable is 0 warm
    tokens (a cold replica), never an error."""
    if not isinstance(doc, dict):
        return 0
    try:
        return max(0, int(doc.get("warm_tokens") or 0))
    except (TypeError, ValueError):
        return 0


def parse_metrics_snapshot(doc: Any) -> Optional[Dict[str, Any]]:
    """Tolerant read of a ``metrics_snapshot`` frame. Returns
    ``{"epoch_unix": float, "snapshot": dict}`` or None when the
    document is unusable (an old replica 404s the endpoint — the
    router just skips federation for it)."""
    if not isinstance(doc, dict) or doc.get("t") != "metrics_snapshot":
        return None
    snap = doc.get("snapshot")
    if not isinstance(snap, dict):
        return None
    try:
        epoch = float(doc.get("epoch_unix") or 0.0)
    except (TypeError, ValueError):
        epoch = 0.0
    return {"epoch_unix": epoch, "snapshot": snap}


def parse_trace_doc(doc: Any) -> Optional[Dict[str, Any]]:
    """Tolerant read of a ``trace_doc`` frame. Returns
    ``{"epoch_unix": float, "doc": dict}`` or None — a replica that
    evicted (or never had) the trace degrades the stitch to
    router-spans-only, never an error."""
    if not isinstance(doc, dict) or doc.get("t") != "trace_doc":
        return None
    inner = doc.get("doc")
    if not isinstance(inner, dict):
        return None
    try:
        epoch = float(doc.get("epoch_unix") or 0.0)
    except (TypeError, ValueError):
        epoch = 0.0
    return {"epoch_unix": epoch, "doc": inner}


def load_score(load: Dict[str, Any]) -> int:
    """Scalar least-loaded score from a ``fleet_state`` load report.
    Unknown/missing fields count 0, so old replicas sort as idle
    rather than unroutable."""
    score = 0
    for key in ("jobs_queued", "jobs_running", "interactive_active"):
        try:
            score += max(0, int(load.get(key) or 0))
        except (TypeError, ValueError):
            continue
    return score


# -- transport ---------------------------------------------------------


class UpstreamError(OSError):
    """A router->replica transport failure: the replica refused, reset
    or cut the connection, or sent a garbled answer. It is an
    ``OSError``, as ``requests``' ``ConnectionError`` and
    ``ChunkedEncodingError`` are, so it lands on the reference's
    ``except OSError`` branches; it is neither ``ConnectionResetError``
    nor ``BrokenPipeError``, which the relays keep for their own
    client's socket ("the client detached")."""


def _io(fn: Any, *args: Any) -> Any:
    """``fn(*args)`` on the upstream connection, with its failures
    raised as ``UpstreamError``, except a read past the socket's
    timeout, which stays ``socket.timeout`` (an ``OSError`` too). A
    cut body is ``http.client.IncompleteRead``, not an ``OSError``; a
    reset is the socket's own ``ConnectionResetError``."""
    import http.client

    try:
        return fn(*args)
    except TimeoutError:
        raise
    except (http.client.HTTPException, OSError) as e:
        raise UpstreamError(f"{type(e).__name__}: {e}") from e


def _send(
    method: str,
    url: str,
    frame: Optional[Dict[str, Any]] = None,
    timeout: float = 2.0,
) -> Any:
    """One router->replica JSON exchange over ``_open``; returns the
    decoded JSON document with the answer's status as ``_status``.
    A non-2xx answer is a *protocol* answer (404 = endpoint
    unsupported, 503 = draining/warming), not a transport error:
    callers branch on ``_status`` without exceptions. Transport
    failures raise ``OSError``, so callers share one failure taxonomy
    with the engine's transient-retry policy."""
    import json

    body = None if method == "get" else json.dumps(frame).encode()
    resp = _open(
        method, url, body,
        {} if body is None else {"Content-Type": "application/json"},
        connect_timeout=timeout, read_timeout=timeout,
    )
    try:
        doc = json.loads(resp.content)
    except ValueError:
        doc = {}
    if isinstance(doc, dict):
        doc.setdefault("_status", resp.status_code)
    return doc


class UpstreamResponse:
    """One router->replica answer over ``http.client``: ``status_code``,
    ``headers`` and the body, read whole (``content``, ``json()``) or,
    with ``stream=True``, as it arrives (``iter_lines()`` line by line,
    ``iter_content()`` chunk by chunk). Non-2xx answers are answers, not
    errors. A replica that cuts or resets the connection mid-body
    raises ``UpstreamError`` (``_io``); a stall past the read timeout
    raises ``socket.timeout``. Both are ``OSError``s, as ``requests``'
    ``ChunkedEncodingError`` and ``ReadTimeout`` are."""

    def __init__(self, conn: Any, resp: Any, stream: bool):
        self.status_code = int(resp.status)
        self.headers = resp.headers
        self._conn = conn
        self._resp = resp
        self._content: Optional[bytes] = None
        if not stream:
            try:
                self._content = _io(resp.read)
            finally:
                self.close()

    @property
    def content(self) -> bytes:
        if self._content is None:
            try:
                self._content = _io(self._resp.read)
            finally:
                self.close()
        return self._content

    def json(self) -> Any:
        import json

        return json.loads(self.content)

    def iter_lines(self):
        """The body's lines without their line ends, each as soon as it
        has arrived (``stream=True``)."""
        try:
            while True:
                line = _io(self._resp.readline)
                if not line:
                    return
                yield line.rstrip(b"\r\n")
        finally:
            self.close()

    def iter_content(self, chunk_size: int = 65536):
        """The body in the pieces it arrives in, at most ``chunk_size``
        bytes each (``stream=True``)."""
        try:
            while True:
                data = _io(self._resp.read1, chunk_size)
                if not data:
                    return
                yield data
        finally:
            self.close()

    def close(self) -> None:
        self._resp.close()
        self._conn.close()


def _open(
    method: str,
    url: str,
    body: Optional[bytes] = None,
    headers: Optional[Dict[str, str]] = None,
    connect_timeout: float = 5.0,
    read_timeout: float = 600.0,
    stream: bool = False,
) -> UpstreamResponse:
    """One router->replica request over ``http.client``. The connect
    has ``connect_timeout``; every read after it ``read_timeout`` (the
    socket's own timeout), so a silent replica raises within it. A
    replica that is down or dies before answering raises
    ``UpstreamError``."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    cls = (
        http.client.HTTPSConnection
        if u.scheme == "https"
        else http.client.HTTPConnection
    )
    conn = cls(u.hostname, u.port, timeout=connect_timeout)
    path = (u.path or "/") + (f"?{u.query}" if u.query else "")

    def exchange() -> Any:
        conn.connect()
        conn.sock.settimeout(read_timeout)
        conn.request(method.upper(), path, body=body, headers=headers or {})
        return conn.getresponse()

    try:
        resp = _io(exchange)
    except OSError:
        conn.close()
        raise
    return UpstreamResponse(conn, resp, stream)


class ListeningServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for bursts (the
    engine's server and the router): the accept loop is one Python
    thread, and while an engine's worker holds the interpreter lock a
    burst of clients waits in the kernel's accept queue, which
    ``socketserver``'s default of 5 overflows (a kernel that aborts on
    overflow resets the connection)."""

    request_queue_size = 128
