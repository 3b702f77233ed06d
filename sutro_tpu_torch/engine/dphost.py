"""Engine-level data parallelism over TCP: one batch job across several
engine processes.

The port of ``sutro_tpu/engine/dphost.py``, byte-compatible with it on
the wire (the frames below, the ``SUTRO_DP_*`` variables and the
``dphost.*`` fault sites). Each rank is one ``LocalEngine`` process
computing on its own device (two ranks may share one card); a job's
rows are strided across ranks, workers stream finished rows to the
rank-0 coordinator over a TCP channel, and the coordinator's jobstore
performs the order-preserving merge keyed by ``row_id`` — execution
order is whatever batching dictates on each rank, input order is
reassembled at finalize exactly as in the single-host path.

Results deliberately do NOT ride device collectives: rows are
variable-length and the merge is control-plane work.

Protocol (newline-delimited JSON over one TCP connection per worker):

  worker -> coord   {"t": "hello", "rank": N
                     [, "elastic": 1]}
  coord  -> worker  {"t": "resume", "rows": [row_id, ...]
                     [, "tele": {<trace context>}]
                     [, "elastic": 1, "rank": N,
                        "assign": [row_id, ...]]}     (reply)
  worker -> coord   {"t": "res", "row_id", "token_ids", "logprob",
                     "finish", "in_toks"}
  worker -> coord   {"t": "emb", "row_id", "vec"}   (embedding jobs)
  worker -> coord   {"t": "prog", <scheduler progress fields>}
  worker -> coord   {"t": "fault", "ev": {<failure_log event>}}
  worker -> coord   {"t": "hb", "rank": N}          (liveness beacon)
  worker -> coord   {"t": "idle", "rank": N}        (elastic: shard done,
                     ready for more rows)
  worker -> coord   {"t": "drain", "rank": N, "rows": [unfinished ids]
                     [, "tele": {...}]}             (elastic: preemption
                     drain — deregister after flushing finished rows)
  worker -> coord   {"t": "done", "outcome": "completed"
                     [, "tele": {<telemetry shard>}]}
  worker -> coord   {"t": "err", "msg": "..."
                     [, "tele": {<telemetry shard>}]}
  coord  -> worker  {"t": "cancel"}
  coord  -> worker  {"t": "reshard", "rows": [row_id, ...]}  (elastic:
                     additional rows to run — requeued or stolen)
  coord  -> worker  {"t": "nomore"}                 (elastic: round over,
                     send your terminal frame)

Elastic membership (v2, strictly additive): a worker advertising
``"elastic": 1`` in its hello receives an explicit row ASSIGNMENT in the
resume reply instead of deriving its shard from a fixed stride, and may
greet with ANY rank — a rank outside ``[1, world)`` is a *late joiner*
and is admitted with a freshly allocated rank. After finishing its
assignment the worker parks on an ``idle`` frame and the coordinator
feeds it requeued rows (a dead/stalled/drained rank's pending work) or
STEALS the tail half of a straggler's remaining rows (first result
wins; the coordinator drops duplicate rows by ``row_id`` before the
merge, so dual-assignment is idempotent). Every key is additive, so
degradation is automatic in both directions: an elastic worker that
gets no ``assign`` back (old coordinator) falls back to the fixed
stride, and an old worker greeting an elastic coordinator is treated as
a fixed-world member whose assignment is exactly its stride.

The optional ``tele`` keys are the distributed-telemetry layer
(telemetry/distributed.py): the coordinator stamps a versioned trace
context into ``resume``; workers ship a bounded span/metrics shard
back on their terminal frame (``done``/``err``/``drain``). Both keys
are strictly additive — an old peer ignores them and the round
completes with partial telemetry (OBSERVABILITY.md "Distributed
telemetry").

The ``resume`` reply carries the coordinator's already-done row_ids
(its partial store holds EVERY rank's flushed rows), so a relaunched
pod resumes row-granularly on worker shards too — workers have no
authoritative store of their own.

Configuration is per-process environment (set by the pod launcher):

  SUTRO_DP_WORLD    number of engine processes (>1 enables the path)
  SUTRO_DP_RANK     this process's rank; 0 is the coordinator. An
                    elastic worker with rank >= world is a late joiner
  SUTRO_DP_COORD    host:port the coordinator listens on
  SUTRO_DP_SECRET   optional shared secret mixed into the job-key
                    handshake (see trust model below)
  SUTRO_DP_STALL_TIMEOUT  seconds of silence from a live worker
                    connection before the coordinator declares it
                    stalled (default 600; 0 disables). Fixed-world
                    rounds fail resumably; elastic rounds requeue the
                    rank's pending rows and keep going. Enforced for
                    the WHOLE round by a watchdog thread — workers
                    heartbeat every SUTRO_DP_HEARTBEAT seconds
                    (default 20) so a slow but alive slice is never
                    mistaken for a hung one. Both are also
                    ``EngineConfig`` fields (``dp_stall_timeout`` /
                    ``dp_heartbeat``, applied via
                    :func:`configure_channel`); the environment
                    variables override the config when set.
  SUTRO_DP_JOIN_GRACE     elastic rounds: seconds to wait for a
                    reserved fixed rank to connect before its rows are
                    requeued (default: the accept timeout)
  SUTRO_DP_STEAL_AFTER    elastic rounds: seconds without a result from
                    a busy rank before an idle rank may steal its tail
                    rows (default 180; 0 disables stealing)
  SUTRO_DP_REQUEUE_LIMIT  elastic rounds: max times one row may be
                    requeued before the round fails resumably
                    (default 3 — a row that kills every host it lands
                    on must not ping-pong forever)

Trust model: the channel is designed for a POD-INTERNAL network — the
slices of one pod behind one job launcher, the same boundary the
reference's fleet runs inside. The job key in the hello handshake is
derived from job content, so any host that can reach SUTRO_DP_COORD and
knows the job inputs could connect; on networks where that matters, set
``SUTRO_DP_SECRET`` to the same random value on every rank — it is
mixed into the key derivation (api.py), making the key underivable from
job content alone. It is an authentication tag, not encryption: use an
actually-private network (or tunnel) for confidential row data.
"""

from __future__ import annotations

import collections
import inspect
import json
import logging
import os
import queue as _queuelib
import random
import signal
import socket
import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import telemetry
from . import faults
from .scheduler import GenRequest, GenResult

logger = logging.getLogger(__name__)


def _dp_event(kind: str) -> None:
    """Coordinator-liveness event counter (reconnect / stall / reject /
    fault_forwarded / join / requeue / steal / drain / dup_result /
    resume_port_busy) — the dp channel's registry surface."""
    if telemetry.ENABLED:
        telemetry.DP_EVENTS_TOTAL.inc(1.0, kind)

# worker engines may still be importing torch, loading a checkpoint or
# building kernels when the coordinator starts listening — generous by
# design (a loaded CI box runs several engine processes at once)
_ACCEPT_TIMEOUT_S = float(os.environ.get("SUTRO_DP_ACCEPT_TIMEOUT", "420"))


# -- channel configuration (EngineConfig <-> env) -----------------------
#
# Historically env-only; EngineConfig.dp_stall_timeout/dp_heartbeat now
# feed the same knobs through configure_channel(). Environment variables
# keep overriding the configured values (same precedence as every other
# engine env knob, and what the chaos tests rely on).

_CHANNEL_CFG: Dict[str, Optional[float]] = {
    "stall_timeout": None,
    "heartbeat": None,
}


def configure_channel(
    stall_timeout: Optional[float] = None,
    heartbeat: Optional[float] = None,
) -> None:
    """Install process-level channel defaults (from EngineConfig).
    ``None`` leaves a knob untouched; values must be >= 0 (0 disables
    the watchdog / the beacon)."""
    for key, val in (
        ("stall_timeout", stall_timeout),
        ("heartbeat", heartbeat),
    ):
        if val is None:
            continue
        val = float(val)
        if val < 0:
            raise ValueError(
                f"dp_{key} must be >= 0 (0 disables), got {val}"
            )
        _CHANNEL_CFG[key] = val


def _channel_param(env: str, key: str, default: float) -> float:
    raw = os.environ.get(env)
    if raw is not None and raw != "":
        return float(raw)
    val = _CHANNEL_CFG.get(key)
    return default if val is None else val


def _stall_timeout_s() -> float:
    return _channel_param("SUTRO_DP_STALL_TIMEOUT", "stall_timeout", 600.0)


def _heartbeat_s() -> float:
    return _channel_param("SUTRO_DP_HEARTBEAT", "heartbeat", 20.0)


# -- fleet view registry ------------------------------------------------
#
# The coordinator publishes a per-job membership snapshot here while an
# elastic round runs (bounded; read by LocalEngine.job_fleet -> the
# server's GET /job-fleet/{id} and `sutro jobs status`). api.py persists
# the final snapshot to jobs/<id>/fleet.json when the round ends.

_FLEET_LOCK = threading.Lock()
_FLEET_CAP = 64
FLEET: "collections.OrderedDict[str, Dict]" = collections.OrderedDict()


def _fleet_publish(job_id: str, snap: Dict) -> None:
    if not job_id:
        return
    with _FLEET_LOCK:
        FLEET[job_id] = snap
        FLEET.move_to_end(job_id)
        while len(FLEET) > _FLEET_CAP:
            FLEET.popitem(last=False)
    if telemetry.ENABLED:
        telemetry.DP_FLEET_SIZE.set(float(snap.get("live_ranks", 0)))


def fleet_view(job_id: str) -> Optional[Dict]:
    """Live membership snapshot for a running elastic round (None when
    this process is not coordinating the job)."""
    with _FLEET_LOCK:
        snap = FLEET.get(job_id)
        return dict(snap) if snap is not None else None


# -- preemption drain ---------------------------------------------------

_DRAIN = threading.Event()


def request_drain() -> None:
    """Ask every elastic dp worker in this process to drain: finish the
    in-flight decode window, flush completed rows + telemetry shard,
    hand unfinished row ids back to the coordinator, deregister. Wired
    to SIGTERM when an elastic worker runs on the main thread (the spot
    preemption notice); callable directly by embedders. Sticky — the
    process is expected to be going away."""
    _DRAIN.set()


def _install_sigterm() -> Optional[object]:
    """Install the drain handler; returns the previous handler for the
    caller's finally to restore, or None when not installable (non-main
    thread — signal.signal would raise)."""
    if threading.current_thread() is not threading.main_thread():
        return None
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            _DRAIN.set()
            if callable(prev) and prev not in (
                signal.SIG_IGN, signal.SIG_DFL,
            ):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _on_sigterm)
        return prev
    except (ValueError, OSError):  # exotic embedders
        return None


class TruncatedFrameError(OSError):
    """The peer closed mid-NDJSON-frame: bytes arrived after the last
    newline. Distinguishes a torn frame — data lost at a KNOWN point,
    reported as a connection fault — from a clean EOF (this tail used
    to be silently discarded, i.e. silent row loss)."""


def _accepts_kwarg(fn: Callable, name: str) -> bool:
    """Does ``fn`` take keyword ``name``? Probed once per call site so
    the run_shard contract stays backward compatible (older shard
    runners without ``on_row_event`` keep working)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get(name)
    if p is not None:
        return p.kind in (
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
            inspect.Parameter.KEYWORD_ONLY,
        )
    return any(
        q.kind == inspect.Parameter.VAR_KEYWORD
        for q in sig.parameters.values()
    )


@dataclass(frozen=True)
class DPWorld:
    rank: int
    world: int
    host: str
    port: int

    @classmethod
    def from_env(cls) -> Optional["DPWorld"]:
        world = int(os.environ.get("SUTRO_DP_WORLD", "1"))
        if world <= 1:
            return None
        rank = int(os.environ["SUTRO_DP_RANK"])
        host, port = os.environ["SUTRO_DP_COORD"].rsplit(":", 1)
        return cls(rank=rank, world=world, host=host, port=int(port))


def _row_id(item) -> int:
    """Shard items are GenRequests (generation) or (row_id, ids) tuples
    (embedding)."""
    rid = getattr(item, "row_id", None)
    return int(item[0]) if rid is None else int(rid)


def shard_requests(
    requests: List[GenRequest], rank: int, world: int
) -> List[GenRequest]:
    """Strided row sharding: row_id % world == rank. Strided (not
    blocked) so admission-order effects (shortest-prompt-first batched
    prefill sorts within a shard) stay balanced across ranks when
    callers submit length-sorted inputs. Accepts embedding tuples too
    (anything :func:`_row_id` understands)."""
    return [q for q in requests if _row_id(q) % world == rank]


def _reconnect_delay(attempt: int, rank: int) -> float:
    """Exponential backoff + jitter between reconnect attempts. Under an
    active fault plan the jitter derives from the plan seed (same
    construction as faults.backoff_delay) so chaos runs replay with
    identical timing; otherwise it is genuinely random — a pod-wide
    relaunch must not hammer the coordinator port in lockstep."""
    base = min(0.25 * (2.0 ** attempt), 5.0)
    plan = faults.ACTIVE
    if plan is not None:
        frac = zlib.crc32(
            f"{plan.seed}:dp-reconnect:{rank}:{attempt}".encode()
        ) / 2**32
    else:
        frac = random.random()
    return base * (0.5 + frac)


def _hard_close(sock: socket.socket) -> None:
    """Close with an immediate FIN. A plain ``close()`` while another
    thread of the SAME process is blocked in ``recv`` on the fd keeps
    the kernel file alive and sends nothing — the peer would never see
    EOF. ``shutdown`` tears the connection down right now, the way a
    process death would."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # already dead — that's what we wanted
    sock.close()


def _send(sock: socket.socket, msg: Dict) -> None:
    # callers hold their channel's send lock on purpose: sendall is not
    # atomic across messages, and the lock is what keeps NDJSON frames
    # from interleaving — the send IS the critical section
    # graftlint: disable=lock-blocking-call
    sock.sendall(json.dumps(msg, separators=(",", ":")).encode() + b"\n")


def _recv_lines(sock: socket.socket):
    buf = b""
    while True:
        chunk = sock.recv(1 << 16)
        if not chunk:
            if buf:
                # EOF mid-frame: the peer died between a frame's first
                # byte and its newline — surface it as a fault so the
                # drop is REPORTED (consumers treat it like any other
                # connection loss), never silently swallowed
                raise TruncatedFrameError(
                    f"connection closed mid-frame ({len(buf)} bytes of "
                    "unterminated NDJSON tail)"
                )
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line:
                yield json.loads(line)


@dataclass(frozen=True)
class EmbResult:
    """One embedded row crossing the channel (embedding jobs DP the
    same way as generation: strided shards, coordinator merge)."""

    row_id: int
    vector: List[float]


def _res_msg(res) -> Dict:
    if isinstance(res, EmbResult):
        return {"t": "emb", "row_id": res.row_id, "vec": res.vector}
    out = {
        "t": "res",
        "row_id": res.row_id,
        "token_ids": [int(t) for t in res.token_ids],
        "logprob": float(res.cumulative_logprob),
        "finish": res.finish_reason,
        "in_toks": int(res.input_tokens),
    }
    if getattr(res, "error", None) is not None:
        # quarantined rows cross the channel with their error message
        # (row-level failure domains span ranks)
        out["err"] = str(res.error)
    return out


def _msg_res(m: Dict) -> GenResult:
    return GenResult(
        row_id=int(m["row_id"]),
        token_ids=[int(t) for t in m["token_ids"]],
        cumulative_logprob=float(m["logprob"]),
        finish_reason=str(m["finish"]),
        input_tokens=int(m["in_toks"]),
        error=m.get("err"),
    )


def _tele_payload(tele) -> Optional[Dict]:
    """Best-effort shard build: telemetry must never fail the round."""
    if tele is None:
        return None
    try:
        return tele.payload()
    except Exception:
        logger.warning("telemetry shard build failed", exc_info=True)
        return None


def run_dp_worker(
    world: DPWorld,
    run_shard: Callable[..., str],
    shard: List[GenRequest],
    *,
    job_key: str = "",
    should_cancel: Optional[Callable[[], bool]] = None,
    tele=None,
    elastic: bool = False,
    drain: Optional[threading.Event] = None,
) -> str:
    """Rank>0 execution: run the local shard, streaming every finished
    row to the coordinator. The local jobstore is NOT authoritative —
    the caller must skip its own flush/finalize for DP worker runs.

    A coordinator-sent cancel message (or a dropped connection, e.g. the
    coordinator's job failed) cancels the local run.

    ``job_key`` guards against per-rank queue divergence: the
    coordinator port is shared across jobs, so a worker that moved on to
    a different job must not merge its rows into whatever job the
    coordinator is currently serving — mismatched hellos are rejected
    and the worker retries until the coordinator reaches ITS job (or the
    deadline passes).

    ``tele`` (optional, telemetry/distributed.py WorkerTelemetry):
    opened under the trace context the resume reply carries, closed
    into a bounded shard piggybacked on the terminal done/err frame.
    None — or a resume reply without a context (old coordinator) —
    means the round runs exactly as before.

    ``elastic``: advertise the v2 membership protocol. ``shard`` must
    then be the FULL request pool (every not-yet-done row of the job):
    the coordinator's resume reply assigns the subset this rank runs,
    requeued/stolen rows arrive later as ``reshard`` frames, and the
    worker parks on ``idle`` between assignments. An old coordinator
    replies without an assignment and the worker degrades to its fixed
    stride over the pool. Elastic workers also honor preemption drain:
    SIGTERM (main thread), :func:`request_drain`, the ``drain`` event,
    or a ``dphost.preempt`` fault all finish the in-flight window,
    flush, and return unfinished row ids in a ``drain`` frame. Returns
    ``"drained"`` in that case."""
    import time

    remote_cancel = {"flag": False}
    drain_local = {"flag": False}

    def drain_requested() -> bool:
        if not elastic:
            return False
        if drain_local["flag"]:
            return True
        hit = (drain is not None and drain.is_set()) or _DRAIN.is_set()
        if not hit and faults.ACTIVE is not None:
            spec = faults.fire("dphost.preempt")
            if spec is not None:
                if spec.kind == "hang":
                    # widen the preempt race: keep decoding a beat
                    # before the drain lands
                    spec.trigger()
                hit = True
        if hit:
            drain_local["flag"] = True
        return hit

    restore_sig = _install_sigterm() if elastic else None
    # retry until the coordinator binds AND serves this job: a worker
    # with a hot compile cache can reach connect() before the
    # coordinator's engine init finishes (refusal), and rank queues can
    # diverge (reject) — both are ordering, not failure
    deadline = time.monotonic() + _ACCEPT_TIMEOUT_S
    sock = None
    lines = None
    attempt = 0
    try:
        while True:
            if should_cancel and should_cancel():
                # cancelled before the coordinator ever served this job —
                # don't burn the slice retrying a dead port
                return "cancelled"
            if elastic and (
                (drain is not None and drain.is_set())
                or _DRAIN.is_set()
            ):
                # preempted before ever joining (the dphost.preempt
                # fault site is NOT polled here — injected preemption
                # targets a mid-run drain, after admission)
                return "drained"
            try:
                sock = socket.create_connection(
                    (world.host, world.port), timeout=10.0
                )
                sock.settimeout(30.0)  # handshake must be prompt
                hello: Dict = {
                    "t": "hello", "rank": world.rank, "job": job_key,
                }
                if elastic:
                    hello["elastic"] = 1
                _send(sock, hello)
                # one generator for the whole connection: taking the
                # resume reply from a separate generator would drop any
                # bytes (e.g. an early cancel) already buffered behind it
                lines = _recv_lines(sock)
                first = next(lines, None)
                if first and first.get("t") == "resume":
                    sock.settimeout(None)
                    break
                sock.close()
                if first is not None and first.get("t") != "reject":
                    raise RuntimeError(
                        f"dp worker: expected resume reply, got {first!r}"
                    )
            except OSError:
                if sock is not None:
                    sock.close()
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "dp worker: coordinator never served job "
                    f"{job_key!r} within {_ACCEPT_TIMEOUT_S:.0f}s"
                )
            delay = _reconnect_delay(attempt, world.rank)
            attempt += 1
            time.sleep(
                min(delay, max(deadline - time.monotonic(), 0.05))
            )
        already_done = set(first.get("rows", []))
        assigned_rank = int(first.get("rank", world.rank))
        elastic_round = bool(elastic and "assign" in first)
        if elastic_round:
            pool = {_row_id(q): q for q in shard}
            todo = [
                pool[int(r)]
                for r in first.get("assign", ())
                if int(r) in pool and int(r) not in already_done
            ]
        elif elastic:
            # old coordinator: degrade to the fixed-world stride over
            # the pool (same rows a v1 worker would have been handed)
            todo = [
                q
                for q in shard_requests(shard, world.rank, world.world)
                if _row_id(q) not in already_done
            ]
            pool = {}
        else:
            todo = [q for q in shard if _row_id(q) not in already_done]
            pool = {}
        if elastic and faults.ACTIVE is not None:
            # join churn: a worker that dies right after admission — the
            # coordinator must requeue its freshly assigned rows
            spec = faults.fire("dphost.join")
            if spec is not None:
                if spec.kind == "crash":
                    _hard_close(sock)
                spec.trigger()
        if tele is not None:
            try:
                # no context in the reply (old coordinator / telemetry
                # off there) leaves the session inert — nothing ships
                tele.begin(first.get("tele"))
            except Exception:
                logger.warning(
                    "telemetry trace-context open failed", exc_info=True
                )
                tele = None

        directives: "_queuelib.Queue[Tuple]" = _queuelib.Queue()

        def read_control() -> None:
            try:
                for m in lines:
                    t = m.get("t")
                    if t == "cancel":
                        remote_cancel["flag"] = True
                        directives.put(("cancel",))
                    elif t == "reshard":
                        directives.put(
                            (
                                "reshard",
                                [int(r) for r in m.get("rows", ())],
                            )
                        )
                    elif t == "nomore":
                        directives.put(("nomore",))
            except OSError:
                pass
            # EOF: coordinator went away — stop generating for a dead
            # merge
            remote_cancel["flag"] = True
            directives.put(("eof",))

        reader = threading.Thread(target=read_control, daemon=True)
        reader.start()

        lock = threading.Lock()  # sendall is not atomic across messages

        # liveness beacon: results/progress can go quiet for minutes
        # while a device step runs; the coordinator's stall watchdog
        # needs a signal that distinguishes "slow but alive" from "hung"
        hb_stop = threading.Event()
        hb_every = _heartbeat_s()

        def heartbeat() -> None:
            while not hb_stop.wait(hb_every):
                try:
                    with lock:
                        _send(sock, {"t": "hb", "rank": assigned_rank})
                except OSError:
                    return  # channel gone; serve/read paths report it

        if hb_every > 0:
            threading.Thread(
                target=heartbeat, daemon=True, name="sutro-dp-hb"
            ).start()

        # row ids this worker has streamed to a NON-cancelled terminal
        # state — the complement of its assignment is what a drain frame
        # hands back (single mutator: run_shard's on_result thread)
        streamed: Set[int] = set(already_done)

        def on_result(res: GenResult) -> None:
            if faults.ACTIVE is not None:
                spec = faults.fire("dphost.send", row=_row_id(res))
                if spec is not None:
                    if spec.kind == "drop":
                        # tear the frame mid-send: the coordinator must
                        # see a TruncatedFrameError, not silent row
                        # loss. The send is under the channel lock on
                        # purpose — the torn bytes must not interleave
                        # with another frame
                        with lock:
                            try:
                                # graftlint: disable=lock-blocking-call
                                sock.sendall(b'{"t":"res","row_id":')
                            finally:
                                _hard_close(sock)
                    spec.trigger()
            if getattr(res, "finish_reason", None) != "cancelled":
                streamed.add(_row_id(res))
            with lock:
                _send(sock, _res_msg(res))

        def on_row_event(ev: Dict) -> None:
            # forward row retry/quarantine events to the coordinator's
            # authoritative failure_log (best effort: a dead channel is
            # already being reported through the result path)
            try:
                with lock:
                    _send(sock, {"t": "fault", "ev": ev})
            except OSError:
                logger.warning(
                    "could not forward fault event", exc_info=True
                )

        def on_progress(p: Dict) -> None:
            with lock:
                _send(
                    sock,
                    {
                        "t": "prog",
                        "rank": assigned_rank,
                        "input_tokens": p.get("input_tokens", 0),
                        "output_tokens": p.get("output_tokens", 0),
                        "rows_completed": p.get("rows_completed", 0),
                        "tps": p.get(
                            "total_tokens_processed_per_second", 0.0
                        ),
                    },
                )

        def cancelled() -> bool:
            if remote_cancel["flag"]:
                return True
            if drain_requested():
                return True
            return bool(should_cancel and should_cancel())

        def send_drain(assigned_ids: Set[int]) -> str:
            # preemption drain: completed rows are already streamed;
            # everything else in the current assignment goes back to the
            # coordinator for requeue, with the telemetry shard along
            # for the postmortem
            unfinished = sorted(assigned_ids - streamed)
            msg: Dict = {
                "t": "drain", "rank": assigned_rank, "rows": unfinished,
            }
            shard_payload = _tele_payload(tele)
            if shard_payload is not None:
                msg["tele"] = shard_payload
            try:
                with lock:
                    _send(sock, msg)
            except OSError:
                logger.warning(
                    "dp worker: could not send drain frame "
                    "(connection already down)"
                )
            return "drained"

        try:
            kw: Dict = {}
            if _accepts_kwarg(run_shard, "on_row_event"):
                kw["on_row_event"] = on_row_event
            assigned_ids = {_row_id(q) for q in todo}
            outcome: Optional[str] = None
            while True:
                if todo:
                    out = run_shard(
                        todo,
                        on_result=on_result,
                        on_progress=on_progress,
                        should_cancel=cancelled,
                        **kw,
                    )
                else:
                    out = "completed"
                if drain_local["flag"] and not remote_cancel["flag"]:
                    return send_drain(assigned_ids)
                if out != "completed" or not elastic_round:
                    outcome = out
                    break
                # assignment finished: park for requeued/stolen rows
                todo = []
                try:
                    with lock:
                        _send(
                            sock,
                            {"t": "idle", "rank": assigned_rank},
                        )
                except OSError:
                    outcome = "cancelled"
                    break
                stop = None
                while stop is None:
                    try:
                        d = directives.get(timeout=0.25)
                    except _queuelib.Empty:
                        if drain_requested():
                            return send_drain(assigned_ids)
                        if should_cancel and should_cancel():
                            outcome = "cancelled"
                            stop = "stop"
                        continue
                    if d[0] == "reshard":
                        todo = [
                            pool[r] for r in d[1] if r in pool
                        ]
                        assigned_ids |= {_row_id(q) for q in todo}
                        stop = "work"
                    elif d[0] == "nomore":
                        outcome = "completed"
                        stop = "stop"
                    else:  # cancel / eof
                        outcome = "cancelled"
                        stop = "stop"
                if stop == "stop":
                    break
            if faults.ACTIVE is not None:
                spec = faults.fire("dphost.worker_done")
                if spec is not None:
                    if spec.kind == "crash":
                        # hard crash before done: no err message, just a
                        # dead connection for the coordinator to detect
                        _hard_close(sock)
                    elif spec.kind == "hang":
                        # a truly hung process beats no drum: stop the
                        # heartbeat so the stall watchdog sees silence
                        hb_stop.set()
                    spec.trigger()
            done_msg: Dict = {"t": "done", "outcome": outcome}
            shard_payload = _tele_payload(tele)
            if shard_payload is not None:
                done_msg["tele"] = shard_payload
            try:
                with lock:
                    _send(sock, done_msg)
            except OSError:
                if remote_cancel["flag"]:
                    # round already over on the coordinator (e.g. a
                    # thief finished this rank's stolen tail first and
                    # rank 0 closed up): the merge is authoritative,
                    # this rank just stops
                    return "cancelled"
                raise
            return outcome
        except Exception as e:  # noqa: BLE001 — surface to coordinator
            try:
                err_msg: Dict = {
                    "t": "err", "msg": f"{type(e).__name__}: {e}",
                }
                # the shard rides the error too: a failing rank's
                # timeline is exactly what the doctor needs for the
                # postmortem
                shard_payload = _tele_payload(tele)
                if shard_payload is not None:
                    err_msg["tele"] = shard_payload
                with lock:
                    _send(sock, err_msg)
            except OSError:
                logger.warning(
                    "dp worker: could not report error to coordinator "
                    "(connection already down)"
                )
            raise
        finally:
            hb_stop.set()
            sock.close()
    finally:
        if restore_sig is not None:
            try:
                signal.signal(signal.SIGTERM, restore_sig)
            except (ValueError, OSError):
                pass


def serve_resume_round(
    world: DPWorld,
    *,
    job_key: str,
    done_rows: set,
    tele_ctx: Optional[Dict] = None,
    on_worker_tele: Optional[Callable[[int, Dict], None]] = None,
) -> bool:
    """Serve one trivial coordinator round for the resume of a job whose
    rows are ALL already merged. Re-queued workers connect, receive the
    full resume set (so their shard filters to empty), run nothing, and
    report done — a pod-wide resume of a SUCCEEDED job is then a genuine
    cheap no-op on every rank, instead of each worker spinning out its
    accept timeout against an unbound port and flipping its local record
    to CANCELLED. Workers that were NOT re-queued never connect; absence
    is not an error here (unlike a real round — the authoritative
    results already exist on this rank). The accept window is short
    (``SUTRO_DP_RESUME_GRACE``, default 15s): a worker re-queued later
    than that still times out as before.

    Returns True when the round was served, False when the coordinator
    port stayed busy through the bind retries — a LOGGED, resumable
    condition (the caller records it on the job's failure_log; resuming
    again once the other round releases the port serves the workers)."""
    import time as _time

    grace = float(os.environ.get("SUTRO_DP_RESUME_GRACE", "15"))
    attempts = max(
        1, int(os.environ.get("SUTRO_DP_RESUME_BIND_RETRIES", "5"))
    )
    listener = None
    for attempt in range(attempts):
        try:
            listener = socket.create_server(
                (world.host, world.port), reuse_port=False
            )
            break
        except OSError as e:
            # port busy: another job's round owns it and its key check
            # rejects our workers (which keep retrying). Back off and
            # retry the bind — rounds are short; silently skipping used
            # to strand re-queued workers for the full accept timeout.
            if attempt + 1 >= attempts:
                _dp_event("resume_port_busy")
                logger.error(
                    "dp resume round for job key %s unserved: "
                    "coordinator port %s:%d still busy after %d bind "
                    "attempts (%s). Re-queued workers keep retrying "
                    "until their accept deadline; resume the job again "
                    "once the port frees.",
                    job_key[:8], world.host, world.port, attempts, e,
                )
                return False
            _time.sleep(
                faults.backoff_delay(
                    attempt, 0.2, 2.0, key=f"dp-resume-bind:{job_key}"
                )
            )
    threads: List[threading.Thread] = []

    def drain(conn: socket.socket, lines, rank: int) -> None:
        try:
            for m in lines:
                if m.get("t") in ("done", "err", "drain"):
                    # even a trivial no-op round ships its (tiny)
                    # telemetry shard — same wire as a real round
                    shard = m.get("tele")
                    if on_worker_tele is not None and isinstance(
                        shard, dict
                    ):
                        try:
                            on_worker_tele(rank, shard)
                        except Exception:
                            logger.warning(
                                "worker telemetry ingest failed "
                                "(rank %d)", rank, exc_info=True,
                            )
                    break
        except OSError:
            pass
        finally:
            conn.close()

    try:
        # everything from here runs under the finally that closes the
        # listener — the bound port must never outlive this round
        rows = sorted(done_rows or ())
        # OVERALL deadline, not per-accept: a foreign-job rank retrying
        # every 0.5s would otherwise reset a per-accept timeout forever,
        # keeping this port bound past the window
        deadline = _time.monotonic() + grace
        accepted = 0
        while accepted < world.world - 1:
            left = deadline - _time.monotonic()
            if left <= 0:
                break  # grace window over: whoever resumed was served
            listener.settimeout(left)
            try:
                conn, _ = listener.accept()
            except OSError:
                break  # grace window over: whoever resumed was served
            try:
                conn.settimeout(30.0)
                lines = _recv_lines(conn)
                first = next(lines, None)
                if (
                    not first
                    or first.get("t") != "hello"
                    or first.get("job", "") != job_key
                ):
                    try:
                        _send(conn, {"t": "reject"})
                    except OSError:
                        pass
                    conn.close()
                    continue
                resume_msg: Dict = {"t": "resume", "rows": rows}
                if first.get("elastic"):
                    # elastic workers get an explicit (empty)
                    # assignment + nomore so they terminate without
                    # deriving a stride at all
                    resume_msg["elastic"] = 1
                    resume_msg["rank"] = int(first.get("rank", -1))
                    resume_msg["assign"] = []
                if tele_ctx is not None:
                    resume_msg["tele"] = tele_ctx
                _send(conn, resume_msg)
                if first.get("elastic"):
                    _send(conn, {"t": "nomore"})
            except OSError:
                conn.close()
                continue
            accepted += 1
            t = threading.Thread(
                target=drain,
                args=(conn, lines, int(first.get("rank", -1))),
                daemon=True,
            )
            t.start()
            threads.append(t)
    finally:
        # port first: the next round's bind must not wait out the
        # drain-thread joins below (up to 60 s each)
        listener.close()
        for t in threads:
            t.join(timeout=60.0)
    return True


# -- elastic membership state machine -----------------------------------


@dataclass
class _ElasticState:
    """Row-ownership + membership bookkeeping for one elastic round.

    Every method must be called with the coordinator's ``state_cv``
    lock held; methods RETURN failure_log event dicts instead of
    invoking callbacks so callers can emit them after releasing the
    lock (no user callback, socket send, or metrics work runs under
    the condition variable).

    Invariants: a row is in ``done`` the moment its first non-cancelled
    result merges (first result wins — later duplicates are dropped
    before ``on_result``); a row not in ``done`` is owned by >= 0 ranks
    (``rank_rows``) plus possibly ``pending``/``reserved``; the round
    completes exactly when ``pool_ids <= done``. Dual ownership is the
    STEAL state and is safe by the first-result-wins rule."""

    pool_ids: Set[int]
    done: Set[int]
    world: int
    steal_after: float
    join_deadline: float
    requeue_limit: int
    round_start: float
    pending: Set[int] = field(default_factory=set)
    reserved: Dict[int, Set[int]] = field(default_factory=dict)
    rank_rows: Dict[int, Set[int]] = field(default_factory=dict)
    elastic_ranks: Set[int] = field(default_factory=set)
    joined_late: Set[int] = field(default_factory=set)
    lost: Dict[int, str] = field(default_factory=dict)
    drained: Set[int] = field(default_factory=set)
    idle: Dict[int, socket.socket] = field(default_factory=dict)
    requeue_count: Dict[int, int] = field(default_factory=dict)
    last_result: Dict[int, float] = field(default_factory=dict)
    next_rank: int = 0
    fatal: Optional[str] = None
    requeued_total: int = 0
    stolen_total: int = 0
    dup_dropped: int = 0

    @classmethod
    def build(
        cls,
        requests: List,
        done_rows: Set[int],
        local_shard: List,
        world: DPWorld,
        *,
        steal_after: float,
        join_grace: float,
        requeue_limit: int,
        now: float,
    ) -> "_ElasticState":
        pool_ids = {_row_id(q) for q in requests}
        done = set(done_rows or ()) & pool_ids
        est = cls(
            pool_ids=pool_ids,
            done=done,
            world=world.world,
            steal_after=steal_after,
            join_deadline=now + join_grace,
            requeue_limit=requeue_limit,
            round_start=now,
            next_rank=world.world,
        )
        local = {_row_id(q) for q in local_shard} - done
        est.rank_rows[0] = set(local)
        owned = done | local
        for r in range(1, world.world):
            est.reserved[r] = {
                rid
                for rid in pool_ids
                if rid % world.world == r and rid not in owned
            }
            owned |= est.reserved[r]
        # rows outside every stride and the local shard (callers hand
        # the coordinator its exact strided shard, so normally empty)
        est.pending = pool_ids - owned
        return est

    def all_done(self) -> bool:
        return self.pool_ids <= self.done

    def remaining(self, rank: int) -> Set[int]:
        return self.rank_rows.get(rank, set()) - self.done

    def admit(
        self, rank: int, elastic_hello: bool
    ) -> Tuple[int, Set[int], List[Dict]]:
        """Admit a hello: returns (assigned rank, row assignment,
        events). A fixed-world rank reclaims its reservation (or its
        prior assignment on reconnect); an elastic rank outside
        [1, world) is a late joiner and gets a fresh rank with an empty
        assignment — the dispatch planner feeds it via ``reshard``."""
        evts: List[Dict] = []
        late = not (1 <= rank < self.world)
        if late:
            rank = self.next_rank
            self.next_rank += 1
            self.joined_late.add(rank)
        if elastic_hello:
            self.elastic_ranks.add(rank)
        self.lost.pop(rank, None)
        prior = self.rank_rows.get(rank)
        if prior is not None:
            rows = prior - self.done
        else:
            rows = {
                rid
                for rid in self.reserved.pop(rank, set())
                if rid not in self.done
            }
        self.rank_rows[rank] = set(rows)
        evts.append(
            {
                "event": "dp_worker_joined",
                "rank": rank,
                "elastic": bool(elastic_hello),
                "late_join": late,
                "rows_assigned": len(rows),
            }
        )
        return rank, rows, evts

    def on_res(self, rank: int, rid: int, cancelled: bool) -> bool:
        """First-result-wins merge gate: False means drop (a duplicate
        of an already-done row — the losing side of a steal or requeue
        race). Cancelled rows merge (the partial store's later-wins
        read handles cancelled-then-real sequences) but never mark the
        row done, so they regenerate on requeue/resume."""
        if rid in self.done:
            self.dup_dropped += 1
            return False
        if not cancelled:
            self.done.add(rid)
            self.pending.discard(rid)
            for rows in self.rank_rows.values():
                rows.discard(rid)
        return True

    def _requeue(
        self, rank: int, rows: Set[int], reason: str, *, count: bool
    ) -> List[Dict]:
        rows = rows - self.done
        if not rows:
            return []
        if count:
            over = []
            for rid in rows:
                n = self.requeue_count.get(rid, 0) + 1
                self.requeue_count[rid] = n
                if n > self.requeue_limit:
                    over.append(rid)
            if over and self.fatal is None:
                self.fatal = (
                    f"row(s) {sorted(over)[:8]} requeued more than "
                    f"{self.requeue_limit} times (last reason: {reason})"
                )
        self.pending |= rows
        self.requeued_total += len(rows)
        return [
            {
                "event": "dp_rows_requeued",
                "rank": rank,
                "reason": reason,
                "rows": len(rows),
                "row_ids": sorted(rows)[:32],
            }
        ]

    def release(self, rank: int, reason: str) -> List[Dict]:
        """A rank left ungracefully (EOF, err, stall, torn frame):
        requeue everything it still owed. Idempotent per rank."""
        rows = self.rank_rows.pop(rank, set())
        self.idle.pop(rank, None)
        self.lost[rank] = reason
        return self._requeue(rank, rows, reason, count=True)

    def drain(self, rank: int, unfinished) -> List[Dict]:
        """Graceful preemption drain: the worker's own unfinished list
        plus whatever the coordinator still had booked for it goes back
        to pending. Not counted against the requeue limit — the rows
        did nothing wrong, the host got preempted."""
        rows = self.rank_rows.pop(rank, set())
        rows |= {int(r) for r in (unfinished or ()) if int(r) in self.pool_ids}
        self.idle.pop(rank, None)
        self.drained.add(rank)
        evts = self._requeue(
            rank, rows, "preempt_drain", count=False
        )
        evts.append(
            {
                "event": "dp_preempt_drain",
                "rank": rank,
                "rows": len(rows - self.done),
            }
        )
        return evts

    def release_absent(self, now: float) -> List[Dict]:
        """Past the join grace, reserved strides of ranks that never
        connected stop waiting and become requeueable work."""
        if now < self.join_deadline or not self.reserved:
            return []
        evts: List[Dict] = []
        for r in sorted(self.reserved):
            rows = self.reserved.pop(r)
            self.lost[r] = "never connected within join grace"
            evts += self._requeue(
                r, rows, "never_connected_within_join_grace",
                count=False,
            )
        return evts

    def dispatch(
        self, now: float, *, force_steal: bool = False
    ) -> Tuple[List[Tuple[int, socket.socket, Set[int]]], List[Dict]]:
        """Plan reshard sends: requeued rows split across parked idle
        ranks first; with nothing pending, an idle rank may steal the
        tail half of the slowest straggler's remaining rows (silent for
        ``steal_after`` seconds, or forced by the ``dphost.steal``
        fault site). Returns (plans, events); the caller performs the
        sends outside the lock."""
        plans: List[Tuple[int, socket.socket, Set[int]]] = []
        evts: List[Dict] = []
        if self.fatal is not None:
            return plans, evts
        while self.pending and self.idle:
            rank, conn = self.idle.popitem()
            share = max(
                1, len(self.pending) // (len(self.idle) + 1)
            )
            take = set(sorted(self.pending)[:share])
            self.pending -= take
            self.rank_rows[rank] = (
                self.rank_rows.get(rank, set()) | take
            )
            plans.append((rank, conn, take))
            evts.append(
                {
                    "event": "dp_rows_resharded",
                    "rank": rank,
                    "rows": len(take),
                    "row_ids": sorted(take)[:32],
                }
            )
        if self.pending or not self.idle:
            return plans, evts
        if self.steal_after <= 0 and not force_steal:
            return plans, evts
        victims = []
        for r in self.rank_rows:
            if r == 0 or r in self.idle:
                continue
            rem = self.remaining(r)
            if len(rem) < 2:
                continue
            silent = now - self.last_result.get(r, self.round_start)
            if force_steal or silent >= self.steal_after:
                victims.append((len(rem), r, rem))
        if not victims:
            return plans, evts
        victims.sort(reverse=True)
        _, victim, rem = victims[0]
        tail = sorted(rem)[len(rem) // 2:]
        thief, conn = self.idle.popitem()
        self.rank_rows[thief] = (
            self.rank_rows.get(thief, set()) | set(tail)
        )
        # the victim KEEPS the stolen rows: whichever rank streams a
        # row first wins the merge, the other copy is dropped by id
        self.stolen_total += len(tail)
        plans.append((thief, conn, set(tail)))
        evts.append(
            {
                "event": "dp_rows_stolen",
                "victim": victim,
                "thief": thief,
                "rows": len(tail),
                "row_ids": sorted(tail)[:32],
            }
        )
        return plans, evts

    def claim_local(self) -> Set[int]:
        """Hand every pending row to rank 0 (the coordinator picks up
        orphaned work itself when no idle rank is parked — the zero-
        lost-rows backstop even if every worker dies)."""
        take = set(self.pending)
        if take:
            self.pending.clear()
            self.rank_rows[0] = self.rank_rows.get(0, set()) | take
        return take

    def snapshot(
        self, job_id: str, rank_status: Dict[int, str]
    ) -> Dict:
        ranks: Dict[str, Dict] = {}
        live = 0
        seen = (
            set(self.rank_rows)
            | set(self.reserved)
            | set(self.lost)
            | set(self.drained)
        )
        for r in sorted(seen):
            if r in self.drained:
                state = "drained"
            elif r in self.lost:
                state = "lost"
            elif r in self.reserved:
                state = "expected"
            elif r in self.idle:
                state = "idle"
            elif rank_status.get(r) == "completed":
                state = "done"
            elif r in rank_status:
                state = "lost"
            else:
                state = "running"
            if state in ("running", "idle"):
                live += 1
            ranks[str(r)] = {
                "state": state,
                "elastic": r in self.elastic_ranks or r == 0,
                "late_join": r in self.joined_late,
                "rows_remaining": len(self.remaining(r))
                if r in self.rank_rows
                else len(self.reserved.get(r, ())),
            }
            if r in self.lost:
                ranks[str(r)]["reason"] = self.lost[r]
        done = len(self.done)
        return {
            "job_id": job_id,
            "elastic": True,
            "world": self.world,
            "live_ranks": live,
            "rows": {
                "total": len(self.pool_ids),
                "done": done,
                "pending": len(self.pending),
                "inflight": len(self.pool_ids) - done
                - len(self.pending),
            },
            "counters": {
                "requeued_rows": self.requeued_total,
                "stolen_rows": self.stolen_total,
                "duplicate_results_dropped": self.dup_dropped,
            },
            "ranks": ranks,
        }


_EVENT_KINDS = {
    "dp_worker_joined": "join",
    "dp_rows_requeued": "requeue",
    "dp_rows_resharded": "reshard",
    "dp_rows_stolen": "steal",
    "dp_preempt_drain": "drain",
}


def run_dp_coordinator(
    world: DPWorld,
    run_shard: Callable[..., str],
    shard: List[GenRequest],
    *,
    on_result: Callable[[GenResult], None],
    on_progress: Optional[Callable[[Dict], None]] = None,
    job_key: str = "",
    should_cancel: Optional[Callable[[], bool]] = None,
    done_rows: Optional[set] = None,
    on_row_event: Optional[Callable[[Dict], None]] = None,
    tele_ctx: Optional[Dict] = None,
    on_worker_tele: Optional[Callable[[int, Dict], None]] = None,
    requests: Optional[List] = None,
    job_id: str = "",
) -> str:
    """Rank-0 execution: collect the local shard AND every worker's
    stream through the same ``on_result`` (the jobstore's row_id-keyed
    merge makes reassembly order-preserving), aggregating progress
    across ranks.

    Fixed-world mode (``requests=None`` — the pre-elastic contract):
    raises if any worker reports an error or drops its connection
    before ``done`` — partial rows stay in the partial store for a
    row-granular resume, exactly like a single-host failure.

    Elastic mode (``requests`` = the FULL not-yet-done request pool):
    the round self-heals instead. Worker death, a torn frame, a stall,
    or a preemption drain requeues that rank's pending rows; parked
    idle ranks (and late joiners) absorb requeued rows via ``reshard``
    frames; with nothing pending an idle rank steals the tail half of
    the slowest straggler's remaining rows (first result wins —
    duplicate rows are dropped by id before the merge, so the round's
    output is bit-identical to a fault-free run); rank 0 itself claims
    orphaned rows when no idle rank is parked, so the round completes
    with zero lost rows even if every worker dies. The round only
    fails resumably when a single row exceeds SUTRO_DP_REQUEUE_LIMIT
    requeues (a row that kills every host it lands on). Old-protocol
    workers participate as fixed-stride members; their failures are
    healed the same way.

    Liveness: a stall watchdog covers the WHOLE round — a connected
    rank silent past SUTRO_DP_STALL_TIMEOUT (heartbeats count as
    signal) is declared stalled; fixed-world rounds then fail
    resumably in bounded time, elastic rounds requeue and continue.

    ``on_row_event`` receives row retry/quarantine events from every
    rank (workers forward theirs as ``fault`` messages) AND the elastic
    membership events (``dp_worker_joined`` / ``dp_rows_requeued`` /
    ``dp_rows_resharded`` / ``dp_rows_stolen`` / ``dp_preempt_drain``)
    — the coordinator's record is the authoritative failure_log.

    Connections greeting with a different ``job_key`` (a rank whose
    queue diverged) are rejected and do not count toward the expected
    worker set.

    ``tele_ctx`` (optional trace context, telemetry/distributed.py) is
    stamped into every resume reply; ``on_worker_tele(rank, shard)``
    receives the telemetry shard a worker piggybacks on its terminal
    done/err/drain frame. Both default to None — the pre-telemetry
    wire."""
    import time as _tmod

    accept_stop = threading.Event()
    n_workers = world.world - 1
    conns: List[socket.socket] = []
    # guards conns against the round's teardown: a rank admitted while
    # the round ends must be closed, not registered after the close
    conns_lock = threading.Lock()
    serve_threads: List[threading.Thread] = []
    res_lock = threading.Lock()  # on_result mutates job state
    emit_lock = threading.Lock()  # serialize on_progress callbacks
    # per-rank progress snapshots, summed into one stream
    prog: Dict[int, Dict] = {}
    prog_lock = threading.Lock()
    local_done = {"flag": False}
    cancel_sent = {"flag": False}  # before acceptor: serve() reads it

    # Per-RANK connection state (not per-connection): a worker that
    # retries after a handshake stall reconnects with the same rank, and
    # the retry must REPLACE its abandoned first connection instead of
    # consuming a second worker slot (and instead of that first
    # connection's EOF failing an otherwise-successful job). ``gen``
    # stamps each accepted connection; a serve thread whose stamp is no
    # longer current exits without recording anything.
    state_cv = threading.Condition()
    rank_status: Dict[int, str] = {}  # rank -> "completed" | error text
    rank_conn: Dict[int, socket.socket] = {}
    rank_gen: Dict[int, int] = {}
    last_msg: Dict[int, float] = {}  # rank -> monotonic of last message

    est: Optional[_ElasticState] = None
    if requests is not None:
        est = _ElasticState.build(
            requests,
            set(done_rows or ()),
            shard,
            world,
            steal_after=float(
                os.environ.get("SUTRO_DP_STEAL_AFTER", "180")
            ),
            join_grace=float(
                os.environ.get(
                    "SUTRO_DP_JOIN_GRACE", str(_ACCEPT_TIMEOUT_S)
                )
            ),
            requeue_limit=int(
                os.environ.get("SUTRO_DP_REQUEUE_LIMIT", "3")
            ),
            now=_tmod.monotonic(),
        )

    def _round_event(ev: Dict) -> None:
        """Fan one membership event out to the registry + the
        failure_log sink. Callers invoke OUTSIDE state_cv."""
        kind = _EVENT_KINDS.get(ev.get("event", ""))
        if kind is not None:
            _dp_event(kind)
        if telemetry.ENABLED:
            if ev.get("event") == "dp_rows_requeued":
                telemetry.DP_REQUEUED_ROWS_TOTAL.inc(
                    float(ev.get("rows", 0))
                )
            elif ev.get("event") == "dp_rows_stolen":
                telemetry.DP_STOLEN_ROWS_TOTAL.inc(
                    float(ev.get("rows", 0))
                )
        if on_row_event is not None:
            try:
                on_row_event(ev)
            except Exception:
                logger.warning(
                    "on_row_event sink failed", exc_info=True
                )

    def _publish_fleet() -> None:
        if est is None or not job_id:
            return
        with state_cv:
            snap = est.snapshot(job_id, rank_status)
        _fleet_publish(job_id, snap)

    def _take_tele(rank: int, m: Dict) -> None:
        # piggybacked telemetry shard on a terminal frame: hand it to
        # the ingestion sink, never let it affect the round's outcome
        shard_doc = m.get("tele")
        if on_worker_tele is None or not isinstance(shard_doc, dict):
            return
        try:
            on_worker_tele(rank, shard_doc)
        except Exception:
            logger.warning(
                "worker telemetry ingest failed (rank %d)", rank,
                exc_info=True,
            )

    def serve(conn: socket.socket, lines, rank: int, gen: int) -> None:
        import time as _time

        ok = False
        err: Optional[str] = None
        try:
            for m in lines:
                last_msg[rank] = _time.monotonic()
                t = m.get("t")
                if t == "res" or t == "emb":
                    if t == "res":
                        res = _msg_res(m)
                        was_cancelled = res.finish_reason == "cancelled"
                    else:
                        res = EmbResult(
                            row_id=int(m["row_id"]),
                            vector=[float(x) for x in m["vec"]],
                        )
                        was_cancelled = False
                    merge = True
                    if est is not None:
                        with state_cv:
                            est.last_result[rank] = _time.monotonic()
                            merge = est.on_res(
                                rank, res.row_id, was_cancelled
                            )
                            state_cv.notify_all()
                    if not merge:
                        # the losing copy of a stolen/requeued row:
                        # first result won, this one is dropped by id
                        _dp_event("dup_result")
                        continue
                    # res_lock exists to serialize on_result (it mutates
                    # job state across per-worker serve threads) — the
                    # callback IS the critical section
                    with res_lock:
                        on_result(res)  # graftlint: disable=lock-callback
                elif t == "prog":
                    with prog_lock:
                        prog[m["rank"]] = m
                    _emit_progress()
                elif t == "fault":
                    # a worker rank's row retry/quarantine: record it on
                    # the authoritative (coordinator) failure_log
                    _dp_event("fault_forwarded")
                    if on_row_event is not None:
                        try:
                            on_row_event(m.get("ev") or {})
                        except Exception:
                            logger.warning(
                                "on_row_event sink failed",
                                exc_info=True,
                            )
                elif t == "idle":
                    # elastic worker finished its assignment: park it
                    # for requeued/stolen rows (fixed-world peers never
                    # send this)
                    if est is not None:
                        with state_cv:
                            if rank_gen.get(rank) == gen:
                                est.idle[rank] = conn
                            state_cv.notify_all()
                elif t == "drain":
                    _take_tele(rank, m)
                    if est is not None:
                        evts: List[Dict] = []
                        with state_cv:
                            if rank_gen.get(rank) == gen:
                                evts = est.drain(
                                    rank, m.get("rows") or ()
                                )
                            state_cv.notify_all()
                        for ev in evts:
                            _round_event(ev)
                        ok = True  # graceful departure, not an error
                    else:
                        err = (
                            f"worker rank={rank} drained (elastic "
                            "frame on a fixed-world round)"
                        )
                    break
                elif t == "done":
                    _take_tele(rank, m)
                    # a worker shard that did not COMPLETE (e.g.
                    # cancelled after the coordinator's own shard
                    # finished clean) must not let the job finalize as
                    # a clean success with silently-missing rows
                    if m.get("outcome") == "completed":
                        ok = True
                    else:
                        err = (
                            f"worker rank={rank} outcome "
                            f"{m.get('outcome')!r}"
                        )
                    break
                elif t == "err":
                    _take_tele(rank, m)
                    err = str(m["msg"])
                    break
        except OSError as e:
            err = f"worker connection lost: {e}"
        finally:
            release_evts: List[Dict] = []
            superseded = False
            with state_cv:
                if rank_gen.get(rank) != gen:
                    superseded = True  # a retry owns this rank now
                else:
                    if not ok and err is None:
                        err = (
                            f"worker rank={rank} disconnected "
                            "before done"
                        )
                    rank_status[rank] = "completed" if ok else err
                    if est is not None and not ok:
                        # self-heal: the dead rank's rows become
                        # pending work instead of a round failure
                        release_evts = est.release(rank, err)
                    state_cv.notify_all()
            if superseded:
                return
            for ev in release_evts:
                _round_event(ev)
            # a finished rank's token counts stay (cumulative) but its
            # last RATE snapshot must not keep inflating the pod sum
            # while stragglers run
            with prog_lock:
                if rank in prog:
                    prog[rank] = {**prog[rank], "tps": 0.0}
            _emit_progress()

    def _emit_progress() -> None:
        if on_progress is None:
            return
        with prog_lock:
            snaps = list(prog.values())
        merged = {
            "input_tokens": sum(s.get("input_tokens", 0) for s in snaps),
            "output_tokens": sum(
                s.get("output_tokens", 0) for s in snaps
            ),
            "rows_completed": sum(
                s.get("rows_completed", 0) for s in snaps
            ),
            # pod throughput = sum of slice throughputs (each slice
            # decodes independently)
            "total_tokens_processed_per_second": sum(
                s.get("tps", 0.0) for s in snaps
            ),
        }
        # emit_lock serializes the merged-progress callback across serve
        # threads (consumers expect monotonic snapshots, not interleaved
        # partial merges) — the callback IS the critical section
        with emit_lock:
            on_progress(merged)  # graftlint: disable=lock-callback

    # bound immediately before its consumers (the acceptor thread and
    # the closing ``finally``) so no setup statement can raise between
    # the bind and the paths that guarantee the port is released
    listener = socket.create_server(
        (world.host, world.port), reuse_port=False
    )
    try:
        listener.settimeout(_ACCEPT_TIMEOUT_S)
    except OSError:
        listener.close()  # never strand the bound port
        raise

    def accept_all() -> None:
        # synchronous handshake per connection: only hellos carrying
        # THIS job's key count toward the expected worker set; a rank
        # whose queue diverged onto another job is rejected and will
        # retry against the listener this coordinator binds for that
        # job later (or its own coordinator's). The loop keeps accepting
        # past n_workers so a retrying rank can replace its abandoned
        # first connection — and, on elastic rounds, so late joiners
        # can be admitted at any point; it ends when the listener times
        # out or the job's finally closes it.
        try:
            while True:
                conn, _ = listener.accept()
                if accept_stop.is_set():
                    # the job's finally is tearing down: this conn is
                    # its wake self-connect (or a worker arriving after
                    # the round ended — either way, the round is over)
                    conn.close()
                    return
                try:
                    conn.settimeout(30.0)
                    lines = _recv_lines(conn)
                    first = next(lines, None)
                    rank = int(first.get("rank", -1)) if first else -1
                    elastic_hello = bool(
                        first.get("elastic")
                    ) if first else False
                    fixed_rank_ok = 1 <= rank < world.world
                    if (
                        not first
                        or first.get("t") != "hello"
                        or first.get("job", "") != job_key
                        # only elastic rounds admit out-of-range ranks
                        # (late joiners); fixed-world keeps the strict
                        # membership check
                        or (
                            not fixed_rank_ok
                            and not (est is not None and elastic_hello)
                        )
                    ):
                        _dp_event("reject")
                        try:
                            _send(conn, {"t": "reject"})
                        except OSError:
                            pass
                        conn.close()
                        continue
                except OSError:
                    conn.close()
                    continue
                assign: Set[int] = set()
                admit_evts: List[Dict] = []
                if est is not None:
                    with state_cv:
                        rank, assign, admit_evts = est.admit(
                            rank, elastic_hello
                        )
                for ev in admit_evts:
                    _round_event(ev)
                try:
                    conn.settimeout(None)
                    resume_msg: Dict = {
                        "t": "resume",
                        "rows": sorted(done_rows or ()),
                    }
                    if est is not None and elastic_hello:
                        resume_msg["elastic"] = 1
                        resume_msg["rank"] = rank
                        resume_msg["assign"] = sorted(assign)
                    if tele_ctx is not None:
                        resume_msg["tele"] = tele_ctx
                    _send(conn, resume_msg)
                    if cancel_sent["flag"]:
                        # cancelled before this worker connected — it
                        # would otherwise run its whole shard
                        _send(conn, {"t": "cancel"})
                except OSError:
                    conn.close()
                    if est is not None:
                        rel: List[Dict] = []
                        with state_cv:
                            rel = est.release(
                                rank, "handshake send failed"
                            )
                        for ev in rel:
                            _round_event(ev)
                    continue
                import time as _time

                with state_cv:
                    prev = rank_conn.get(rank)
                    gen = rank_gen.get(rank, 0) + 1
                    rank_gen[rank] = gen
                    rank_conn[rank] = conn
                    # a retry re-opens the rank's slot (its abandoned
                    # connection may already have recorded an EOF error)
                    rank_status.pop(rank, None)
                    # the stall clock starts at ACCEPT, not at the local
                    # shard's finish — a worker that handshakes late
                    # (slow compile, retry) must get the full stall
                    # window before its first message
                    last_msg[rank] = _time.monotonic()
                    state_cv.notify_all()
                if prev is not None:
                    _dp_event("reconnect")
                    # _hard_close: the superseded connection's serve
                    # thread is blocked in recv — shutdown so it exits
                    # now instead of at the round's join timeout
                    try:
                        _hard_close(prev)
                    except OSError:
                        pass
                with conns_lock:
                    if accept_stop.is_set():
                        # the round ended during this rank's handshake
                        # (a late joiner admitted as the last rows
                        # merged): EOF it now — registered after the
                        # teardown's close, its connection would stay
                        # open and the rank park idle forever
                        _hard_close(conn)
                        return
                    conns.append(conn)
                st = threading.Thread(
                    target=serve,
                    args=(conn, lines, rank, gen),
                    daemon=True,
                )
                st.start()
                serve_threads.append(st)
        except OSError as e:
            # listener timed out (a rank never connected) or was closed
            # by the job's finally. Mark ranks that never connected so
            # the waiter can finish.
            with state_cv:
                for r in range(1, world.world):
                    if r not in rank_conn and r not in rank_status:
                        rank_status[r] = (
                            f"worker rank={r} never connected: {e}"
                        )
                state_cv.notify_all()

    acceptor = threading.Thread(target=accept_all, daemon=True)
    acceptor.start()

    # -- liveness watchdog (whole round) -------------------------------
    # The old stall check only ran AFTER the local shard finished, so a
    # hung rank could wedge the coordinator for as long as rank 0 kept
    # decoding. The watchdog enforces the stall bound from accept
    # onward; worker heartbeats (SUTRO_DP_HEARTBEAT) keep live-but-slow
    # ranks fresh.
    stall_s = _stall_timeout_s()
    watchdog_stop = threading.Event()

    def _mark_stalled(r: int) -> None:
        _dp_event("stall")
        evts: List[Dict] = []
        with state_cv:
            if r in rank_status:
                return  # terminal beat the timeout
            rank_gen[r] = rank_gen.get(r, 0) + 1
            rank_status[r] = (
                f"worker rank={r} stalled (no message for "
                f"{stall_s:.0f}s)"
            )
            if est is not None:
                evts = est.release(r, "stall")
            state_cv.notify_all()
        for ev in evts:
            _round_event(ev)
        conn = rank_conn.get(r)
        if conn is not None:
            # _hard_close, not close(): the rank's serve thread is
            # blocked in recv on this fd — without a shutdown it never
            # sees EOF and the round's finally waits out its join
            # timeout
            try:
                _hard_close(conn)
            except OSError:
                logger.warning(
                    "closing stalled rank %d connection failed", r
                )

    def stall_watchdog() -> None:
        import time as _time

        period = min(max(stall_s / 4.0, 0.25), 5.0)
        while not watchdog_stop.wait(period):
            now = _time.monotonic()
            with state_cv:
                watched = (
                    list(rank_conn)
                    if est is not None
                    else range(1, world.world)
                )
                stalled = [
                    r
                    for r in watched
                    if r in rank_conn
                    and r not in rank_status
                    and now - last_msg.get(r, now) > stall_s
                ]
            for r in stalled:
                _mark_stalled(r)

    if stall_s > 0:
        threading.Thread(
            target=stall_watchdog, daemon=True, name="sutro-dp-stall"
        ).start()

    def fleet_ticker() -> None:
        # the membership view stays live while rank 0 runs its own
        # shard: the wait loop below refreshes it only once that shard
        # is done, and a watcher (``job_fleet``) would otherwise read
        # the round's opening snapshot until then
        while not watchdog_stop.wait(1.0):
            _publish_fleet()

    if est is not None and job_id:
        threading.Thread(
            target=fleet_ticker, daemon=True, name="sutro-dp-fleet"
        ).start()

    def local_progress(p: Dict) -> None:
        with prog_lock:
            prog[0] = {
                "rank": 0,
                "input_tokens": p.get("input_tokens", 0),
                "output_tokens": p.get("output_tokens", 0),
                "rows_completed": p.get("rows_completed", 0),
                "tps": p.get(
                    "total_tokens_processed_per_second", 0.0
                ),
            }
        _emit_progress()

    def locked_result(res: GenResult) -> None:
        # same serialization point as serve(): see res_lock note there —
        # plus, on elastic rounds, the same first-result-wins gate the
        # worker streams pass through (rank 0 re-running a requeued row
        # may race the original owner's late result)
        if est is not None:
            was_cancelled = (
                getattr(res, "finish_reason", None) == "cancelled"
            )
            with state_cv:
                merge = est.on_res(0, res.row_id, was_cancelled)
                state_cv.notify_all()
            if not merge:
                _dp_event("dup_result")
                return
        with res_lock:
            on_result(res)  # graftlint: disable=lock-callback

    def cancel_check() -> bool:
        if should_cancel and should_cancel():
            # broadcast once so workers stop burning chips on a dead job
            if not cancel_sent["flag"]:
                cancel_sent["flag"] = True
                for c in conns:
                    try:
                        _send(c, {"t": "cancel"})
                    except OSError:
                        pass
            return True
        return False

    try:
        kw: Dict = {}
        if on_row_event is not None and _accepts_kwarg(
            run_shard, "on_row_event"
        ):
            kw["on_row_event"] = on_row_event
        _publish_fleet()
        outcome = run_shard(
            shard,
            on_result=locked_result,
            on_progress=local_progress,
            should_cancel=cancel_check,
            **kw,
        )
        local_done["flag"] = True
        with prog_lock:  # same staleness rule for the local shard
            if 0 in prog:
                prog[0] = {**prog[0], "tps": 0.0}
        _emit_progress()
        # keep honoring cancellation while waiting on worker shards —
        # the local shard may finish long before the slowest slice. A
        # cancelled job waits a short grace for workers to drain, then
        # stops waiting entirely: a hung or never-connecting worker
        # must not wedge cancellation (closing conns in the finally
        # unblocks their serve threads; stragglers see EOF and cancel
        # locally). Hung-but-live connections are the stall watchdog's
        # job — it has been enforcing the silence bound since accept.
        import time

        cancel_deadline = None
        if est is None:
            # -- fixed-world wait: every expected rank reports --------
            while True:
                with state_cv:
                    if len(rank_status) >= n_workers:
                        break
                    state_cv.wait(timeout=0.25)
                if cancel_check():
                    if outcome == "completed":
                        outcome = "cancelled"
                    if cancel_deadline is None:
                        cancel_deadline = time.monotonic() + 30.0
                    elif time.monotonic() >= cancel_deadline:
                        break
            with state_cv:
                errs = [
                    s for s in rank_status.values() if s != "completed"
                ]
            if errs and outcome == "completed":
                raise RuntimeError(
                    "dp job failed on a worker slice: " + "; ".join(errs)
                )
            return outcome
        # -- elastic wait: every ROW merged, membership be damned -----
        fleet_tick = 0.0
        while True:
            now = time.monotonic()
            pre_evts: List[Dict] = []
            with state_cv:
                pre_evts = est.release_absent(now)
                fatal = est.fatal
                done_all = est.all_done()
                steal_possible = (
                    not est.pending
                    and bool(est.idle)
                    and not done_all
                )
            for ev in pre_evts:
                _round_event(ev)
            if fatal is not None:
                raise RuntimeError(
                    "dp round exceeded the requeue limit: " + fatal
                )
            if done_all:
                break
            force_steal = False
            if steal_possible and faults.ACTIVE is not None:
                # test seam: the steal-race site forces a steal without
                # waiting out the silence threshold
                force_steal = faults.fire("dphost.steal") is not None
            with state_cv:
                plans, evts = est.dispatch(
                    now, force_steal=force_steal
                )
                local = est.claim_local() if not plans else set()
            for ev in evts:
                _round_event(ev)
            dead_ranks: List[int] = []
            for rk, rconn, rows in plans:
                try:
                    _send(rconn, {"t": "reshard", "rows": sorted(rows)})
                except OSError:
                    dead_ranks.append(rk)
            for rk in dead_ranks:
                rel_evts: List[Dict] = []
                with state_cv:
                    rel_evts = est.release(rk, "reshard send failed")
                for ev in rel_evts:
                    _round_event(ev)
            if now - fleet_tick >= 1.0:
                fleet_tick = now
                _publish_fleet()
            if local:
                # orphaned rows with no idle rank parked: rank 0 runs
                # them itself — the zero-lost-rows backstop
                sub = [
                    q for q in requests if _row_id(q) in local
                ]
                out2 = run_shard(
                    sub,
                    on_result=locked_result,
                    on_progress=local_progress,
                    should_cancel=cancel_check,
                    **kw,
                )
                if out2 != "completed" and outcome == "completed":
                    outcome = out2
                continue
            if cancel_check():
                if outcome == "completed":
                    outcome = "cancelled"
                if cancel_deadline is None:
                    cancel_deadline = time.monotonic() + 30.0
                elif time.monotonic() >= cancel_deadline:
                    break
            with state_cv:
                state_cv.wait(timeout=0.25)
        # every row is merged (or the job was cancelled): release
        # parked ranks and give live ones a short grace to send their
        # terminal frame (that's where telemetry shards ride)
        fin_deadline = time.monotonic() + 5.0
        while True:
            with state_cv:
                parked = list(est.idle.items())
                est.idle.clear()
                live = [
                    r
                    for r in rank_conn
                    if r not in rank_status
                    and r not in est.lost
                    and r not in est.drained
                ]
            for _rk, rconn in parked:
                try:
                    _send(rconn, {"t": "nomore"})
                except OSError:
                    pass
            if not live and not parked:
                break
            if time.monotonic() >= fin_deadline:
                break
            with state_cv:
                state_cv.wait(timeout=0.2)
        _publish_fleet()
        return outcome
    finally:
        watchdog_stop.set()
        # _hard_close, not close(): a serve thread blocked in recv on
        # the SAME process's fd keeps the kernel file alive through a
        # plain close, so it would never see EOF and the bounded joins
        # below would all run out their timeout. The stop flag goes up
        # under the same lock, so the acceptor either registered a
        # connection before this close or sees the flag and closes it
        with conns_lock:
            accept_stop.set()
            for c in conns:
                _hard_close(c)
        # Wake the acceptor BEFORE closing the listener. A thread
        # blocked in ``listener.accept()`` holds a kernel reference to
        # the listening socket for the duration of its poll, so close()
        # alone leaves the PORT bound until the poll wakes (up to
        # _ACCEPT_TIMEOUT_S) — and this process's NEXT dp round then
        # fails its create_server with EADDRINUSE (observed as a
        # test_dphost flake: generation round, then embed round on the
        # same port). Worse, a connect AFTER the close is NOT seen by
        # the blocked accept on every kernel (the wake lands in the
        # orphaned socket's backlog and the poll never returns), so the
        # order is: raise the stop flag, self-connect while the
        # listener is still open (the acceptor accepts the wake, sees
        # the flag, and exits), join it, then close. If the acceptor
        # already exited (listener timeout), the connect is refused and
        # ignored. (The stop flag went up with the conns' close above.)
        try:
            _hard_close(
                socket.create_connection(
                    (world.host, world.port), timeout=1.0
                )
            )
        except OSError:
            logger.debug("acceptor wake connect failed", exc_info=True)
        # closing the conns EOFs the serve threads; a bounded join keeps
        # them from mutating rank_status/prog after this function
        # returns (they are daemon, so a hung one cannot wedge exit)
        for st in serve_threads:
            st.join(timeout=5.0)
        acceptor.join(timeout=5.0)
        listener.close()
