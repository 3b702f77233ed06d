"""InteractiveGateway: admission + lifecycle for the online tier.

The port of ``sutro_tpu/serving/gateway.py``.

The batch tier's unit of work is a JOB (durable record, jobstore
results, resumable). The interactive tier's unit is a REQUEST: one
prompt, one in-memory :class:`~.channel.StreamChannel`, no jobstore
row. Both meet in the scheduler — an interactive request is a 1-row
``JobCtx`` at priority ``-1`` (strictly ahead of every batch priority,
which is non-negative), so ``(priority, seq)`` admission pulls it into
the live continuous-batch window ahead of waiting batch rows, and the
``interactive_slots`` budget lets it preempt a running batch row via
the pause/resume primitive when the batch is full
(scheduler._evict_for_interactive).

Lifecycle::

    submit(sreq)          HTTP/SDK thread: resolve model, tokenize,
                          build GenRequest+JobCtx, park on the per-model
                          pending deque, kick the engine worker
    take_pending(key)     scheduler session (engine worker thread)
                          adopts the ctx into its live window
    on_token -> channel   every accepted token (single commit point)
    finish(ctx, outcome)  terminal: close the channel, observe TTFT/ITL,
                          count the outcome, notify drain waiters

The gateway is constructed only when ``EngineConfig.interactive_slots``
> 0 — at 0 the serving endpoints 404 and none of this code runs, so the
batch path stays bit-identical to an engine built before this tier.
"""

from __future__ import annotations

import codecs
import dataclasses
import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Deque, List, Optional

import numpy as np

from .. import telemetry
from ..engine import faults
from ..engine.scheduler import GenRequest, JobCtx
from .channel import StreamChannel
from .openai import ServingRequest

logger = logging.getLogger(__name__)

#: a request whose first token took longer than this (or that ended
#: tokenless) counts as starved — doctor verdict ``interactive_starved``
STARVED_TTFT_S = 5.0

#: sticky chat sessions kept server-side (token transcripts only — a
#: few KB each); the oldest is dropped past the cap, and a dropped
#: session's next turn simply re-renders as a fresh conversation
SESSION_CAP = 512

#: a session untouched this long has its KV pages demoted host-ward on
#: the next sweep (submit-time opportunistic; tests call it directly)
SESSION_IDLE_CHECKPOINT_S = 30.0


@dataclasses.dataclass
class _ChatSession:
    """Server-side transcript of one sticky conversation: the exact
    token ids the engine has KV for (prompt render + every emitted
    token, stop ids stripped). The next turn appends a continuation
    render, so the stored ids stay a strict token-level prefix of the
    next prompt — which is what lets the prefix store / KV tiers serve
    the whole history from cache."""

    ids: List[int]
    last_used: float
    turns: int = 0
    # demote already requested since last use (dedup for the sweep)
    checkpointed: bool = False


class GatewayRejected(Exception):
    """Admission refused: carries the HTTP status the server maps it to."""

    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


@dataclasses.dataclass
class InteractiveRequest:
    id: str
    sreq: ServingRequest
    channel: StreamChannel
    ctx: JobCtx
    engine_key: str
    model: str
    created_unix: int
    prompt_tokens: int
    _tok: Any = None
    # leading prompt tokens whose KV was already resident in the radix
    # prefix store at submit time (0 = cold / store off) — the warm-vs-
    # cold TTFT attribution the bench and doctor read
    warm_tokens: int = 0

    def decoder(self) -> Callable[[Optional[int]], str]:
        """Incremental token->text decoder for this request's stream.
        Prefers the tokenizer's byte view (``token_bytes``) through an
        incremental UTF-8 decoder, which holds incomplete multi-byte
        sequences until they complete (call with ``None`` to flush);
        falls back to full re-decode with an emitted-length offset."""
        tok = self._tok
        tb = getattr(tok, "token_bytes", None)
        if tb is not None:
            try:
                tb(0)
            except Exception:  # graftlint: disable=silent-except
                tb = None  # base-class stub probe
        if tb is not None:
            dec = codecs.getincrementaldecoder("utf-8")("replace")

            def decode(tok_id: Optional[int]) -> str:
                if tok_id is None:
                    return dec.decode(b"", True)
                return dec.decode(tb(int(tok_id)))

            return decode

        ids: List[int] = []
        emitted = [0]

        def decode_slow(tok_id: Optional[int]) -> str:
            if tok_id is None:
                return ""
            ids.append(int(tok_id))
            full = tok.decode(ids)
            out = full[emitted[0]:]
            emitted[0] = len(full)
            return out

        return decode_slow


class InteractiveGateway:
    def __init__(self, eng: Any):
        self.eng = eng
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending: Dict[str, Deque[InteractiveRequest]] = {}
        self._active: Dict[str, InteractiveRequest] = {}
        # engine keys with a serve-sentinel queued but not yet popped
        # (dedup: one wake per key, not one per request)
        self._kicked: set = set()
        self._counter = itertools.count(1)
        self.draining = False
        # sticky chat sessions by (engine_key, session_id)
        self._sessions: Dict[tuple, _ChatSession] = {}

    # -- admission (HTTP handler / SDK thread) -------------------------

    def submit(
        self, sreq: ServingRequest, trace_id: Optional[str] = None
    ) -> InteractiveRequest:
        """``trace_id`` is an externally-assigned trace id (the fleet
        router's ``X-Sutro-Trace`` header, via server.py): when given
        and telemetry is on, the request's trace ADOPTS that id instead
        of minting ``tr-<rid>`` — the cross-process propagation that
        lets the router stitch its spans with ours."""
        t_submit = time.monotonic()
        rid = f"ivr-{next(self._counter)}"
        if faults.ACTIVE is not None:
            try:
                faults.inject("serving.admit", job=rid)
            except Exception as e:  # noqa: BLE001 — any injected kind
                # maps to an admission refusal, never a crashed handler
                self._count_outcome("rejected")
                raise GatewayRejected(
                    503, f"admission fault injected: {e}"
                ) from e
        with self._lock:
            if self.draining:
                self._count_outcome("rejected")
                raise GatewayRejected(
                    503, "server is draining (shutdown in progress)"
                )
        # Control-plane admission (engine/control.py): per-tenant
        # token-bucket draw, no waiting — interactive traffic is
        # latency-sensitive, so an empty bucket is an immediate 429.
        ctl = getattr(self.eng, "control", None)
        if ctl is not None:
            admit_err = ctl.admit_interactive(sreq.tenant or "default")
            if admit_err is not None:
                self._count_outcome("rejected")
                raise GatewayRejected(429, admit_err)
        from ..engine.api import resolve_model

        try:
            engine_key, mcfg, meta = resolve_model(sreq.model)
        except ValueError as e:
            self._count_outcome("rejected")
            raise GatewayRejected(404, str(e)) from e
        if meta.get("embedding") or mcfg.head == "embedding":
            self._count_outcome("rejected")
            raise GatewayRejected(
                400, f"model {sreq.model!r} is an embedding model"
            )
        tok = self.eng._get_tokenizer(engine_key, mcfg)

        skey = None
        sess_prev_tokens = 0
        if sreq.kind == "chat":
            from ..engine.tokenizer import encode_chat_batch

            prev = None
            if sreq.session_id is not None:
                skey = (engine_key, sreq.session_id)
                prev = self._session_ids(skey)
                # opportunistic idle sweep: session traffic is exactly
                # when think-time gaps appear, so piggyback here
                self.checkpoint_idle()
            if prev is not None:
                # warm session: the engine already holds KV for every
                # stored id — render ONLY the new user turn
                ids = list(prev) + tok.encode(
                    tok.render_chat_continuation(
                        sreq.prompt, mcfg.chat_template
                    )
                )
                sess_prev_tokens = len(prev)
            else:
                ids = encode_chat_batch(
                    tok, [sreq.prompt], sreq.system_prompt,
                    mcfg.chat_template,
                )[0]
        else:
            # /v1/completions is raw continuation: no chat scaffold
            ids = tok.encode(sreq.prompt)

        # warm-prefix probe (engine/prefixstore.py): a repeated system
        # prompt / template shell means the session will prefill only
        # the novel tail — recorded here so TTFT is attributable
        warm = self.eng.prefix_warm_tokens(
            engine_key, np.asarray(ids, np.int32)
        )

        ecfg = self.eng.ecfg
        max_new = int(sreq.max_tokens or ecfg.max_new_tokens)
        constraint_factory = None
        if sreq.output_schema:
            from ..engine.constrain import schema_constraint_factory
            from ..engine.constrain.fsm import constraint_room

            try:
                constraint_factory = schema_constraint_factory(
                    sreq.output_schema, tok
                )
                # same feasibility raise the batch submit path applies:
                # the schema's shortest accepting output bounds the cap
                room = constraint_room(constraint_factory())
                if max_new < room:
                    max_new = room
            except Exception as e:  # noqa: BLE001 — schema errors are
                # client errors here (no job record to fail later)
                self._count_outcome("rejected")
                raise GatewayRejected(
                    400, f"response_format schema rejected: {e}"
                ) from e

        stop_ids = set(
            tok.stop_ids()
            if hasattr(tok, "stop_ids")
            else [tok.eos_id]
        )
        # created only after everything that can still raise: once the
        # channel exists its owner is the InteractiveRequest handoff
        # below, and an exception in between would strand an open stream
        channel = StreamChannel()

        n_gen = [0]  # raw sampled count, stop tokens included — the
        # scheduler strips stop ids from token_ids, so an immediate-EOS
        # row would otherwise bill completion_tokens=0

        def on_token(row_id: int, tok_id: int, logp: float) -> None:
            n_gen[0] += 1
            # stop tokens are stripped from the final token_ids by the
            # scheduler's release path; skipping them here keeps the
            # streamed text equal to the final rendered text
            if tok_id in stop_ids:
                return
            channel.put_token(row_id, tok_id, logp)

        stop_strs = [s for s in (sreq.stop or []) if s]

        def on_result(res: Any) -> None:
            if res.finish_reason.startswith("error"):
                channel.fail(res.error or res.finish_reason)
                return
            if skey is not None and res.finish_reason != "cancelled":
                # the transcript the engine now has KV for: our prompt
                # ids plus every emitted token (stop ids were stripped
                # by the release path, matching the continuation
                # render's re-supplied end-of-turn marker)
                self._session_update(
                    skey, list(ids) + [int(t) for t in res.token_ids]
                )
            text: Optional[str] = None
            try:
                text = tok.decode(res.token_ids)
                if stop_strs:
                    cut = min(
                        (p for p in (text.find(s) for s in stop_strs)
                         if p >= 0),
                        default=-1,
                    )
                    if cut >= 0:
                        text = text[:cut]
            except Exception:  # noqa: BLE001 — streamed deltas already
                # delivered the content; the terminal record degrades
                logger.warning(
                    "render failed for %s", rid, exc_info=True
                )
            channel.finish(
                {
                    "status": (
                        "cancelled"
                        if res.finish_reason == "cancelled"
                        else "ok"
                    ),
                    "finish_reason": res.finish_reason,
                    "text": text,
                    "gen_tokens": max(len(res.token_ids), n_gen[0]),
                    "input_tokens": res.input_tokens,
                    "cumulative_logprob": float(res.cumulative_logprob),
                }
            )

        req = GenRequest(
            row_id=0,
            prompt_ids=np.array(ids, np.int32),
            max_new_tokens=max_new,
            temperature=float(
                sreq.temperature
                if sreq.temperature is not None
                else ecfg.temperature
            ),
            top_p=float(
                sreq.top_p if sreq.top_p is not None else ecfg.top_p
            ),
            top_k=int(
                sreq.top_k if sreq.top_k is not None else ecfg.top_k
            ),
            constraint_factory=constraint_factory,
            # an over-long interactive prompt errors (surfaced on the
            # stream) rather than silently truncating the user's turn
            allow_truncate=False,
            row_seed=sreq.seed,
            stop_seqs=[s.encode() for s in stop_strs] or None,
        )
        if not telemetry.ENABLED:
            trace_id = None
        else:
            # forensics trace (OBSERVABILITY.md "Forensics"): the id
            # propagates through JobCtx into the scheduler's child
            # spans and through the channel into the server's SSE
            # flush spans; ended by finish(). Handle deliberately not
            # held — the id string IS the cross-function context.
            if trace_id is None:
                trace_id = f"tr-{rid}"
            telemetry.TRACES.start_trace(
                trace_id,
                "interactive",
                {"request_id": rid, "model": sreq.model,
                 "tenant": sreq.tenant or "default"},
                t0_mono=t_submit,
            )
            attrs = {"prompt_tokens": len(ids), "warm_tokens": int(warm)}
            if skey is not None:
                attrs["session_tokens"] = int(sess_prev_tokens)
            telemetry.TRACES.add(
                trace_id, "admit_gateway", t_submit,
                time.monotonic() - t_submit, attrs,
            )
            channel.trace_id = trace_id
        with self._lock:
            ctx = JobCtx(
                job_id=rid,
                pending=[req],
                on_result=on_result,
                should_cancel=lambda: channel.cancelled,
                priority=-1,  # strictly ahead of all batch priorities
                seq=next(self._counter),
                row_retries=0,  # a failed interactive request fails
                #               fast; the client retries, not the engine
                on_token=on_token,
                interactive=True,
                trace_id=trace_id,
                trace_enq_mono=time.monotonic(),
                # session turns checkpoint their KV into the prefix
                # store at release (scheduler._checkpoint_slot) so the
                # NEXT turn admits by prefix hit; requires the tier
                # pool (checkpointed pages must demote, not pin HBM)
                kv_checkpoint=(
                    skey is not None
                    and self.eng._kv_tier_for(engine_key) is not None
                ),
            )
            ir = InteractiveRequest(
                id=rid,
                sreq=sreq,
                channel=channel,
                ctx=ctx,
                engine_key=engine_key,
                model=sreq.model,
                created_unix=int(time.time()),
                prompt_tokens=len(ids),
                _tok=tok,
                warm_tokens=int(warm),
            )
            self._pending.setdefault(engine_key, deque()).append(ir)
            self._active[rid] = ir
            if telemetry.ENABLED:
                telemetry.INTERACTIVE_ACTIVE.set(float(len(self._active)))
                # tenant attribution (the OpenAI `user` field) rides
                # the same capped series as batch submits
                telemetry.TENANT_REQUESTS_TOTAL.inc(
                    1.0, sreq.tenant or "default", "interactive"
                )
            kick = engine_key not in self._kicked
            if kick:
                self._kicked.add(engine_key)
        if kick:
            # wake an idle engine worker (or queue behind the running
            # session, which also polls take_pending directly)
            self.eng._enqueue_serving(engine_key)
        return ir

    # -- sticky chat sessions ------------------------------------------

    def _session_ids(self, skey: tuple) -> Optional[List[int]]:
        """The stored transcript for ``skey`` (marks it hot), or None
        for a new/expired session."""
        with self._lock:
            s = self._sessions.get(skey)
            if s is None:
                return None
            s.last_used = time.monotonic()
            s.checkpointed = False
            return list(s.ids)

    def _session_update(self, skey: tuple, ids: List[int]) -> None:
        with self._lock:
            s = self._sessions.get(skey)
            if s is None:
                if len(self._sessions) >= SESSION_CAP:
                    oldest = min(
                        self._sessions,
                        key=lambda k: self._sessions[k].last_used,
                    )
                    del self._sessions[oldest]
                s = _ChatSession(ids=[], last_used=0.0)
                self._sessions[skey] = s
            s.ids = ids
            s.last_used = time.monotonic()
            s.turns += 1
            s.checkpointed = False

    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def checkpoint_idle(
        self, idle_s: float = SESSION_IDLE_CHECKPOINT_S
    ) -> int:
        """Hibernate idle conversations: for every session untouched
        for ``idle_s``, ask its engine's KV tier pool to demote that
        many cold pages host-ward (the live scheduler session drains
        the queue at its loop top — kvtier.pop_demote_requests). The
        next turn promotes them back in milliseconds instead of
        re-prefilling the whole history. Returns requests posted."""
        now = time.monotonic()
        with self._lock:
            idle = [
                (k, s)
                for k, s in self._sessions.items()
                if not s.checkpointed and now - s.last_used >= idle_s
            ]
        posted = 0
        for (ekey, _sid), s in idle:
            tier = self.eng._kv_tiers.get(ekey)
            if tier is None:
                continue
            try:
                tier.request_demote(np.asarray(s.ids, np.int32))
                s.checkpointed = True
                posted += 1
            except Exception:  # noqa: BLE001 — a hibernation sweep
                # must never break a submit riding on it
                logger.warning("idle checkpoint failed", exc_info=True)
        return posted

    # -- scheduler side (engine worker thread) -------------------------

    def sentinel_popped(self, engine_key: str) -> None:
        with self._lock:
            self._kicked.discard(engine_key)

    def take_pending(self, engine_key: str) -> Optional[JobCtx]:
        with self._lock:
            q = self._pending.get(engine_key)
            if not q:
                return None
            return q.popleft().ctx

    def has_pending(self, engine_key: Optional[str] = None) -> bool:
        with self._lock:
            if engine_key is not None:
                return bool(self._pending.get(engine_key))
            return any(self._pending.values())

    def pending_keys(self) -> List[str]:
        with self._lock:
            return [k for k, q in self._pending.items() if q]

    def finish(self, ctx: JobCtx, outcome: str) -> Dict[str, Any]:
        """Terminal transition for one request (engine worker thread).
        Returns the latency stats the session stamps into co-resident
        batch jobs' telemetry attrs (doctor evidence)."""
        with self._lock:
            ir = self._active.pop(ctx.job_id, None)
            # drop from pending too if it never got adopted (drain/error
            # before a session picked it up)
            if ir is not None:
                q = self._pending.get(ir.engine_key)
                if q:
                    try:
                        q.remove(ir)
                    except ValueError:
                        pass
            if telemetry.ENABLED:
                telemetry.INTERACTIVE_ACTIVE.set(float(len(self._active)))
            self._idle.notify_all()
        if ir is None:
            return {}
        ch = ir.channel
        if not ch.closed:
            # outcomes that never produced a terminal result record
            if outcome == "cancelled" or ch.cancelled:
                ch.finish({"status": "cancelled",
                           "finish_reason": "cancelled", "text": None,
                           "gen_tokens": ch.n_tokens,
                           "input_tokens": ir.prompt_tokens,
                           "cumulative_logprob": 0.0})
            else:
                ch.fail(f"request ended without result ({outcome})")
        ttft = ch.ttft_s()
        starved = (ttft is None) or (ttft > STARVED_TTFT_S)
        final = (
            "cancelled" if (outcome == "cancelled" or ch.cancelled)
            else "error" if (outcome == "error" or ch.error is not None)
            else "ok"
        )
        if telemetry.ENABLED:
            self._count_outcome(final)
            tid = ctx.trace_id
            if ttft is not None:
                # exemplar: the aggregate histogram keeps a pointer to
                # THIS request's trace, so a firing p99 alert resolves
                # to a concrete timeline (`sutro trace <id>`)
                telemetry.TTFT_SECONDS.observe(ttft, exemplar=tid)
            for itl in ch.itl_samples:
                telemetry.ITL_SECONDS.observe(itl, exemplar=tid)
            if tid is not None:
                telemetry.TRACES.event(
                    tid, "finish",
                    {"outcome": final, "tokens": ch.n_tokens,
                     "ttft_s": ttft,
                     "preempted_rows": ctx.stats.get("preempted", 0)},
                )
                telemetry.TRACES.end_trace(tid, final)
            elapsed = max(time.monotonic() - ch.created, 1e-6)
            telemetry.ROWS_PER_SECOND.set(1.0 / elapsed, "interactive")
            if ir.sreq.tenant and (ir.prompt_tokens or ch.n_tokens):
                # interactive token attribution settles at finish —
                # batch jobs settle theirs at the jobstore terminal
                # funnel; anonymous requests don't spend a series
                telemetry.TENANT_TOKENS_TOTAL.inc(
                    float(ir.prompt_tokens), ir.sreq.tenant, "in"
                )
                if ch.n_tokens:
                    telemetry.TENANT_TOKENS_TOTAL.inc(
                        float(ch.n_tokens), ir.sreq.tenant, "out"
                    )
        return {
            "outcome": final,
            "ttft_s": ttft,
            "starved": bool(starved and final != "cancelled"),
            "tokens": ch.n_tokens,
            "preempted_rows": ctx.stats.get("preempted", 0),
            # submit-time probe + what the scheduler actually skipped
            "warm_prefix_tokens": ir.warm_tokens,
            "prefix_saved_tokens": int(
                getattr(ctx, "prefix_saved", 0)
            ),
        }

    # -- fleet router probes (fleet/frames.py) -------------------------

    def probe_warm(self, sreq: ServingRequest) -> tuple:
        """Side-effect-free warm-prefix probe for the fleet router:
        tokenize exactly as ``submit`` would (same chat scaffold, same
        session-continuation rendering) and peek the radix prefix
        store. Returns ``(warm_tokens, prompt_tokens)``. No admission,
        no KV mutation, no session checkpoint sweep — a probe must
        never change what it measures."""
        from ..engine.api import resolve_model

        try:
            engine_key, mcfg, meta = resolve_model(sreq.model)
        except ValueError:
            return 0, 0
        if meta.get("embedding") or mcfg.head == "embedding":
            return 0, 0
        tok = self.eng._get_tokenizer(engine_key, mcfg)
        sess_prev_tokens = 0
        if sreq.kind == "chat":
            from ..engine.tokenizer import encode_chat_batch

            prev = None
            if sreq.session_id is not None:
                prev = self._session_ids((engine_key, sreq.session_id))
            if prev is not None:
                ids = list(prev) + tok.encode(
                    tok.render_chat_continuation(
                        sreq.prompt, mcfg.chat_template
                    )
                )
                sess_prev_tokens = len(prev)
            else:
                ids = encode_chat_batch(
                    tok, [sreq.prompt], sreq.system_prompt,
                    mcfg.chat_template,
                )[0]
        else:
            ids = tok.encode(sreq.prompt)
        warm = int(
            self.eng.prefix_warm_tokens(
                engine_key, np.asarray(ids, np.int32)
            )
        )
        # a live session IS warmth: its KV (resident or tiered) lives
        # on this replica only, so session stickiness dominates any
        # other replica's template-shell warmth
        return max(warm, sess_prev_tokens), len(ids)

    # -- drain (SIGTERM path) ------------------------------------------

    def begin_drain(self) -> None:
        with self._lock:
            self.draining = True

    def wait_idle(self, timeout: float) -> bool:
        """Block until no request is active (or timeout). Used by the
        graceful-shutdown drain: new submits are already refused."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._active:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(min(left, 0.5))
            return True

    def cancel_all(self) -> None:
        """Hard-cancel every live request (drain timeout expired)."""
        with self._lock:
            irs = list(self._active.values())
        for ir in irs:
            ir.channel.cancel()

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def _count_outcome(self, outcome: str) -> None:
        if telemetry.ENABLED:
            telemetry.INTERACTIVE_REQUESTS_TOTAL.inc(1.0, outcome)
