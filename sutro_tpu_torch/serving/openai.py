"""OpenAI-compatible request/response shapes for the interactive tier.

The port of ``sutro_tpu/serving/openai.py``.

One parsing + rendering module shared by the HTTP surface (server.py
wraps the chunk dicts in SSE framing) and the SDK's local path
(sdk.Sutro.chat iterates the same dicts in-process). Keeping both
consumers on one builder set is what makes the shape tests in
tests/test_torch_serving.py cover the SDK for free.

Covered surface (PARITY.md "OpenAI-compat" row):

- ``POST /v1/chat/completions`` — ``messages`` (string or
  ``[{"type":"text"}]`` content parts), ``stream``, ``max_tokens`` /
  ``max_completion_tokens``, ``temperature``, ``top_p``, ``stop``,
  ``seed``, ``response_format`` (``json_object`` / ``json_schema`` →
  the engine's constrained-decode path), ``n=1`` only.
- ``POST /v1/completions`` — ``prompt`` (string), same sampling knobs.

Multi-turn conversations flatten to one prompt string (the engine's
chat template renders a single user turn): system messages join into
``system_prompt``; a single user message passes through verbatim; a
longer history renders as ``role: content`` lines.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, List, Optional

from ..common import normalize_output_schema


class BadServingRequest(ValueError):
    """Client error → HTTP 400 with an OpenAI-shaped error body."""


@dataclasses.dataclass
class ServingRequest:
    model: str
    prompt: str
    system_prompt: Optional[str] = None
    stream: bool = False
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    output_schema: Optional[Dict[str, Any]] = None
    stop: Optional[List[str]] = None
    seed: Optional[int] = None
    kind: str = "chat"  # "chat" | "completion"
    # tenant attribution: the OpenAI `user` field, threaded into the
    # capped per-tenant telemetry series (telemetry/monitor.py)
    tenant: Optional[str] = None
    # sticky conversation handle (non-OpenAI extension): turns of the
    # same session_id reuse the session's KV — the gateway stores the
    # running token transcript, renders only the new user turn as a
    # continuation, and the engine admits it by prefix hit; idle
    # sessions checkpoint their pages down the KV tiers
    session_id: Optional[str] = None


def _content_text(content: Any) -> str:
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        parts = []
        for part in content:
            if not isinstance(part, dict) or part.get("type") != "text":
                raise BadServingRequest(
                    "only text content parts are supported"
                )
            parts.append(str(part.get("text", "")))
        return "".join(parts)
    raise BadServingRequest("message content must be a string or list")


def _parse_response_format(rf: Any) -> Optional[Dict[str, Any]]:
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise BadServingRequest("response_format must be an object")
    kind = rf.get("type")
    if kind in (None, "text"):
        return None
    if kind == "json_object":
        return {"type": "object"}
    if kind == "json_schema":
        js = rf.get("json_schema", rf)
        schema = js.get("schema") if isinstance(js, dict) else None
        if not isinstance(schema, dict):
            raise BadServingRequest(
                "response_format.json_schema.schema must be an object"
            )
        try:
            return normalize_output_schema(schema)
        except Exception as e:
            raise BadServingRequest(f"invalid json_schema: {e}") from e
    raise BadServingRequest(f"unsupported response_format type {kind!r}")


def parse_request(body: Any, *, chat: bool) -> ServingRequest:
    if not isinstance(body, dict):
        raise BadServingRequest("request body must be a JSON object")
    model = body.get("model")
    if not isinstance(model, str) or not model:
        raise BadServingRequest("'model' is required")
    if body.get("n", 1) not in (1, None):
        raise BadServingRequest("only n=1 is supported")

    system_prompt: Optional[str] = None
    if chat:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise BadServingRequest("'messages' must be a non-empty list")
        sys_parts: List[str] = []
        turns: List[tuple] = []
        for m in messages:
            if not isinstance(m, dict):
                raise BadServingRequest("each message must be an object")
            role = m.get("role")
            text = _content_text(m.get("content"))
            if role == "system":
                sys_parts.append(text)
            elif role in ("user", "assistant"):
                turns.append((role, text))
            else:
                raise BadServingRequest(f"unsupported role {role!r}")
        if sys_parts:
            system_prompt = "\n\n".join(sys_parts)
        if not turns:
            raise BadServingRequest("at least one user message required")
        if len(turns) == 1:
            prompt = turns[0][1]
        else:
            prompt = "\n\n".join(f"{role}: {text}" for role, text in turns)
    else:
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            # OpenAI accepts a list of prompts; we serve one request/row
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                raise BadServingRequest(
                    "'prompt' must be a string (or a 1-element list)"
                )
            prompt = prompt[0]
        if not isinstance(prompt, str):
            raise BadServingRequest("'prompt' must be a string")

    max_tokens = body.get("max_completion_tokens", body.get("max_tokens"))
    if max_tokens is not None:
        try:
            max_tokens = int(max_tokens)
        except (TypeError, ValueError):
            raise BadServingRequest("max_tokens must be an integer")
        if max_tokens <= 0:
            raise BadServingRequest("max_tokens must be positive")

    stop = body.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    if stop is not None and (
        not isinstance(stop, list)
        or not all(isinstance(s, str) for s in stop)
    ):
        raise BadServingRequest("stop must be a string or list of strings")

    def _num(key: str, cast) -> Optional[Any]:
        v = body.get(key)
        if v is None:
            return None
        try:
            return cast(v)
        except (TypeError, ValueError):
            raise BadServingRequest(f"{key} must be a number")

    tenant = body.get("user")
    if tenant is not None and not isinstance(tenant, str):
        raise BadServingRequest("user must be a string")

    session_id = body.get("session_id")
    if session_id is not None:
        if not chat:
            raise BadServingRequest(
                "session_id is only supported on /v1/chat/completions"
            )
        if not isinstance(session_id, str) or not session_id.strip():
            raise BadServingRequest("session_id must be a non-empty string")
        session_id = session_id.strip()
        # sticky sessions carry the history server-side: the NEW user
        # turn is the last user message; earlier turns in the payload
        # are ignored on a warm session (the transcript is ours)
        users = [t for r, t in turns if r == "user"]
        if not users:
            raise BadServingRequest(
                "session requests need a user message"
            )
        prompt = users[-1]

    return ServingRequest(
        model=model,
        prompt=prompt,
        system_prompt=system_prompt,
        stream=bool(body.get("stream", False)),
        max_tokens=max_tokens,
        temperature=_num("temperature", float),
        top_p=_num("top_p", float),
        top_k=_num("top_k", int),
        output_schema=_parse_response_format(body.get("response_format")),
        stop=stop,
        seed=_num("seed", int),
        kind="chat" if chat else "completion",
        tenant=(tenant.strip() or None) if tenant else None,
        session_id=session_id,
    )


# -- response builders --------------------------------------------------

def _finish_reason(reason: Optional[str]) -> Optional[str]:
    if reason is None:
        return None
    return "length" if reason == "length" else "stop"


def chat_chunk(
    rid: str,
    created: int,
    model: str,
    *,
    content: Optional[str] = None,
    role: Optional[str] = None,
    finish_reason: Optional[str] = None,
) -> Dict[str, Any]:
    delta: Dict[str, Any] = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [
            {
                "index": 0,
                "delta": delta,
                "finish_reason": _finish_reason(finish_reason),
            }
        ],
    }


def chat_response(
    rid: str,
    created: int,
    model: str,
    text: str,
    finish_reason: str,
    usage: Dict[str, int],
) -> Dict[str, Any]:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": created,
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": _finish_reason(finish_reason) or "stop",
            }
        ],
        "usage": usage,
    }


def completion_chunk(
    rid: str,
    created: int,
    model: str,
    *,
    content: Optional[str] = None,
    finish_reason: Optional[str] = None,
) -> Dict[str, Any]:
    return {
        "id": rid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [
            {
                "index": 0,
                "text": content or "",
                "finish_reason": _finish_reason(finish_reason),
            }
        ],
    }


def completion_response(
    rid: str,
    created: int,
    model: str,
    text: str,
    finish_reason: str,
    usage: Dict[str, int],
) -> Dict[str, Any]:
    return {
        "id": rid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [
            {
                "index": 0,
                "text": text,
                "finish_reason": _finish_reason(finish_reason) or "stop",
            }
        ],
        "usage": usage,
    }


def usage_dict(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {
        "prompt_tokens": int(prompt_tokens),
        "completion_tokens": int(completion_tokens),
        "total_tokens": int(prompt_tokens) + int(completion_tokens),
    }


# -- shared consumption loops ------------------------------------------

def iter_stream(ir: Any, *, chat: bool) -> Iterator[Optional[Dict[str, Any]]]:
    """Consume an InteractiveRequest's channel into OpenAI chunk dicts.

    Yields ``None`` on heartbeat gaps (the HTTP layer turns those into
    SSE pings to probe the socket; the SDK filters them out). The first
    content chunk of a chat stream carries ``role: assistant`` per the
    OpenAI convention. Raises RuntimeError on a terminal error event.

    Text that may begin one of the request's stop strings is held back
    until it does not, and the stream ends before the first stop string,
    as the terminal record's text does: the deltas concatenate to the
    collected reply. (The JAX package streams a stop string's text.)
    """
    build = chat_chunk if chat else completion_chunk
    decode = ir.decoder()
    sreq = getattr(ir, "sreq", None)
    stops = [s for s in (getattr(sreq, "stop", None) or []) if s]
    held = [""]   # decoded text not yet sent: it may begin a stop string
    stopped = [False]

    def release(text: str, final: bool = False) -> str:
        if stopped[0]:
            return ""
        if not stops:
            return text
        text = held[0] + text
        cut = min(
            (p for p in (text.find(s) for s in stops) if p >= 0),
            default=-1,
        )
        if cut >= 0:
            stopped[0] = True
            held[0] = ""
            return text[:cut]
        keep = 0 if final else max(
            (k for s in stops for k in range(1, len(s))
             if text.endswith(s[:k])),
            default=0,
        )
        held[0] = text[len(text) - keep:]
        return text[: len(text) - keep]

    first = True
    for ev in ir.channel.events():
        if ev is None:
            yield None
            continue
        if ev[0] == "token":
            text = release(decode(ev[1]))
            if not text:
                continue
            kw: Dict[str, Any] = {"content": text}
            if chat and first:
                kw["role"] = "assistant"
            first = False
            yield build(ir.id, ir.created_unix, ir.model, **kw)
        elif ev[0] == "done":
            res = ev[1]
            if res.get("status") == "cancelled":
                return
            # flush the incomplete utf-8 tail and the held text
            tail = release(decode(None), final=True)
            if tail:
                kw = {"content": tail}
                if chat and first:
                    kw["role"] = "assistant"
                first = False
                yield build(ir.id, ir.created_unix, ir.model, **kw)
            yield build(
                ir.id, ir.created_unix, ir.model,
                finish_reason=res.get("finish_reason") or "stop",
            )
            return
        else:  # ("error", msg)
            raise RuntimeError(f"interactive request failed: {ev[1]}")


def collect(ir: Any, *, chat: bool, timeout: float = 600.0) -> Dict[str, Any]:
    """Drain the channel to completion and build the non-streaming
    response object."""
    import time as _time

    decode = ir.decoder()
    parts: List[str] = []
    deadline = _time.monotonic() + timeout
    finish = "stop"
    done = False
    gen_tokens: Optional[int] = None
    try:
        for ev in ir.channel.events(deadline=deadline):
            if ev is None:
                continue
            if ev[0] == "token":
                parts.append(decode(ev[1]))
            elif ev[0] == "done":
                res = ev[1]
                if res.get("status") == "cancelled":
                    raise RuntimeError("request cancelled")
                # the terminal result carries the authoritative rendered
                # text (stop tokens stripped, full decode) — prefer it
                # to our incremental reassembly when present
                if res.get("text") is not None:
                    parts = [res["text"]]
                else:
                    parts.append(decode(None) or "")
                finish = res.get("finish_reason") or "stop"
                gen_tokens = res.get("gen_tokens")
                done = True
                break
            else:
                raise RuntimeError(
                    f"interactive request failed: {ev[1]}"
                )
    except Exception:
        # a consumer-side raise mid-drain (decoder error, malformed
        # terminal record) must stop the producer too: without cancel()
        # the scheduler keeps generating tokens for a stream nobody
        # reads. cancel() is an idempotent flag — calling it after a
        # terminal event is a no-op.
        ir.channel.cancel()
        raise
    if not done:
        ir.channel.cancel()
        raise RuntimeError("interactive request timed out")
    # prefer the terminal record's count: stop-id tokens never reach
    # the channel, so n_tokens undercounts rows that end on EOS
    usage = usage_dict(
        ir.prompt_tokens,
        gen_tokens if gen_tokens is not None else ir.channel.n_tokens,
    )
    text = "".join(parts)
    build = chat_response if chat else completion_response
    return build(ir.id, ir.created_unix, ir.model, text, finish, usage)


def sse_frame(obj: Optional[Dict[str, Any]]) -> bytes:
    """One SSE frame; ``None`` renders the heartbeat comment line."""
    if obj is None:
        return b": ping\n\n"
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
