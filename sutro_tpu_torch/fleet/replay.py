"""Trace-replay load harness: capture live traffic shape, replay it.

The port of ``sutro_tpu/fleet/replay.py``; a record is posted over
``http.client`` (``frames._open``), not ``requests``.

The router's trace ring (fleet/obs.py) already records, per relayed
interactive request, everything a load generator needs: arrival time,
chat-vs-completions shape, model, session id, stream flag, and (for
bodies under the size cap) the request body itself. This module turns
that ring into a **replayable workload**:

- :func:`records_from_traces` — drain a trace store into replay
  records, arrival offsets re-based to the first request (the shape of
  the traffic is preserved, its absolute wall-clock is not);
- :func:`synthetic_records` — a deterministic session-heavy synthetic
  trace (seeded PRNG) for benches that must not depend on captured
  traffic; multi-turn sessions share a prompt prefix so warm-prefix
  routing has something to win on;
- :func:`dump_jsonl` / :func:`load_jsonl` — one JSON object per line,
  the replay file format (schema below);
- :func:`replay` — schedule the records against a base url at a
  configurable speedup, one thread per in-flight request, measuring
  per-request TTFT (first SSE data byte) and outcome.

JSONL record schema (one line each, additive like every wire schema in
this repo — readers ``.get`` with defaults):

    {"arrival_offset_s": 0.0,         # seconds after trace start
     "kind": "chat",                  # chat | completions
     "model": "tiny-dense",
     "session_id": "sess-0",          # or null
     "stream": true,
     "body": {...}}                   # full OpenAI-shaped request body

Replaying a record POSTs ``body`` to ``/v1/chat/completions`` or
``/v1/completions`` at ``arrival_offset_s / speedup`` seconds after
the replay starts. Records without a captured body (the router caps
capture at :data:`REPLAY_BODY_MAX_BYTES`) are skipped and counted.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

#: request bodies above this size are not captured into the trace ring
#: (the ring is a forensic museum, not a payload archive)
REPLAY_BODY_MAX_BYTES = 16384


# -- capture ------------------------------------------------------------


def replay_attrs(
    body: Dict[str, Any],
    chat: bool,
    stream: bool,
    arrival_unix: float,
    body_bytes: int,
) -> Dict[str, Any]:
    """The trace attrs the router records per relayed request so the
    ring stays replayable. Oversized bodies are dropped (not
    truncated — a half body would replay as a different workload)."""
    attrs: Dict[str, Any] = {
        "kind": "chat" if chat else "completions",
        "model": str(body.get("model") or ""),
        "session_id": body.get("session_id"),
        "stream": bool(stream),
        "arrival_unix": round(float(arrival_unix), 6),
    }
    if body_bytes <= REPLAY_BODY_MAX_BYTES:
        attrs["replay_body"] = body
    return attrs


def records_from_traces(traces) -> List[Dict[str, Any]]:
    """Replayable records from a TraceStore ring (router-side traces
    carrying :func:`replay_attrs`), sorted by arrival, offsets re-based
    to the earliest request. Traces without an arrival stamp (engine
    traces, batch jobs) are ignored."""
    rows = []
    for tid in traces.ids():
        tr = traces.get(tid)
        if tr is None:
            continue
        a = tr.attrs
        arrival = a.get("arrival_unix")
        if arrival is None or a.get("kind") not in ("chat", "completions"):
            continue
        rows.append((float(arrival), tid, a))
    rows.sort(key=lambda r: (r[0], r[1]))
    if not rows:
        return []
    t0 = rows[0][0]
    out = []
    for arrival, _tid, a in rows:
        rec: Dict[str, Any] = {
            "arrival_offset_s": round(arrival - t0, 6),
            "kind": a["kind"],
            "model": a.get("model") or "",
            "session_id": a.get("session_id"),
            "stream": bool(a.get("stream", False)),
        }
        if a.get("replay_body") is not None:
            rec["body"] = a["replay_body"]
        out.append(rec)
    return out


# -- synthesis ----------------------------------------------------------


def synthetic_records(
    n: int = 40,
    n_sessions: int = 4,
    model: str = "tiny-dense",
    mean_gap_s: float = 0.15,
    max_tokens: int = 4,
    seed: int = 1234,
) -> List[Dict[str, Any]]:
    """A deterministic session-heavy chat trace: ``n`` requests spread
    over ``n_sessions`` multi-turn sessions, exponential inter-arrival
    gaps (seeded). Sessions are interleaved round-robin — the shape a
    router sees from concurrent users — so consecutive turns of one
    session are ``n_sessions`` arrivals apart and a replayed turn can
    realistically find its predecessor's KV already checkpointed.
    Turns of one session share the session id, so cache-aware routing
    is exercised exactly as a captured trace would."""
    import random

    rng = random.Random(seed)
    t = 0.0
    out: List[Dict[str, Any]] = []
    turn_count = [0] * n_sessions
    for i in range(n):
        t += rng.expovariate(1.0 / mean_gap_s)
        s = i % n_sessions
        turn_count[s] += 1
        sid = "replay-sess-%d" % s
        body = {
            "model": model,
            "session_id": sid,
            "max_tokens": max_tokens,
            "temperature": 0,
            "stream": True,
            "messages": [
                {
                    "role": "user",
                    "content": "session %d turn %d: continue the story"
                    % (s, turn_count[s]),
                }
            ],
        }
        out.append(
            {
                "arrival_offset_s": round(t, 6),
                "kind": "chat",
                "model": model,
                "session_id": sid,
                "stream": True,
                "body": body,
            }
        )
    return out


# -- file format --------------------------------------------------------


def dump_jsonl(records: List[Dict[str, Any]], path) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def load_jsonl(path) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if isinstance(doc, dict):
                out.append(doc)
    return out


# -- replay driver ------------------------------------------------------


def _fire_one(
    base_url: str, rec: Dict[str, Any], timeout: float
) -> Dict[str, Any]:
    """POST one record, streaming; returns {ok, ttft_s | error}."""
    from .frames import _open

    tail = (
        "chat/completions" if rec.get("kind") == "chat" else "completions"
    )
    body = dict(rec["body"])
    body["stream"] = True
    t0 = time.perf_counter()
    try:
        resp = _open(
            "post",
            "%s/v1/%s" % (base_url, tail),
            json.dumps(body).encode(),
            {"Content-Type": "application/json"},
            connect_timeout=5.0,
            read_timeout=timeout,
            stream=True,
        )
        if resp.status_code != 200:
            resp.close()
            return {"ok": False, "error": "http %d" % resp.status_code}
        ttft = None
        for chunk in resp.iter_content():
            if chunk and ttft is None:
                ttft = time.perf_counter() - t0
            # drain to completion so the replica's slot frees cleanly
        return {
            "ok": ttft is not None,
            "ttft_s": round(ttft, 6) if ttft is not None else None,
        }
    except OSError as e:
        return {"ok": False, "error": "%s: %s" % (type(e).__name__, e)}


def replay(
    base_url: str,
    records: List[Dict[str, Any]],
    speedup: float = 1.0,
    timeout: float = 300.0,
) -> Dict[str, Any]:
    """Replay ``records`` against ``base_url`` honoring the recorded
    arrival process at ``speedup``x. One thread per request (arrivals
    are open-loop: a slow response never delays the next arrival —
    the property that makes replayed p99 honest). Returns::

        {"n": ..., "sent": ..., "ok": ..., "errors": [...first few...],
         "skipped_no_body": ..., "wall_s": ...,
         "ttft": {"p50_s": ..., "p99_s": ..., "max_s": ..., "count": ...},
         "rps": ...}
    """
    speedup = max(float(speedup), 1e-6)
    runnable = [r for r in records if r.get("body")]
    skipped = len(records) - len(runnable)
    results: List[Optional[Dict[str, Any]]] = [None] * len(runnable)
    threads = []
    t_start = time.perf_counter()

    def _worker(i: int, rec: Dict[str, Any]) -> None:
        delay = float(rec.get("arrival_offset_s") or 0.0) / speedup
        wait = t_start + delay - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        results[i] = _fire_one(base_url, rec, timeout)

    for i, rec in enumerate(runnable):
        th = threading.Thread(
            target=_worker, args=(i, rec), daemon=True
        )
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout)
    wall = time.perf_counter() - t_start
    done = [r for r in results if r is not None]
    oks = [r for r in done if r.get("ok")]
    ttfts = sorted(
        r["ttft_s"] for r in oks if r.get("ttft_s") is not None
    )

    def _pct(q: float) -> Optional[float]:
        if not ttfts:
            return None
        idx = min(int(q * len(ttfts)), len(ttfts) - 1)
        return ttfts[idx]

    errors = [r.get("error") for r in done if not r.get("ok")][:5]
    return {
        "n": len(records),
        "sent": len(runnable),
        "ok": len(oks),
        "errors": errors,
        "skipped_no_body": skipped,
        "wall_s": round(wall, 3),
        "rps": round(len(oks) / wall, 3) if wall > 0 else 0.0,
        "ttft": {
            "p50_s": _pct(0.50),
            "p99_s": _pct(0.99),
            "max_s": ttfts[-1] if ttfts else None,
            "count": len(ttfts),
        },
    }
