"""Warm-prefix affinity scoring for interactive routing.

The port of ``sutro_tpu/fleet/affinity.py``, line for line.

SGLang-style cache-aware routing: each healthy replica that speaks the
fleet protocol answers ``POST /fleet-warm`` with how many tokens of
this request's prompt its radix prefix store already holds warm
(``prefixstore.peek`` — side-effect free, no admission, no KV
mutation). The router then prefers the warmest replica, tie-breaking
least-loaded.

Probes are best-effort with a short timeout: a replica that fails or
404s a probe scores 0 (cold), never errors the request. A tiny TTL
cache keyed by the prompt shell keeps a burst of same-template chats
from re-probing the fleet per message.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from typing import Any, Dict, List

from . import frames

logger = logging.getLogger(__name__)

#: probe answers older than this are re-asked (seconds)
CACHE_TTL_S = 2.0
#: bound on remembered shells (router-lifetime, tiny entries)
CACHE_MAX = 512


def shell_key(body: Dict[str, Any], chat: bool) -> str:
    """Stable digest of the request's prompt content (the affinity
    signal). Sampling params are deliberately excluded — two requests
    sharing a template shell share warmth regardless of temperature."""
    if chat:
        content = body.get("messages")
    else:
        content = body.get("prompt")
    raw = json.dumps(
        [body.get("model"), content], sort_keys=True, default=str
    ).encode("utf-8", "replace")
    return hashlib.sha1(raw).hexdigest()


class WarmAffinity:
    def __init__(self, timeout: float = 0.75, send=frames._send):
        self.timeout = float(timeout)
        self._send = send
        self._lock = threading.Lock()
        # key -> (monotonic_ts, {rid: warm_tokens})
        self._cache: Dict[str, Any] = {}

    def scores(
        self, body: Dict[str, Any], chat: bool, replicas: List[Dict[str, Any]]
    ) -> Dict[str, int]:
        """warm-token count per replica id for this request. Replicas
        without warm-probe support (legacy protocol) are omitted —
        they participate in least-loaded routing only."""
        probe_rows = [r for r in replicas if r.get("warm_probe")]
        if not probe_rows:
            return {}
        key = shell_key(body, chat)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and now - hit[0] <= CACHE_TTL_S:
                cached = hit[1]
                if all(r["rid"] in cached for r in probe_rows):
                    return {r["rid"]: cached[r["rid"]] for r in probe_rows}
        frame = frames.warm_probe_frame(body, chat)
        out: Dict[str, int] = {}
        for r in probe_rows:
            try:
                doc = self._send(
                    "post", r["url"] + "/fleet-warm", frame, timeout=self.timeout
                )
            except Exception as exc:
                # a dead/slow replica scores cold, never blocks routing
                logger.debug("warm probe to %s failed: %s", r["rid"], exc)
                out[r["rid"]] = 0
                continue
            if isinstance(doc, dict) and doc.get("_status", 200) == 404:
                out[r["rid"]] = 0  # old replica: probe-only routing
            else:
                out[r["rid"]] = frames.parse_warm_report(doc)
        with self._lock:
            if len(self._cache) >= CACHE_MAX:
                # drop the stalest half; simple and O(n) at the bound
                keep = sorted(
                    self._cache.items(), key=lambda kv: kv[1][0], reverse=True
                )[: CACHE_MAX // 2]
                self._cache = dict(keep)
            self._cache[key] = (now, dict(out))
        return out

    def invalidate(self) -> None:
        with self._lock:
            self._cache.clear()
