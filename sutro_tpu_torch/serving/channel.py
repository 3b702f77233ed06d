"""Per-request streaming channel: scheduler thread -> HTTP/SDK thread.

The port of ``sutro_tpu/serving/channel.py``.

The batch tier streams results through the jobstore (durable, chunked);
the interactive tier cannot afford a disk round-trip per token, so each
request gets ONE in-memory channel. The scheduler's single token-commit
point (``JobCtx.on_token``) produces into it; the HTTP handler (or the
SDK's local iterator) consumes. Lifecycle:

- ``put_token`` — producer side, called per accepted token; records
  TTFT / inter-token-latency samples as a side effect (the channel is
  the only place that sees both the submit time and each token time).
- ``finish`` / ``fail`` — terminal; exactly one wins, late calls no-op.
- ``cancel`` — consumer side (client disconnect, injected stream
  fault): flips a flag the request's ``should_cancel`` reads, so the
  scheduler frees the slot and its KV pages on its next loop iteration.
- ``events`` — the consumer's iterator: yields ``("token", id, logp)``
  then one ``("done", result)`` or ``("error", msg)``; yields ``None``
  on heartbeat gaps so the caller can write an SSE ping (the write is
  what detects a dead client).

The producer never blocks: a consumer that stopped draining (socket
gone but not yet detected) trips the buffer bound, which cancels the
request rather than growing without bound.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .. import telemetry

#: producer-side backstop: tokens buffered with no consumer progress
MAX_BUFFERED_EVENTS = 65536
#: bounded inter-token-latency sample list per request
MAX_ITL_SAMPLES = 4096


class StreamChannel:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._events: deque = deque()
        self._closed = False
        self._cancelled = False
        self.created = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.itl_samples: List[float] = []
        self.n_tokens = 0
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        # forensics trace id, set by the gateway when telemetry is on;
        # None means every trace hook below is skipped
        self.trace_id: Optional[str] = None

    # -- producer side (scheduler thread) ------------------------------

    def put_token(self, row_id: int, tok: int, logp: float) -> None:
        now = time.monotonic()
        with self._cond:
            if self._closed or self._cancelled:
                return
            if self.first_token_at is None:
                self.first_token_at = now
                if self.trace_id is not None and telemetry.ENABLED:
                    telemetry.TRACES.add(
                        self.trace_id, "first_token", now, 0.0,
                        {"ttft_s": round(now - self.created, 6)},
                    )
            elif len(self.itl_samples) < MAX_ITL_SAMPLES:
                self.itl_samples.append(now - self.last_token_at)
            self.last_token_at = now
            self.n_tokens += 1
            self._events.append(("token", int(tok), float(logp)))
            if len(self._events) > MAX_BUFFERED_EVENTS:
                # consumer stopped draining: cancel rather than grow
                self._cancelled = True
            self._cond.notify_all()

    def finish(self, result: Dict[str, Any]) -> None:
        """Terminal success/cancel record (the rendered GenResult)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self.result = result
            self._events.append(("done", result))
            self._cond.notify_all()

    def fail(self, msg: str) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self.error = msg
            self._events.append(("error", msg))
            self._cond.notify_all()

    # -- consumer side (HTTP handler / SDK iterator) -------------------

    def cancel(self) -> None:
        """Consumer-side teardown (client disconnect): the request's
        ``should_cancel`` reads this flag on the scheduler's next loop
        iteration, which releases the slot and frees its KV pages."""
        with self._cond:
            self._cancelled = True
            self._cond.notify_all()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def closed(self) -> bool:
        return self._closed

    def events(
        self, heartbeat: float = 0.25, deadline: Optional[float] = None
    ) -> Iterator[Optional[Tuple[Any, ...]]]:
        """Yield events until the terminal one; ``None`` marks a
        heartbeat gap (no event within ``heartbeat`` seconds) so the
        consumer can probe the socket. Ends without a terminal event
        only on ``deadline`` (absolute monotonic) or after ``cancel``
        once the queue is drained."""
        while True:
            with self._cond:
                if not self._events and not self._closed:
                    self._cond.wait(heartbeat)
                ev = self._events.popleft() if self._events else None
                closed, cancelled = self._closed, self._cancelled
            if ev is not None:
                yield ev
                if ev[0] in ("done", "error"):
                    return
                continue
            if closed:
                return  # terminal event already consumed elsewhere
            if cancelled:
                return  # consumer tore the request down; nothing more
            if deadline is not None and time.monotonic() > deadline:
                return
            yield None  # heartbeat

    # -- latency accounting --------------------------------------------

    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.created
