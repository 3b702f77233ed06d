"""Device time of the scheduler's timed calls, from CUDA events, and
the port's span schema for those calls.

Spans. ``RECORDER`` spans are ``(name, job_id, t0_s, dur_s, attrs)``;
``t0_s`` and ``dur_s`` are ``time.monotonic()`` seconds, and
``RECORDER.epoch_mono + t0_s`` is a span's start on that clock. On Linux
CPython ``time.monotonic()`` and ``time.perf_counter()`` both read
``CLOCK_MONOTONIC``, so a span lines up with a ``perf_counter`` reading,
and with a ``torch.profiler`` trace mapped onto it, with no offset
(``tests/test_torch_tracing.py`` pins it). The scheduler's device
stages:

- ``decode_window`` (timer phase ``decode``): one decode call into the
  runner, from the call until it returns. A synchronous call
  (``decode_step``, ``decode_multi``, ``decode_window``,
  ``commit_window``, ``verify_*``) whole; a pipelined window's dispatch
  alone, while the card may still run the window before it.
- ``decode_fetch`` (phase ``decode_fetch``): a pipelined window's
  fetch, the host waiting on the card for its tokens. It enqueues
  nothing and has no events.
- ``prefill``, ``admit`` (phase ``admit_sample``): one prefill call, one
  admission's first-token sampling call.
- ``submit``: ``LocalEngine.submit_batch_inference``, the whole call.

Their attrs:

- ``batch``, ``steps``, ``avg_ctx`` on ``decode_window``: the call's
  active rows, fused steps (1 for a verify forward) and mean context;
  once a window (not on ``commit_window``'s span).
- ``win`` on a pipelined window's ``decode_window`` and
  ``decode_fetch``: the window's number, unique in the process.
- ``tokens`` on ``prefill``: the tokens the call prefilled.
- ``device_s`` and ``gap_s`` on every span of a clocked call below.

Device time. A timed phase that enqueues work on the card (the
scheduler's ``StepTimer`` phases ``prefill``, ``admit_sample`` and
``decode``) is bracketed by a pair of timing events on the current
stream of the runner's device (rank 0's on a mesh). A pair stays pending
until its end event has completed (``query()``) and is only read then,
so reading it never waits on the card and adds no synchronisation. The
timer polls the pending pairs after every timed call; a pipelined
window's pair has completed by the fetch that waits for that window.

Each resolved pair gives two figures, written into the attrs of its own
call's span (the recorder holds them by reference, so a pipelined
dispatch's span gets them at its fetch):

- ``device_s``: start event to end event, the card's time on the call
  (idle inside it included);
- ``gap_s``: the previous pair's end event to this pair's start event,
  card time outside every timed phase (idle, or work no phase enqueued).

The event source is one object with ``new()`` (a fresh event) and
``record(event)``; an event behaves as
``torch.cuda.Event(enable_timing=True)`` does: ``query()``, and
``elapsed_time(end)`` in milliseconds. :class:`CudaEvents` is the card's;
tests pass a fake. Events come from a small pool and go back to it once
read. One clock serves one scheduler thread (one batcher), so it takes
no lock: pairs resolve in the order they were recorded, the stream's.
With telemetry off, or on a CPU runner, there is no clock and no event,
and spans carry no ``device_s``/``gap_s``. One pair a call, never one a
layer, step or token.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, List, Optional


class CudaEvents:
    """Timing events on the current stream of one CUDA device."""

    def __init__(self, device: Any) -> None:
        import torch

        self._torch = torch
        self.device = torch.device(device)

    def new(self) -> Any:
        return self._torch.cuda.Event(enable_timing=True)

    def record(self, event: Any) -> None:
        event.record(self._torch.cuda.current_stream(self.device))


class Pair:
    """One timed call's events, then its figures once resolved."""

    __slots__ = ("start", "end", "attrs", "device_s", "gap_s")

    def __init__(self, start: Any) -> None:
        self.start = start
        self.end: Any = None
        self.attrs: Optional[Dict[str, Any]] = None
        self.device_s: Optional[float] = None
        self.gap_s: Optional[float] = None

    def _write(self) -> None:
        self.attrs["device_s"] = self.device_s
        if self.gap_s is not None:
            self.attrs["gap_s"] = self.gap_s


class DeviceClock:
    """Pending event pairs of one scheduler's timed calls."""

    def __init__(self, source: Any) -> None:
        self.source = source
        self._free: List[Any] = []
        self._pending: Deque[Pair] = collections.deque()
        self._last_end: Any = None   # the last resolved pair's end event

    def _event(self) -> Any:
        ev = self._free.pop() if self._free else self.source.new()
        self.source.record(ev)
        return ev

    def open(self) -> Pair:
        """Record a call's start event. Timed calls do not nest."""
        return Pair(self._event())

    def close(self, pair: Pair) -> None:
        """Record the call's end event; the pair is pending from here."""
        pair.end = self._event()
        self._pending.append(pair)

    def settle(self, pair: Pair, attrs: Dict[str, Any]) -> None:
        """Write the pair's figures into ``attrs`` (its span's attrs,
        which the recorder holds by reference): now if it has resolved,
        else when :meth:`poll` resolves it."""
        pair.attrs = attrs
        if pair.device_s is not None:
            pair._write()

    def poll(self) -> None:
        """Resolve the pending pairs whose end event has completed, in
        order (an earlier event on the stream has completed with it)."""
        while self._pending and self._pending[0].end.query():
            p = self._pending.popleft()
            p.device_s = p.start.elapsed_time(p.end) / 1e3
            if self._last_end is not None:
                p.gap_s = self._last_end.elapsed_time(p.start) / 1e3
                self._free.append(self._last_end)
            self._free.append(p.start)
            self._last_end = p.end
            p.start = p.end = None
            if p.attrs is not None:
                p._write()
