"""Engine-level profiling.

The port of ``sutro_tpu/engine/profiling.py``: device traces over
``torch.profiler`` (the JAX package's go through ``jax.profiler``) plus
host-side step timing that lands in the job record, so every job
reports its own latency profile without external tooling.

- ``job_trace(profile_dir, job_id, device)``: context manager capturing
  a trace for the whole job into ``{profile_dir}/{job_id}/trace.json``
  (Chrome trace-event JSON: Perfetto or ``chrome://tracing`` open it)
  when ``EngineConfig.profile_dir`` is set (off by default — tracing
  costs memory and time). On a CUDA device it records the CPU's ops and
  the card's kernels (CUPTI, process-wide: a co-batched job's kernels
  land in the trace); with ``device="cpu"`` the CPU's ops alone.
  ``torch.profiler`` records CPU ops only on the thread that started
  it, so the engine enters it on the thread that drives the job's
  batcher.
- ``StepTimer``: cheap wall-clock histogram of prefill/decode steps;
  summarized as count/mean/p50/p90/p99 milliseconds.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)

#: the file a job's trace is exported to, inside ``{profile_dir}/{job_id}``
TRACE_FILE = "trace.json"

# Kineto runs ONE profiler per process (as jax.profiler holds one
# device trace): two overlapping jobs with profile_dir set must not
# both start one. Refcounted instead — the first job starts the trace,
# later overlapping jobs join it (logged), the last one out stops it.
_trace_lock = threading.Lock()
_trace_state: Dict[str, Any] = {"count": 0, "path": None, "prof": None,
                                "last": None}


def last_trace() -> Optional[Dict[str, Any]]:
    """The last exported trace: ``{"path", "file", "bytes", "export_s"}``
    (``export_s`` the seconds ``export_chrome_trace`` took), or None
    before the first."""
    with _trace_lock:
        last = _trace_state["last"]
        return dict(last) if last is not None else None


def _start(path: str, device: Any) -> Any:
    """A started ``torch.profiler`` for a trace bound for ``path``: the
    CPU's ops (on this thread), and the card's kernels on a CUDA
    ``device``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    logger.info("device trace for %s started (%s)", path, device)
    return prof


def _stop(prof: Any, path: str) -> tuple:
    """Stop the profiler and export its trace to a temporary name
    (under ``_trace_lock``: no other trace starts meanwhile); returns
    what :func:`_publish` needs."""
    prof.stop()
    out = os.path.join(path, TRACE_FILE)
    t0 = time.perf_counter()
    prof.export_chrome_trace(out + ".tmp")
    return path, out, t0


def _publish(path: str, out: str, t0: float) -> None:
    """Rename the exported trace, so ``trace.json`` appears whole or not
    at all, and record it (outside ``_trace_lock`` but the record)."""
    os.replace(out + ".tmp", out)
    export_s = time.perf_counter() - t0
    last = {"path": path, "file": out, "bytes": os.path.getsize(out),
            "export_s": export_s}
    with _trace_lock:
        _trace_state["last"] = last
    logger.info("device trace %s: %d bytes exported in %.2fs", out,
                last["bytes"], export_s)


@contextlib.contextmanager
def job_trace(
    profile_dir: Optional[str], job_id: str, device: Any = "cuda"
) -> Iterator[None]:
    if not profile_dir:
        yield
        return
    with _trace_lock:
        if _trace_state["count"] == 0:
            path = os.path.join(profile_dir, job_id)
            os.makedirs(path, exist_ok=True)
            _trace_state["prof"] = _start(path, device)
            _trace_state["path"] = path
        else:
            logger.info(
                "device trace already running (%s); %s joins it "
                "instead of starting a second trace",
                _trace_state["path"], job_id,
            )
        _trace_state["count"] += 1
        active_path = _trace_state["path"]
    # the job's telemetry document records WHERE its device trace went
    # (its own dir, or the co-batched job's trace it joined)
    from .. import telemetry

    if telemetry.enabled():
        telemetry.job(job_id).attrs["profile_trace"] = active_path
    try:
        yield
    finally:
        exported = None
        with _trace_lock:
            _trace_state["count"] -= 1
            if _trace_state["count"] == 0:
                prof, path = _trace_state["prof"], _trace_state["path"]
                _trace_state["prof"] = _trace_state["path"] = None
                try:
                    exported = _stop(prof, path)
                except Exception:  # noqa: BLE001 — a profiling teardown
                    # must never fail the job
                    logger.warning("device trace stop failed",
                                   exc_info=True)
        if exported is not None:
            try:
                _publish(*exported)
            except OSError:
                logger.warning("device trace rename failed", exc_info=True)


#: the scheduler's phases that enqueue device work: with a clock, each
#: call of one gets a pair of device events (a decode_fetch only waits)
CLOCKED_PHASES = ("prefill", "admit_sample", "decode")


class StepTimer:
    """Wall-clock step latencies by phase ("prefill" / "decode").

    ``sink`` (optional) forwards every sample as ``sink(phase, t0,
    seconds, pair)`` the moment it lands — the telemetry layer's single
    tap into ALL device-dispatch phases (scheduler sets it to a span/
    histogram recorder when telemetry is enabled; None costs one
    attribute load per sample).

    ``clock`` (optional, a ``telemetry.devicetime.DeviceClock``)
    brackets each call of a ``CLOCKED_PHASES`` phase with a pair of
    device events; ``pair`` is that call's pair, to settle on its span
    (None where there is none). Every sample then resolves the pairs
    whose events have completed."""

    def __init__(
        self, sink: Optional[Any] = None, clock: Optional[Any] = None,
    ) -> None:
        self._samples: Dict[str, List[float]] = {}
        self.sink = sink
        self.clock = clock

    @contextlib.contextmanager
    def time(self, phase: str) -> Iterator[None]:
        clock = self.clock if phase in CLOCKED_PHASES else None
        t0 = time.monotonic()
        pair = clock.open() if clock is not None else None
        try:
            yield
        finally:
            if clock is not None:
                clock.close(pair)
            dt = time.monotonic() - t0
            self._samples.setdefault(phase, []).append(dt)
            if self.sink is not None:
                self.sink(phase, t0, dt, pair)
            if self.clock is not None:
                self.clock.poll()

    def add(self, phase: str, seconds: float) -> None:
        self._samples.setdefault(phase, []).append(seconds)
        if self.sink is not None:
            self.sink(phase, time.monotonic() - seconds, seconds, None)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for phase, xs in self._samples.items():
            if not xs:
                continue
            s = sorted(xs)
            n = len(s)

            def pct(p: float) -> float:
                return s[min(int(p * n), n - 1)]

            out[phase] = {
                "count": n,
                "total_s": round(sum(s), 4),
                "mean_ms": round(1e3 * sum(s) / n, 3),
                "p50_ms": round(1e3 * pct(0.50), 3),
                "p90_ms": round(1e3 * pct(0.90), 3),
                "p99_ms": round(1e3 * pct(0.99), 3),
            }
        return out
