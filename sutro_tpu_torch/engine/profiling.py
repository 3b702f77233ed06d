"""Engine-level profiling.

Host-side step timing that lands in the job record, so every job
reports its own latency profile without external tooling.

- ``StepTimer``: cheap wall-clock histogram of prefill/decode steps;
  summarized as count/mean/p50/p90/p99 milliseconds.

Device traces (the JAX package's ``job_trace`` over ``jax.profiler``)
are not ported yet; ``torch.profiler`` takes their place in a later
slice.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional


class StepTimer:
    """Wall-clock step latencies by phase ("prefill" / "decode").

    ``sink`` (optional) forwards every sample as ``sink(phase, t0,
    seconds)`` the moment it lands — the telemetry layer's single tap
    into ALL device-dispatch phases (scheduler sets it to a span/
    histogram recorder when telemetry is enabled; None costs one
    attribute load per sample)."""

    def __init__(self, sink: Optional[Any] = None) -> None:
        self._samples: Dict[str, List[float]] = {}
        self.sink = sink

    @contextlib.contextmanager
    def time(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self._samples.setdefault(phase, []).append(dt)
            if self.sink is not None:
                self.sink(phase, t0, dt)

    def add(self, phase: str, seconds: float) -> None:
        self._samples.setdefault(phase, []).append(seconds)
        if self.sink is not None:
            self.sink(phase, time.monotonic() - seconds, seconds)

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
