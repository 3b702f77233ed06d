"""The device trace of a ``--trace 1`` run's window, from ``torch.profiler``.

The profiler starts on the harness's thread at the window's open and
stops at its close. A ``record_function`` mark at each end ties the
trace's clock to the host's ``time.perf_counter``, so device operations
can be set beside the harness's spans. Device time is the union of the
operations' intervals (``stepprofile._busy_us``'s arithmetic), so work
on two streams at once counts once.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

MARK = "portbench.mark"


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def union(spans: List[Tuple[float, float]]) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class Tracer:
    """Kineto tracing of the card's operations (and of this thread's CPU
    marks), started and stopped through the autograd profiler's own
    enable and disable calls: the raw events are read once, without the
    per-event Python objects ``torch.profiler.profile`` builds at its
    stop (seconds a hundred thousand kernels)."""

    def __init__(self):
        from torch.autograd import profiler as ap

        self._ap = ap
        p = ap.profile(use_device="cuda" if torch.cuda.is_available() else None,
                       use_kineto=True)
        try:
            self._cfg = p.config(create_trace_id=True)
        except TypeError:
            self._cfg = p.config()
        self._acts = p.kineto_activities
        self.result = None
        self.marks: List[float] = []

    def mark(self) -> float:
        with torch.profiler.record_function(MARK):
            t = time.perf_counter()
        self.marks.append(t)
        return t

    def start(self) -> float:
        self._ap._prepare_profiler(self._cfg, self._acts)
        self._ap._enable_profiler(self._cfg, self._acts)
        return self.mark()

    def stop(self) -> float:
        t = self.mark()
        self.result = self._ap._disable_profiler()
        return t

    def warm(self) -> None:
        """One empty trace: the profiler's own set-up, before the window."""
        self.start()
        self.stop()
        self.marks.clear()
        self.result = None

    def device_ops(self) -> List[Tuple[str, float, float]]:
        """``(name, start, end)`` of every device operation, in host
        ``perf_counter`` seconds, clipped to the traced window."""
        if self.result is None:
            return []
        events = self.result.events()
        marks, ops = [], []
        for ev in events:
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                s = _ns(ev, "start")
                ops.append((ev.name(), s, s + _ns(ev, "duration")))
            elif ev.name() == MARK:
                marks.append(_ns(ev, "start"))
        if not marks or len(marks) != len(self.marks):
            return []
        marks.sort()
        offset = sum(m * 1e-9 - t for m, t in zip(marks, self.marks)) / len(marks)
        lo, hi = self.marks[0], self.marks[-1]
        out = []
        for name, s, e in ops:
            s, e = max(s * 1e-9 - offset, lo), min(e * 1e-9 - offset, hi)
            if e > s:
                out.append((name, s, e))
        return out


def is_kernel(name: str) -> bool:
    return not name.lower().startswith(("memcpy", "memset"))


def gaps(ops: List[Tuple[str, float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Intervals of ``[lo, hi]`` with no device operation running."""
    out, cur = [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def label_gaps(idle: List[Tuple[float, float]], spans: Dict[str, List[Tuple[float, float]]]
               ) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing at each idle stretch's
    middle: inside which of the harness's spans (the first of ``spans``'
    names that holds it: a runner entry, a submit), else ``host:
    scheduler and engine``."""
    index = []
    for name, ss in spans.items():
        ss = sorted(ss)
        index.append((name, [s for s, _ in ss], ss))
    tot: Dict[str, float] = {}
    for a, b in idle:
        mid, label = (a + b) / 2, "host: scheduler and engine"
        for name, starts, ss in index:
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ss[i][1] >= mid:
                label = name
                break
        tot[label] = tot.get(label, 0.0) + (b - a)
    return sorted(tot.items(), key=lambda kv: -kv[1])


def by_name(ops: List[Tuple[str, float, float]], match) -> Optional[float]:
    """Device seconds of the operations whose name ``match`` accepts, or
    None when none ran."""
    spans = [(s, e) for n, s, e in ops if match(n)]
    return union(spans) if spans else None
