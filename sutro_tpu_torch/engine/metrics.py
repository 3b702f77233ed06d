"""Progress/token metrics bus.

A copy of ``sutro_tpu/engine/metrics.py``: the engine-side producer of
the Sutro SDK's NDJSON progress protocol — ``{"update_type":
"progress", "result": <rows_done>}`` and ``{"update_type": "tokens",
"result": {input_tokens, output_tokens,
total_tokens_processed_per_second}}``. The bus is an in-process,
thread-safe pub/sub keyed by job id, with history retained so a late
``attach`` sees current totals immediately. Token updates may be
partial dicts — consumers must merge monotonically — and the bus
preserves that contract.

Delivery is CONFLATING: each subscriber holds at most one pending
update per update_type (progress keeps the max, token dicts merge), so
a producer's publish is O(subscribers) pointer work regardless of how
far behind a consumer is, and a slow consumer's backlog is O(1) instead
of an unbounded queue. Consumers see every MONOTONIC milestone
coalesced, not every intermediate value.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from .stageframes import stage_progress_frame


class _Sub:
    """One subscriber's conflated mailbox (O(1) pending state)."""

    __slots__ = ("cond", "progress", "tokens", "stages", "done")

    def __init__(self, cond: threading.Condition) -> None:
        self.cond = cond
        self.progress: Optional[int] = None
        self.tokens: Optional[Dict[str, Any]] = None
        # stage-graph per-stage rollup: conflates by dict-merge keyed on
        # stage name (each stage's entry replaces wholesale — per-stage
        # counts are monotonic, so latest-wins is the milestone contract)
        self.stages: Optional[Dict[str, Any]] = None
        self.done = False


class JobMetrics:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.latest_tokens: Dict[str, Any] = {}
        self.latest_stages: Dict[str, Any] = {}
        self.rows_completed = 0
        self.done = False
        self._subscribers: List[_Sub] = []

    def progress(self, rows_completed: int) -> None:
        with self.lock:
            self.rows_completed = rows_completed
            for s in self._subscribers:
                # conflate: later counts replace (progress is monotonic)
                if s.progress is None or rows_completed > s.progress:
                    s.progress = rows_completed
                s.cond.notify_all()

    def tokens(self, result: Dict[str, Any]) -> None:
        with self.lock:
            self.latest_tokens.update(result)
            for s in self._subscribers:
                if s.tokens is None:
                    s.tokens = dict(result)
                else:  # partial dicts merge monotonically (contract)
                    s.tokens.update(result)
                s.cond.notify_all()

    def stages(self, result: Dict[str, Any]) -> None:
        """Publish a per-stage progress rollup ``{stage_name: {...}}``.

        Conflating like :meth:`tokens` — a slow NDJSON consumer sees the
        freshest per-stage counters, not every intermediate chunk."""
        with self.lock:
            self.latest_stages.update(result)
            for s in self._subscribers:
                if s.stages is None:
                    s.stages = dict(result)
                else:
                    s.stages.update(result)
                s.cond.notify_all()

    def finish(self) -> None:
        with self.lock:
            self.done = True
            for s in self._subscribers:
                s.done = True
                s.cond.notify_all()

    def subscribe(self) -> Iterator[Dict[str, Any]]:
        """Yields updates until the job finishes. Starts with a snapshot of
        current totals so mid-run attach shows correct state. Pending
        updates drain before the done sentinel is honored, so the final
        progress count is always delivered."""
        cond = threading.Condition(self.lock)
        sub = _Sub(cond)
        with self.lock:
            snapshot_rows = self.rows_completed
            snapshot_tokens = dict(self.latest_tokens)
            snapshot_stages = dict(self.latest_stages)
            already_done = self.done
            self._subscribers.append(sub)
        try:
            yield {"update_type": "progress", "result": snapshot_rows}
            if snapshot_tokens:
                yield {"update_type": "tokens", "result": snapshot_tokens}
            if snapshot_stages:
                # typed wire frame (engine/stageframes.py): carries
                # update_type so pre-stage-graph readers skip it
                yield stage_progress_frame(snapshot_stages)
            if already_done:
                return
            while True:
                with self.lock:
                    while (
                        sub.progress is None
                        and sub.tokens is None
                        and sub.stages is None
                        and not sub.done
                    ):
                        cond.wait()
                    prog, toks, done = sub.progress, sub.tokens, sub.done
                    stgs = sub.stages
                    sub.progress = None
                    sub.tokens = None
                    sub.stages = None
                if prog is not None:
                    yield {"update_type": "progress", "result": prog}
                if toks is not None:
                    yield {"update_type": "tokens", "result": toks}
                if stgs is not None:
                    yield stage_progress_frame(stgs)
                if done:
                    return
        finally:
            with self.lock:
                if sub in self._subscribers:
                    self._subscribers.remove(sub)


class BatchedProgress:
    """Row-progress publisher batched by completion count — THE one
    batching rule for both the embedding and generation paths (the
    embedding loop used to hand-roll this; a 1M-row job must not pay
    one bus publish per row). ``update`` publishes at most once per
    ``every_rows`` completions; ``flush`` publishes unconditionally
    (terminal counts must always land)."""

    def __init__(self, jm: JobMetrics, every_rows: int) -> None:
        self.jm = jm
        self.every = max(int(every_rows), 1)
        self._last = -1

    def update(self, rows_completed: int) -> None:
        if rows_completed - self._last >= self.every:
            self._last = rows_completed
            self.jm.progress(rows_completed)

    def flush(self, rows_completed: int) -> None:
        self._last = rows_completed
        self.jm.progress(rows_completed)


class MetricsBus:
    def __init__(self) -> None:
        self._jobs: Dict[str, JobMetrics] = {}
        self._lock = threading.Lock()

    def job(self, job_id: str) -> JobMetrics:
        with self._lock:
            if job_id not in self._jobs:
                self._jobs[job_id] = JobMetrics()
            return self._jobs[job_id]

    def drop(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)


class Throughput:
    """Per-device tokens/sec estimator.

    The clock anchors at :meth:`start` — implicitly the first
    :meth:`add`/:meth:`note_total` — NOT at construction: a session
    builds its estimator before tokenize/compile/prefill, and counting
    that dead time deflated early readings after a long compile (the
    rate then crept up for the whole job instead of being honest from
    the first window)."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(n_chips, 1)
        self.t0: "float | None" = None
        self.total = 0
        self._base = 0  # total already accounted when the clock anchored

    def start(self) -> None:
        """Anchor the rate clock now (idempotent)."""
        if self.t0 is None:
            self.t0 = time.monotonic()

    def add(self, tokens: int) -> None:
        self.start()
        self.total += tokens

    def note_total(self, total: int) -> None:
        """Replace the running total with an externally accounted
        cumulative count (the progress stream's in+out totals). The
        first report anchors the clock AND the baseline, so the rate
        measures tokens per second *since the anchor* instead of
        dividing a pre-anchor backlog by epsilon."""
        if self.t0 is None:
            self.start()
            self._base = int(total)
        self.total = int(total)

    def per_second(self) -> float:
        if self.t0 is None:
            return 0.0
        return (self.total - self._base) / max(
            time.monotonic() - self.t0, 1e-9
        )

    def per_chip_per_second(self) -> float:
        return self.per_second() / self.n_chips
