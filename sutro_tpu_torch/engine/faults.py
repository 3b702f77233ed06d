"""Deterministic, seeded fault injection + transient-fault retry.

The CRASH_MATRIX era debugged engine failures by hand; this module makes
them injectable, seeded, and assertable in CI (tests/test_chaos.py). A
*fault plan* names engine seams ("sites") and what breaks there; the
engine's job is then to survive what the plan injects — row-level
quarantine, bounded I/O retries with backoff, coordinator liveness —
with every recovery recorded in the job's ``failure_log[]``.

Sites threaded through the engine (see FAILURES.md for the catalog):

====================== ====================================================
site                   where it fires
====================== ====================================================
runner.prefill         ModelRunner prefill dispatch (whole batch)
runner.decode          ModelRunner decode dispatch (whole batch)
runner.embed           ModelRunner embed_batch
row.decode             scheduler token accept, per row (row failure domain)
constrain.compile      lazy-constraint materialization, per row
tokenizer.encode       _GenSession prompt tokenize, per row
jobstore.flush_partial partial-chunk flush (``torn`` writes a torn file)
jobstore.finalize      write_results_streamed
dphost.send            worker result send (``drop`` tears the frame)
dphost.worker_done     worker before its done message (``hang``/``crash``)
dphost.join            elastic worker right after admission — join churn
                       (``crash`` closes the channel first)
dphost.preempt         elastic worker cancel poll: any firing spec requests
                       a preemption drain (``hang`` sleeps first to widen
                       the preempt/steal race); no raise
dphost.steal           elastic coordinator steal planner: a firing spec
                       forces a steal without waiting out
                       SUTRO_DP_STEAL_AFTER; no raise
serving.admit          interactive gateway submit (serving/gateway.py):
                       any raising kind rejects the request with a 503
                       before it touches the scheduler
serving.stream         interactive SSE write loop (server.py), per sent
                       frame: a raising kind mid-stream cancels the
                       request — its slot and KV pages free on the next
                       scheduler iteration, batch jobs unaffected
telemetry.monitor      live SLO monitor (telemetry/monitor.py): fires at
                       the top of every sampler tick AND inside the
                       alert flight-recorder dump (engine/api.py); any
                       raising kind degrades the monitor to disabled —
                       a broken monitor never fails a job
control.admit          control-plane admission (engine/control.py):
                       fires inside every token-bucket draw (batch AND
                       interactive); any raising kind degrades the
                       whole control plane to pass-through — buckets
                       and ladder off, all traffic admitted, a
                       ``control_degraded`` event in the failure logs
                       of in-flight jobs. Never fails a job.
control.actuate        control-plane autotuner (engine/control.py):
                       fires at the top of every monitor-tick
                       actuation; same pass-through degradation as
                       control.admit
prefixstore.lookup     radix prefix-store lookup (scheduler
                       _setup_prefix): any raising kind degrades to a
                       plain cache miss — the job pays full prefill
                       for its shell but NEVER fails, and the store
                       stays live for later jobs
kvtier.demote          tiered-KV demotion (engine/kvtier.py): fires in
                       the synchronous hibernation path AND in the
                       async migration worker. A torn demotion drops
                       the tier entry — the HBM copy (hibernation: the
                       regenerate path) stays authoritative; pages are
                       never freed before the host copy landed
kvtier.promote         tiered-KV promotion (get_page/take_row): a
                       raising kind retries ONCE, then degrades to a
                       miss — the caller re-prefills the tokens it
                       asked for (resume falls back to regenerate)
kvtier.disk_write      host->disk spill (``torn`` lands a truncated
                       npz bundle at its final name, quarantined at
                       read time): the host copy stays authoritative —
                       a failed spill never loses the entry
fleet.probe            fleet router health probe (fleet/health.py), per
                       probe attempt; ``job=`` matches the replica id.
                       A raising kind counts as a probe failure and
                       drives the per-replica circuit breaker —
                       deterministic breaker/flap chaos without killing
                       the replica process
fleet.route            fleet router replica pick (fleet/router.py): a
                       raising kind fails the chosen replica for this
                       request only, forcing the pre-first-token
                       transparent-retry path onto another replica
fleet.replica_crash    replica-side (server.py): at request dispatch
                       AND per streamed frame inside the SSE/progress
                       loops. A firing spec closes the connection
                       abruptly WITHOUT a terminal frame and shuts the
                       HTTP server down — the daemon acts dead, the
                       router's breaker + jobstore failover must absorb
                       it (``job=`` matches the request path / id)
====================== ====================================================

Kinds: ``error`` (RuntimeError), ``oom`` (RESOURCE_EXHAUSTED-shaped
RuntimeError), ``ioerror`` (OSError), ``torn`` (site-cooperative torn
write, then OSError), ``drop`` (site-cooperative torn frame, then
OSError), ``hang`` (sleep ``delay`` seconds), ``crash`` (hard stop —
site closes its channel first).

Activation: per-job via ``EngineConfig.fault_plan`` or the
``SUTRO_FAULT_PLAN`` environment variable. The plan is a compact DSL —
semicolon-separated clauses ``site:kind[:key=value[,key=value...]]`` —
or a JSON list of clause objects. Matchers per clause:

- ``rows=3|7``     only these row ids (pipe-separated)
- ``job=substr``   only jobs whose id contains ``substr``
- ``nth=N``        arm on the N-th matching invocation (1-based)
- ``times=N``      fire at most N times (default: unlimited)
- ``p=0.1``        fire with probability p — DETERMINISTIC, derived from
  (seed, site, invocation count), so a given plan replays identically
- ``delay=S``      sleep length for ``hang`` (default 60)

Seed via a leading ``seed=N;`` clause (default 0). Example::

    SUTRO_FAULT_PLAN='row.decode:error:rows=3;jobstore.flush_partial:ioerror:times=2'

Zero overhead when disabled: every call site guards on the module-global
``ACTIVE is None`` — one load and one comparison, no call.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class InjectedFault(RuntimeError):
    """Base class for injected faults (kind ``error``)."""

    def __init__(self, site: str, kind: str, detail: str = ""):
        self.site = site
        self.kind = kind
        super().__init__(
            f"injected fault at {site} ({kind})"
            + (f": {detail}" if detail else "")
        )


class SimulatedOOM(InjectedFault):
    """Shaped like a device RESOURCE_EXHAUSTED error (kind ``oom``)."""

    def __init__(self, site: str):
        super().__init__(site, "oom", "RESOURCE_EXHAUSTED: simulated "
                         "out of memory allocating device buffer")


class InjectedIOError(OSError):
    """Injected I/O failure (kinds ``ioerror`` / ``torn``) — an OSError
    so the transient-retry policy treats it exactly like a real one."""

    def __init__(self, site: str, kind: str = "ioerror"):
        self.site = site
        self.kind = kind
        super().__init__(f"injected {kind} at {site}")


@dataclasses.dataclass
class FaultSpec:
    """One clause of a fault plan. Mutable counters are plan-locked."""

    site: str
    kind: str = "error"
    rows: Optional[frozenset] = None     # row ids; None = any row
    job: Optional[str] = None            # substring of job id; None = any
    nth: Optional[int] = None            # arm on the nth matching call
    times: float = math.inf              # max fires
    p: float = 1.0                       # deterministic fire probability
    delay: float = 60.0                  # hang duration (seconds)
    # -- counters (guarded by the plan lock) --
    calls: int = 0
    fires: int = 0

    def trigger(self) -> None:
        """Raise (or sleep) for this spec's kind. Sites with
        kind-specific behavior (``torn``, ``drop``, ``crash``) act
        first, then call this for the terminal raise."""
        if self.kind == "hang":
            time.sleep(self.delay)
            return
        if self.kind == "oom":
            raise SimulatedOOM(self.site)
        if self.kind in ("ioerror", "torn"):
            raise InjectedIOError(self.site, self.kind)
        if self.kind == "drop":
            raise InjectedIOError(self.site, "drop")
        raise InjectedFault(self.site, self.kind)


class FaultPlan:
    """A parsed, seeded set of fault specs with deterministic matching."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = specs
        self.seed = seed
        self._lock = threading.Lock()

    def fire(
        self, site: str, row: Optional[int] = None,
        job: Optional[str] = None,
    ) -> Optional[FaultSpec]:
        """Consume and return the first spec firing at this invocation,
        else None. Deterministic: counters and the seeded probability
        hash are the only state."""
        with self._lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.rows is not None and (
                    row is None or int(row) not in spec.rows
                ):
                    continue
                if spec.job is not None and (
                    job is None or spec.job not in str(job)
                ):
                    continue
                spec.calls += 1
                if spec.fires >= spec.times:
                    continue
                if spec.nth is not None and spec.calls < spec.nth:
                    continue
                if spec.p < 1.0:
                    # deterministic per-invocation draw in [0, 1)
                    h = zlib.crc32(
                        f"{self.seed}:{site}:{spec.calls}".encode()
                    )
                    if (h / 2**32) >= spec.p:
                        continue
                spec.fires += 1
                return spec
        return None


# -- plan parsing ------------------------------------------------------


def _parse_clause(d: Dict[str, Any]) -> FaultSpec:
    rows = d.get("rows")
    if isinstance(rows, str):
        rows = [int(x) for x in rows.split("|") if x != ""]
    return FaultSpec(
        site=str(d["site"]),
        kind=str(d.get("kind", "error")),
        rows=frozenset(int(r) for r in rows) if rows is not None else None,
        job=d.get("job"),
        nth=int(d["nth"]) if d.get("nth") is not None else None,
        times=float(d["times"]) if d.get("times") is not None else math.inf,
        p=float(d.get("p", 1.0)),
        delay=float(d.get("delay", 60.0)),
    )


def parse_plan(spec: str) -> FaultPlan:
    """Parse the DSL (or a JSON clause list) into a FaultPlan. Raises
    ValueError on malformed input — a mistyped plan must fail loudly,
    not silently inject nothing."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty fault plan")
    if spec[0] in "[{":
        data = json.loads(spec)
        if isinstance(data, dict):
            seed = int(data.get("seed", 0))
            clauses = data.get("faults", [])
        else:
            seed, clauses = 0, data
        return FaultPlan([_parse_clause(c) for c in clauses], seed=seed)
    seed = 0
    specs: List[FaultSpec] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[len("seed="):])
            continue
        parts = clause.split(":")
        if len(parts) > 3:
            raise ValueError(f"malformed fault clause {clause!r}")
        d: Dict[str, Any] = {"site": parts[0].strip()}
        if len(parts) > 1:
            d["kind"] = parts[1].strip()
        if len(parts) > 2:
            for kv in parts[2].split(","):
                if not kv.strip():
                    continue
                k, _, v = kv.partition("=")
                if not _:
                    raise ValueError(
                        f"malformed fault option {kv!r} in {clause!r}"
                    )
                d[k.strip()] = v.strip()
        specs.append(_parse_clause(d))
    return FaultPlan(specs, seed=seed)


# -- module-global activation ------------------------------------------
#
# ACTIVE is the single hot-path switch: call sites guard with
# ``if faults.ACTIVE is not None`` so the disabled engine pays one
# global load + comparison per site, nothing else.

ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    global ACTIVE
    ACTIVE = plan
    return plan


def clear() -> None:
    install(None)


def configure(spec: Optional[str] = None) -> Optional[FaultPlan]:
    """Activate (or clear) the process fault plan: explicit ``spec``
    wins, else ``SUTRO_FAULT_PLAN``, else disabled. Called by
    LocalEngine at construction so per-job activation is just 'build
    the engine with EngineConfig.fault_plan set'."""
    if spec is None:
        spec = os.environ.get("SUTRO_FAULT_PLAN")
    if not spec:
        return install(None)
    plan = parse_plan(spec)
    logger.warning(
        "fault injection ACTIVE: %d clause(s), seed=%d",
        len(plan.specs), plan.seed,
    )
    return install(plan)


def fire(
    site: str, row: Optional[int] = None, job: Optional[str] = None
) -> Optional[FaultSpec]:
    """Consume a matching spec without raising — for sites that act on
    the kind themselves (torn writes, frame drops) before triggering."""
    plan = ACTIVE
    if plan is None:
        return None
    spec = plan.fire(site, row=row, job=job)
    if spec is not None:
        # count OUTSIDE the plan lock; imported lazily so the zero-
        # overhead guarantee for plan-off engines never pays an import
        from .. import telemetry

        if telemetry.ENABLED:
            telemetry.FAULTS_INJECTED_TOTAL.inc(1.0, site)
    return spec


def inject(
    site: str, row: Optional[int] = None, job: Optional[str] = None
) -> None:
    """Fire-and-raise helper for sites with no kind-specific behavior."""
    spec = fire(site, row=row, job=job)
    if spec is not None:
        spec.trigger()


# -- transient-fault retry policy --------------------------------------


def backoff_delay(
    attempt: int, base: float, cap: float, key: str = ""
) -> float:
    """Exponential backoff with deterministic jitter: base * 2^attempt
    capped at ``cap``, scaled by a [0.5, 1.5) factor derived from
    (key, attempt) — reproducible runs, no thundering herd."""
    delay = min(base * (2.0 ** attempt), cap)
    jitter = zlib.crc32(f"{key}:{attempt}".encode()) / 2**32
    return delay * (0.5 + jitter)


def retry_transient(
    fn: Callable[[], Any],
    *,
    attempts: int = 4,
    base: float = 0.05,
    cap: float = 2.0,
    retry_on: Tuple[type, ...] = (OSError,),
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    what: str = "operation",
) -> Any:
    """Run ``fn`` with BOUNDED retries and exponential backoff + jitter
    on transient failures. ``on_retry(attempt, delay, exc)`` fires
    before each sleep (the failure_log hook). The final failure
    re-raises — a persistent fault stays a fault, just a slower one."""
    attempts = max(1, int(attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt + 1 >= attempts:
                raise
            from .. import telemetry

            if telemetry.ENABLED:
                # label = the operation class, never the bracketed job
                # id (fixed cardinality)
                telemetry.IO_RETRIES_TOTAL.inc(
                    1.0, what.split("[", 1)[0]
                )
            delay = backoff_delay(attempt, base, cap, key=what)
            if on_retry is not None:
                try:
                    on_retry(attempt + 1, delay, e)
                except Exception:
                    logger.warning(
                        "retry observer failed for %s", what, exc_info=True
                    )
            logger.warning(
                "%s failed (attempt %d/%d, retrying in %.3fs): %s",
                what, attempt + 1, attempts, delay, e,
            )
            time.sleep(delay)
    raise AssertionError("unreachable")  # attempts >= 1 always returns/raises
