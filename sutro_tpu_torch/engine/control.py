"""SLO enforcement control plane: the actuator half of the monitor.

The port of ``sutro_tpu/engine/control.py``, line for line. The live
monitor (``telemetry/monitor.py``) is the *measurement* half — windowed
SLO rules with hysteresis, streamed doctor verdicts, per-tenant
attribution. This module closes the loop with three actuators:

1. **Per-tenant token-bucket admission.** Batch submits and
   interactive requests draw rows/tokens from per-``(tenant,
   priority)`` buckets sized off the jobstore quota tables. An empty
   bucket means 429/``QUOTA_EXCEEDED`` for interactive traffic and a
   *bounded* wait (then the same rejection) for batch submits.
   Terminal accounting refunds the unused part of a batch reserve, so
   a job that fails early does not burn its tenant's budget.

2. **Preemptive priority ladder** (``PriorityLadder``), generalizing
   the scheduler's ``_evict_for_interactive``: when a higher-priority
   job cannot admit, the scheduler may suspend a *lower*-priority
   job's decode rows through the paged-KV suspend/resume path.
   Anti-starvation aging promotes a waiting job one level per
   ``aging`` seconds, and a near soft-deadline (softdeadline.py)
   vetoes new preemptions — a suspended row that cannot resume before
   the watchdog fires would be lost work.

3. **Closed-loop autotuner.** Consumes each monitor tick (stats,
   alert transitions, doctor verdicts) and adjusts
   ``interactive_slots`` (live — the batcher reads it per admission)
   and ``decode_batch_size`` (next engine session — the batcher
   snapshots it at construction) in bounded steps with the same
   sustain/cooldown hysteresis shape as the SLO rules. Every move
   lands in a bounded audit trail and the
   ``sutro_autotune_adjustments_total`` counter.

Contract (mirrors faults.py / monitor.py):
- **Zero cost when off.** ``SUTRO_CONTROL=0`` / ``EngineConfig.control
  = None`` means the engine never constructs a ControlPlane; every
  hot-path hook is a ``None`` check. Batch results are bit-identical.
- **Degrades, never fails a job.** Any controller exception —
  including the injected fault sites ``control.admit`` and
  ``control.actuate`` — flips the plane to pass-through (buckets and
  ladder disabled), records a ``control_degraded`` event in the
  failure logs of in-flight jobs, and lets all traffic through.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import faults, softdeadline

logger = logging.getLogger("sutro.control")

# submit rejections carry this marker (the quota semantics); the
# HTTP layers map it to 429
QUOTA_EXCEEDED = "QUOTA_EXCEEDED"

# seconds of soft-deadline headroom below which the ladder stops
# preempting: a suspended row needs the preemptor to finish before it
# can resume, and a process about to unwind cannot promise that
DEADLINE_GUARD_S = 30.0


def resolve_spec(config_control: Optional[str]) -> Optional[str]:
    """THE enablement rule: $SUTRO_CONTROL overrides when set (empty /
    "0" / "off" / "false" force OFF), else EngineConfig.control; None
    means the engine never constructs a ControlPlane."""
    import os

    env = os.environ.get("SUTRO_CONTROL")
    if env is not None:
        if env.strip().lower() in ("", "0", "off", "false", "none"):
            return None
        return env
    spec = config_control
    if spec is None or not str(spec).strip():
        return None
    if str(spec).strip().lower() in ("0", "off", "false", "none"):
        return None
    return str(spec)


@dataclasses.dataclass
class ControlConfig:
    """Parsed ``k=v,...`` control spec ("1"/"on"/"all" = defaults)."""

    window_s: float = 60.0      # bucket refill window: capacity/window
                                # is the sustained per-tenant rate
    quota_divisor: float = 1000.0  # default bucket capacity per window
                                # = per-job quota / this (quota tables
                                # are per-SUBMIT caps; the bucket is a
                                # sustained-rate limit)
    rows: Optional[float] = None    # absolute row capacity per window
                                    # (overrides the quota derivation)
    tokens: Optional[float] = None  # absolute token capacity per window
    wait_s: float = 2.0         # bounded-wait backpressure budget for
                                # batch submits (interactive never waits)
    itokens: float = 2048.0     # token reserve drawn per interactive
                                # request (coarse: prompt+completion
                                # are unknown at admission)
    aging_s: float = 30.0       # anti-starvation: a waiting job gains
                                # one priority level per this many
                                # seconds
    sustain: int = 2            # autotuner: ticks a signal must persist
                                # before acting (mirrors rule for_ticks)
    cooldown: int = 3           # autotuner: quiet ticks after a move
    settle: int = 5             # autotuner: signal-free ticks before
                                # stepping a knob back toward baseline
    slots_boost: int = 4        # max interactive_slots above baseline

    _KEYS = {
        "window": "window_s",
        "divisor": "quota_divisor",
        "rows": "rows",
        "tokens": "tokens",
        "wait": "wait_s",
        "itokens": "itokens",
        "aging": "aging_s",
        "sustain": "sustain",
        "cooldown": "cooldown",
        "settle": "settle",
        "slots_boost": "slots_boost",
    }

    @classmethod
    def parse(cls, spec: str) -> "ControlConfig":
        cfg = cls()
        body = spec.strip().lower()
        if body in ("1", "on", "true", "all", "default"):
            return cfg
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"control spec clause {part!r} is not k=v "
                    f"(known keys: {sorted(cls._KEYS)})"
                )
            k, v = part.split("=", 1)
            field = cls._KEYS.get(k.strip())
            if field is None:
                raise ValueError(
                    f"unknown control spec key {k.strip()!r} "
                    f"(known: {sorted(cls._KEYS)})"
                )
            cur = getattr(cfg, field)
            if isinstance(cur, int) and not isinstance(cur, bool):
                setattr(cfg, field, int(float(v)))
            else:
                setattr(cfg, field, float(v))
        return cfg


class TokenBucket:
    """Continuous-refill token bucket (monotonic clock, caller locks)."""

    __slots__ = ("capacity", "rate", "level", "_t")

    def __init__(self, capacity: float, window_s: float) -> None:
        self.capacity = max(1.0, float(capacity))
        self.rate = self.capacity / max(1e-6, float(window_s))
        self.level = self.capacity
        self._t = time.monotonic()

    def _refill(self, now: float) -> None:
        if now > self._t:
            self.level = min(
                self.capacity, self.level + (now - self._t) * self.rate
            )
        self._t = now

    def try_take(self, n: float, now: float) -> bool:
        self._refill(now)
        if self.level >= n:
            self.level -= n
            return True
        return False

    def time_until(self, n: float, now: float) -> float:
        """Seconds until ``n`` tokens could be taken (inf if n exceeds
        capacity — no wait will ever satisfy it)."""
        self._refill(now)
        if self.level >= n:
            return 0.0
        if n > self.capacity:
            return float("inf")
        return (n - self.level) / self.rate

    def put(self, n: float) -> None:
        self.level = min(self.capacity, self.level + n)


class PriorityLadder:
    """Scheduler-facing view of the preemption policy.

    The scheduler owns slot mechanics (it reuses the exact
    ``_evict_for_interactive`` unreserve/re-admit recipe); this class
    owns the *policy*: who may preempt whom, with anti-starvation
    aging and the soft-deadline veto."""

    def __init__(self, plane: "ControlPlane") -> None:
        self._plane = plane
        self._cfg = plane.cfg
        # first time each JobCtx.seq asked for admission — the aging
        # clock. Bounded: entries die with the batcher.
        self._first_seen: Dict[int, float] = {}

    def active(self) -> bool:
        return self._plane.enabled

    def effective_priority(self, ctx: Any, now: float) -> int:
        """Nominal priority minus one level per ``aging_s`` waited —
        an old P2 job eventually outranks a fresh P0 flood."""
        first = self._first_seen.setdefault(ctx.seq, now)
        aged = int((now - first) / max(1e-6, self._cfg.aging_s))
        return int(ctx.priority) - aged

    def may_preempt(self, preemptor: Any, victim: Any, now: float) -> bool:
        """True when ``preemptor`` (a JobCtx needing a slot) outranks
        ``victim`` (a JobCtx holding decode rows). Interactive ctxs
        (priority < 0) are handled by ``_evict_for_interactive`` and
        excluded on both sides here."""
        if not self._plane.enabled:
            return False
        if preemptor.priority < 0 or victim.priority < 0:
            return False
        rem = softdeadline.remaining_s()
        if rem is not None and rem < DEADLINE_GUARD_S:
            return False
        return self.effective_priority(
            preemptor, now
        ) < self.effective_priority(victim, now)

    def record(self, preemptor: Any, victim: Any) -> None:
        """Count one suspended row (telemetry + audit)."""
        self._plane.note_preemption(
            int(preemptor.priority), int(victim.priority)
        )

    def forget(self, ctx: Any) -> None:
        """Drop the aging entry once a job fully drains."""
        self._first_seen.pop(ctx.seq, None)


def _prio_label(p: int) -> str:
    """Bounded label domain for priority metrics: the ladder lives in a
    small integer window; anything outside collapses to one series so a
    caller passing arbitrary ints can't mint unbounded label values."""
    return str(int(p)) if -1 <= int(p) <= 8 else "other"


class ControlPlane:
    """Admission buckets + ladder policy + autotuner, one per engine."""

    def __init__(
        self,
        spec: str,
        *,
        ecfg: Any,
        jobs: Any = None,
        jobs_provider: Optional[
            Callable[[], List[Tuple[str, str]]]
        ] = None,
        tier_pools: Optional[Callable[[], List[Any]]] = None,
    ) -> None:
        self.cfg = ControlConfig.parse(spec)
        self.ecfg = ecfg
        self.jobs = jobs
        self._jobs_provider = jobs_provider
        self.enabled = True
        self.degraded_reason: Optional[str] = None
        self._lock = threading.Lock()
        # (tenant, priority_index) -> {"rows": bucket, "tokens": bucket}
        self._buckets: Dict[Tuple[str, int], Dict[str, TokenBucket]] = {}
        # job_id -> (tenant, prio_idx, rows_drawn, tokens_drawn): the
        # outstanding reserve, settled (refunded) at terminal status
        self._drawn: Dict[str, Tuple[str, int, float, float]] = {}
        self.ladder = PriorityLadder(self)
        # -- autotuner state ------------------------------------------
        self._base_slots = int(getattr(ecfg, "interactive_slots", 0))
        self._base_batch = int(getattr(ecfg, "decode_batch_size", 64))
        self._batch_step = max(8, self._base_batch // 4)
        # kv_tier_host_pages: bounded-notch growth off the doctor's
        # kv_pressure verdict. New pools read the knob from ecfg at
        # construction; live pools are pushed through ``tier_pools``.
        self._tier_pools = tier_pools
        self._base_kv_pages = int(
            getattr(ecfg, "kv_tier_host_pages", 4096)
        )
        self._kv_step = max(256, self._base_kv_pages // 4)
        self._sustain: Dict[str, int] = {}
        self._quiet = 0
        self._cooldown = 0
        self._audit: deque = deque(maxlen=128)
        self._audit_seq = 0
        self._rejections = 0
        self._preemptions = 0

    # -- degradation ---------------------------------------------------

    def _degrade(
        self, site: str, exc: BaseException,
        job_id: Optional[str] = None,
    ) -> None:
        """Pass-through, never fail a job: disable every actuator and
        leave a trail in the failure logs of the triggering job (when
        there is one) and every in-flight job."""
        self.enabled = False
        self.degraded_reason = f"{site}: {type(exc).__name__}: {exc}"
        logger.warning(
            "control plane degraded to pass-through at %s: %s",
            site, exc, exc_info=True,
        )
        if self.jobs is None:
            return
        targets = [] if job_id is None else [job_id]
        if self._jobs_provider is not None:
            try:
                targets.extend(
                    jid for jid, _status in self._jobs_provider()
                    if jid != job_id
                )
            except Exception as list_exc:  # noqa: BLE001
                logger.debug(
                    "control degradation trail: job listing failed: %s",
                    list_exc,
                )
        for jid in targets:
            try:
                self.jobs.append_failure_log(
                    jid,
                    {
                        "event": "control_degraded",
                        "site": site,
                        "error": f"{type(exc).__name__}: {exc}",
                    },
                )
            except Exception as log_exc:  # noqa: BLE001
                logger.debug(
                    "control degradation trail: %s: %s", jid, log_exc,
                )

    # -- admission -----------------------------------------------------

    def _bucket(
        self, tenant: str, prio_idx: int
    ) -> Dict[str, TokenBucket]:
        key = (tenant, prio_idx)
        b = self._buckets.get(key)
        if b is None:
            from .jobstore import DEFAULT_QUOTAS

            quotas = (
                self.jobs.get_quotas()
                if self.jobs is not None
                else [dict(q) for q in DEFAULT_QUOTAS]
            )
            q = quotas[min(max(prio_idx, 0), len(quotas) - 1)]
            cfg = self.cfg
            rows_cap = (
                cfg.rows
                if cfg.rows is not None
                else max(
                    1.0, float(q["row_quota"]) / cfg.quota_divisor
                )
            )
            tok_cap = (
                cfg.tokens
                if cfg.tokens is not None
                else max(
                    1.0, float(q["token_quota"]) / cfg.quota_divisor
                )
            )
            b = {
                "rows": TokenBucket(rows_cap, cfg.window_s),
                "tokens": TokenBucket(tok_cap, cfg.window_s),
            }
            self._buckets[key] = b
        return b

    def _reject_msg(
        self, tenant: str, what: str, need: float, wait_s: float
    ) -> str:
        return (
            f"{QUOTA_EXCEEDED}: tenant {tenant!r} {what} bucket empty "
            f"(need {need:g}, sustained rate exhausted; retry after "
            f"~{max(0.1, wait_s):.1f}s)"
        )

    def admit_batch(
        self,
        tenant: str,
        priority: int,
        rows: int,
        tokens: float,
        job_id: Optional[str] = None,
    ) -> Optional[str]:
        """Draw a batch submit's reserve from the tenant's buckets.

        Returns None on admit, else a ``QUOTA_EXCEEDED`` message. A
        draw that would succeed after a short refill waits for it —
        bounded by ``wait_s`` and the armed soft deadline — so bursty
        batch traffic sees backpressure before rejection."""
        if not self.enabled:
            return None
        try:
            faults.inject("control.admit", job=job_id)
            now = time.monotonic()
            need_rows = float(max(1, rows))
            need_tok = float(max(0, tokens))
            deadline = now + self._wait_budget()
            while True:
                with self._lock:
                    b = self._bucket(tenant, max(0, int(priority)))
                    row_wait = b["rows"].time_until(need_rows, now)
                    tok_wait = b["tokens"].time_until(need_tok, now)
                    wait = max(row_wait, tok_wait)
                    if wait <= 0.0:
                        b["rows"].try_take(need_rows, now)
                        b["tokens"].try_take(need_tok, now)
                        if job_id is not None:
                            self._drawn[job_id] = (
                                tenant, max(0, int(priority)),
                                need_rows, need_tok,
                            )
                        return None
                if now + wait > deadline:
                    self._count_rejection(tenant)
                    short = "row" if row_wait >= tok_wait else "token"
                    return self._reject_msg(
                        tenant, short,
                        need_rows if short == "row" else need_tok,
                        wait,
                    )
                time.sleep(min(wait, 0.05))
                now = time.monotonic()
        except Exception as e:  # noqa: BLE001 — pass-through contract
            self._degrade("control.admit", e, job_id=job_id)
            return None

    def admit_interactive(self, tenant: str) -> Optional[str]:
        """Latency-sensitive admission: one row + a coarse token
        reserve, no waiting — an empty bucket is an immediate 429."""
        if not self.enabled:
            return None
        try:
            faults.inject("control.admit", job=f"interactive:{tenant}")
            now = time.monotonic()
            with self._lock:
                b = self._bucket(tenant, 0)
                wait = max(
                    b["rows"].time_until(1.0, now),
                    b["tokens"].time_until(self.cfg.itokens, now),
                )
                if wait <= 0.0:
                    b["rows"].try_take(1.0, now)
                    b["tokens"].try_take(self.cfg.itokens, now)
                    return None
            self._count_rejection(tenant)
            return self._reject_msg(tenant, "interactive", 1.0, wait)
        except Exception as e:  # noqa: BLE001 — pass-through contract
            self._degrade("control.admit", e)
            return None

    def _wait_budget(self) -> float:
        budget = max(0.0, self.cfg.wait_s)
        rem = softdeadline.remaining_s()
        if rem is not None:
            # leave the guard window intact: waiting into the deadline
            # would trade a quota rejection for a dead process
            budget = min(budget, max(0.0, rem - DEADLINE_GUARD_S))
        return budget

    def on_terminal(self, rec: Any) -> None:
        """Terminal-accounting refill (called from JobStore.set_status
        via the ``on_terminal`` hook): give back the unused part of
        the reserve — all of it for a job that never ran, the
        token overage for one that finished under its estimate."""
        if not self.enabled:
            return
        try:
            drawn = self._drawn.pop(rec.job_id, None)
            if drawn is None:
                return
            tenant, prio_idx, rows, tokens = drawn
            status = getattr(rec, "status", "")
            used_tok = float(
                (getattr(rec, "input_tokens", 0) or 0)
                + (getattr(rec, "output_tokens", 0) or 0)
            )
            with self._lock:
                b = self._bucket(tenant, prio_idx)
                if status in ("FAILED", "CANCELLED") and used_tok <= 0:
                    # never ran: full refund, rows included
                    b["rows"].put(rows)
                    b["tokens"].put(tokens)
                elif used_tok < tokens:
                    b["tokens"].put(tokens - used_tok)
        except Exception as e:  # noqa: BLE001 — the terminal funnel
            # must never see a control error
            self._degrade("control.admit", e)

    def _count_rejection(self, tenant: str) -> None:
        self._rejections += 1
        from .. import telemetry

        if telemetry.ENABLED:
            telemetry.ADMISSION_REJECTIONS_TOTAL.inc(1.0, tenant)

    def note_preemption(self, from_prio: int, to_prio: int) -> None:
        self._preemptions += 1
        from .. import telemetry

        if telemetry.ENABLED:
            telemetry.PREEMPTIONS_TOTAL.inc(
                1.0, _prio_label(from_prio), _prio_label(to_prio)
            )

    # -- autotuner -----------------------------------------------------

    def on_monitor_tick(
        self,
        stats: Dict[str, Any],
        transitions: List[Dict[str, Any]],
        verdicts: Optional[Dict[str, Dict[str, Any]]],
        firing: List[str],
    ) -> None:
        """One closed-loop step, driven by the monitor's sampler.

        Inputs are the monitor's own artifacts: windowed stats, alert
        transitions, live doctor verdicts, and the currently-firing
        rule names. Hysteresis mirrors the SLO rules — act only on a
        signal sustained ``sustain`` ticks, then hold ``cooldown``
        ticks; after ``settle`` quiet ticks, step back toward the
        baseline config."""
        if not self.enabled:
            return
        try:
            faults.inject("control.actuate")
            names = set()
            for doc in (verdicts or {}).values():
                v = doc.get("verdict")
                if v:
                    names.add(str(v))
            signals = {
                "starved": (
                    "interactive_starved" in names
                    or "interactive_ttft_p99" in firing
                ),
                "roofline": "decode_below_roofline" in names,
                "hostbound": "host_bound_admit" in names,
                "kvpressure": "kv_pressure" in names,
            }
            any_signal = any(signals.values())
            for k, on in signals.items():
                self._sustain[k] = self._sustain.get(k, 0) + 1 if on else 0
            if self._cooldown > 0:
                self._cooldown -= 1
                self._quiet = 0 if any_signal else self._quiet + 1
                return
            acted = False
            if self._sustain.get("starved", 0) >= self.cfg.sustain:
                cur = int(self.ecfg.interactive_slots)
                new = min(self._base_slots + self.cfg.slots_boost, cur + 1)
                acted = self._apply(
                    "interactive_slots", cur, new, "interactive_starved"
                )
            elif self._sustain.get("kvpressure", 0) >= self.cfg.sustain:
                # tier thrash: widen the host tier so demoted pages
                # stay promotable instead of falling through to disk
                cur = int(
                    getattr(
                        self.ecfg, "kv_tier_host_pages",
                        self._base_kv_pages,
                    )
                )
                new = min(4 * self._base_kv_pages, cur + self._kv_step)
                acted = self._apply(
                    "kv_tier_host_pages", cur, new, "kv_pressure"
                )
                if acted:
                    self._push_kv_budget(new)
            elif self._sustain.get("hostbound", 0) >= self.cfg.sustain:
                # host-bound admit outranks roofline: shrinking the
                # batch relieves the host, growing it makes it worse
                cur = int(self.ecfg.decode_batch_size)
                new = max(8, cur - self._batch_step)
                acted = self._apply(
                    "decode_batch_size", cur, new, "host_bound_admit"
                )
            elif self._sustain.get("roofline", 0) >= self.cfg.sustain:
                cur = int(self.ecfg.decode_batch_size)
                new = min(2 * self._base_batch, cur + self._batch_step)
                acted = self._apply(
                    "decode_batch_size", cur, new, "decode_below_roofline"
                )
            if acted:
                self._cooldown = self.cfg.cooldown
                self._sustain.clear()
                self._quiet = 0
                return
            # settle: walk each knob one step back toward baseline
            # after a sustained quiet spell
            self._quiet = 0 if any_signal else self._quiet + 1
            if self._quiet >= self.cfg.settle:
                self._quiet = 0
                cur = int(self.ecfg.interactive_slots)
                if cur > self._base_slots:
                    self._apply(
                        "interactive_slots", cur, cur - 1, "settle"
                    )
                cur = int(self.ecfg.decode_batch_size)
                if cur != self._base_batch:
                    step = min(self._batch_step, abs(cur - self._base_batch))
                    new = cur - step if cur > self._base_batch else cur + step
                    self._apply("decode_batch_size", cur, new, "settle")
                cur = int(
                    getattr(
                        self.ecfg, "kv_tier_host_pages",
                        self._base_kv_pages,
                    )
                )
                if cur != self._base_kv_pages:
                    step = min(
                        self._kv_step, abs(cur - self._base_kv_pages)
                    )
                    new = (
                        cur - step
                        if cur > self._base_kv_pages
                        else cur + step
                    )
                    if self._apply(
                        "kv_tier_host_pages", cur, new, "settle"
                    ):
                        self._push_kv_budget(new)
        except Exception as e:  # noqa: BLE001 — pass-through contract
            self._degrade("control.actuate", e)

    def _push_kv_budget(self, pages: int) -> None:
        """Propagate a ``kv_tier_host_pages`` move to every live tier
        pool; pools constructed later read the knob off ecfg. Raises
        propagate to the actuate degrade path — a broken pool must not
        keep absorbing autotuner moves."""
        if self._tier_pools is None:
            return
        for pool in self._tier_pools():
            pool.set_host_budget(pages)

    def _apply(self, knob: str, cur: int, new: int, reason: str) -> bool:
        if new == cur:
            return False
        setattr(self.ecfg, knob, int(new))
        self._audit_seq += 1
        self._audit.append(
            {
                "seq": self._audit_seq,
                "unix": round(time.time(), 3),
                "knob": knob,
                "from": int(cur),
                "to": int(new),
                "reason": reason,
            }
        )
        from .. import telemetry

        if telemetry.ENABLED:
            telemetry.AUTOTUNE_ADJUSTMENTS_TOTAL.inc(1.0, knob)
        logger.info(
            "autotune: %s %d -> %d (%s)", knob, cur, new, reason
        )
        return True

    # -- introspection -------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /monitor`` enforcement sub-document."""
        with self._lock:
            buckets = {
                f"{tenant}/p{p}": {
                    "rows": round(b["rows"].level, 1),
                    "rows_capacity": b["rows"].capacity,
                    "tokens": round(b["tokens"].level, 1),
                    "tokens_capacity": b["tokens"].capacity,
                }
                for (tenant, p), b in self._buckets.items()
            }
        return {
            "enabled": self.enabled,
            "degraded_reason": self.degraded_reason,
            "window_s": self.cfg.window_s,
            "rejections": self._rejections,
            "preemptions": self._preemptions,
            "buckets": buckets,
            "autotune": {
                "baseline": {
                    "interactive_slots": self._base_slots,
                    "decode_batch_size": self._base_batch,
                    "kv_tier_host_pages": self._base_kv_pages,
                },
                "current": {
                    "interactive_slots": int(
                        getattr(self.ecfg, "interactive_slots", 0)
                    ),
                    "decode_batch_size": int(
                        getattr(self.ecfg, "decode_batch_size", 0)
                    ),
                    "kv_tier_host_pages": int(
                        getattr(
                            self.ecfg, "kv_tier_host_pages",
                            self._base_kv_pages,
                        )
                    ),
                },
                "audit": list(self._audit),
            },
        }
