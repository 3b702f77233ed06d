"""Soft in-process deadline: a process stops itself, cleanly, before an
outer supervisor's kill.

The port of ``sutro_tpu/engine/softdeadline.py``. SIGKILL skips all
teardown, and SIGTERM's default disposition also ends the process
without running ``finally`` blocks or atexit hooks, so a process that
holds a device, a server socket or half-written job files should unwind
normally instead:

    from sutro_tpu_torch.engine.softdeadline import arm_from_env
    arm_from_env()      # no-op unless SUTRO_SOFT_DEADLINE_S is set

Mechanism, two stages:
  1. At the deadline a daemon watchdog thread sends the main thread a
     real SIGINT (``pthread_kill`` — unlike ``interrupt_main`` it
     EINTRs blocking syscalls). arm()'s own SIGINT handler raises
     ``SystemExit(124)``: the stack unwinds (finally blocks and
     context managers run), atexit runs, and the interpreter exits 124
     (the timeout convention). The handler is installed unconditionally
     because a process launched from a non-interactive shell's async
     list inherits SIGINT=SIG_IGN, which Python preserves, making the
     default-handler path a silent no-op.
  2. A main thread inside a long C call (a kernel build, a device
     synchronize) cannot see the signal until the call returns — so the
     watchdog keeps re-signalling every 15 s for the whole ``grace``
     window (stopping the moment the handler actually runs, so in-flight
     teardown is never re-interrupted). Only after the full grace does
     it ``os._exit(124)``: the outer supervisor's SIGKILL is imminent
     then anyway, and self-exiting at least keeps the code legible.

It also installs a SIGTERM handler taking the same clean path, so a
supervisor's TERM (stage 1 of terminate-then-kill) unwinds normally too.

``remaining_s()`` is the armed deadline's headroom: the control plane
(``engine/control.py``) caps its bounded admission waits with it and
stops preempting when a suspended row could not resume in time.
"""

from __future__ import annotations

import _thread
import os
import signal
import sys
import threading
import time


_FIRED = threading.Event()
# set the moment the Python-level SIGINT/SIGTERM handler actually RUNS
# (the interrupt was delivered at a bytecode boundary and SystemExit is
# now unwinding): the watchdog must stop re-signalling then — another
# SIGINT would land inside a finally / context-manager teardown frame
# and abort the very cleanup the clean exit exists for. While the main
# thread is stuck in a C call the handler has NOT run yet, so
# re-signalling remains correct there.
_DELIVERED = threading.Event()
_ARMED = False
# monotonic timestamp the armed deadline expires at (None when unarmed):
# the control plane reads this via remaining_s() to cap its bounded
# admission waits and to stop preempting when suspended rows could not
# be resumed before the process unwinds
_DEADLINE_AT: float | None = None


def _watchdog(deadline_s: float, grace_s: float) -> None:
    time.sleep(deadline_s)
    _FIRED.set()
    print(
        f"[softdeadline] {deadline_s:.0f}s budget exhausted - "
        "interrupting main thread for a clean exit",
        file=sys.stderr,
        flush=True,
    )
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if _DELIVERED.is_set():
            # handler ran; the main thread is unwinding — let it finish
            time.sleep(min(15.0, max(0.1, deadline - time.monotonic())))
            continue
        try:
            signal.pthread_kill(
                threading.main_thread().ident, signal.SIGINT
            )
        except Exception:
            _thread.interrupt_main()
        time.sleep(min(15.0, max(0.1, deadline - time.monotonic())))
    if _DELIVERED.is_set():
        # the interrupt landed and teardown is in flight — hard-exiting
        # now would cut the cleanup the clean path exists for; the outer
        # supervisor's TERM->KILL remains the backstop for a hung
        # teardown
        print(
            "[softdeadline] grace expired but teardown is unwinding - "
            "leaving it to finish",
            file=sys.stderr,
            flush=True,
        )
        return
    print(
        "[softdeadline] main thread did not unwind within "
        f"{grace_s:.0f}s grace (stuck in C call) - hard exit 124",
        file=sys.stderr,
        flush=True,
    )
    os._exit(124)


def _sigint(_sig, _frm):
    if _FIRED.is_set():
        if _DELIVERED.is_set():
            # already delivered: the stack is unwinding through finally
            # blocks / context managers. A second SystemExit here (a
            # watchdog re-signal racing the delivery, or a stray ^C)
            # would abort the very teardown the clean exit exists to
            # protect — swallow it.
            return
        # only a post-deadline interrupt counts as delivery — marking a
        # genuine pre-deadline ^C would permanently disable the
        # watchdog's re-signalling (the event is never cleared)
        _DELIVERED.set()
        print(
            "[softdeadline] deadline interrupt delivered - clean "
            "unwind to exit 124",
            file=sys.stderr,
            flush=True,
        )
        raise SystemExit(124)
    # a genuine ^C while armed: preserve the usual semantics
    raise KeyboardInterrupt


def _sigterm(_sig, _frm):
    _FIRED.set()
    _DELIVERED.set()
    print(
        "[softdeadline] SIGTERM - raising for a clean exit",
        file=sys.stderr,
        flush=True,
    )
    raise SystemExit(124)


def remaining_s() -> float | None:
    """Seconds left on the armed soft deadline, or None when unarmed.

    Clamped at 0 after expiry. Consumers (engine/control.py) use this
    to bound waits and to refuse work that could not finish before the
    watchdog fires; None means "no deadline pressure"."""
    if _DEADLINE_AT is None:
        return None
    return max(0.0, _DEADLINE_AT - time.monotonic())


def arm(deadline_s: float, grace_s: float = 120.0) -> None:
    """Arm the two-stage watchdog. Idempotent (first call wins)."""
    global _ARMED, _DEADLINE_AT
    if _ARMED or deadline_s <= 0:
        return
    _ARMED = True
    _DEADLINE_AT = time.monotonic() + deadline_s
    try:
        signal.signal(signal.SIGTERM, _sigterm)
        signal.signal(signal.SIGINT, _sigint)
    except ValueError:
        pass  # not the main thread; keep default dispositions
    t = threading.Thread(
        target=_watchdog, args=(deadline_s, grace_s), daemon=True
    )
    t.start()


def arm_from_env(default_grace_s: float = 120.0) -> None:
    """Arm from SUTRO_SOFT_DEADLINE_S (seconds); no-op if unset/invalid."""
    raw = os.environ.get("SUTRO_SOFT_DEADLINE_S", "")
    try:
        deadline = float(raw)
    except ValueError:
        return
    try:
        grace = float(
            os.environ.get("SUTRO_SOFT_GRACE_S", default_grace_s)
        )
    except ValueError:
        grace = default_grace_s  # a knob typo must not kill the case
    arm(deadline, grace)
