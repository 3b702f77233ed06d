"""The program's own spans, for the per-layer metric readers: the flight
recorder of ``sutro_tpu_torch.telemetry`` (``RECORDER``). A span's start
is ``RECORDER.epoch_mono + t0_s`` on ``time.monotonic``, which on Linux
reads the clock ``time.perf_counter`` reads, the clock of the harness's
window (``run.t_open``, ``run.t_close``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def spans(run, names, since: Optional[float] = None, until: Optional[float] = None,
          ended: bool = False) -> Optional[List[Dict]]:
    """The spans named in ``names`` that start in ``[since, until]``
    (the window by default), and with ``ended`` end by ``until`` too.
    None where telemetry was off, or where the recorder's ring dropped
    spans of that time."""
    from sutro_tpu_torch import telemetry

    since = run.t_open if since is None else since
    until = run.t_close if until is None else until
    if not telemetry.enabled():
        return None
    rec = telemetry.RECORDER
    every = rec.snapshot()
    epoch = rec.epoch_mono
    if rec.dropped > 0 and (not every or epoch + every[0]["t0_s"] > since):
        return None
    return [s for s in every if s["name"] in names and since <= epoch + s["t0_s"] <= until
            and not (ended and epoch + s["t0_s"] + s["dur_s"] > until)]


def attr(span: Dict, key: str):
    return (span.get("attrs") or {}).get(key)


def decode_calls(run) -> Optional[List[Dict]]:
    """The decode calls (``decode_window`` spans) that start and end
    inside the window. A call still open at the close is left out of the
    per-step times: in a ``--trace 1`` run the profiler's stop holds the
    whole process there, so that call's duration and device time would
    count the stop."""
    return spans(run, ("decode_window",), ended=True)


def decode_device(run) -> Optional[Tuple[int, float]]:
    """Fused steps and device seconds of :func:`decode_calls`, over the
    calls whose device time was measured (``device_s``; a pipelined
    window's lands on its dispatch span at its fetch). None where no
    call has one."""
    calls = decode_calls(run)
    if calls is None:
        return None
    steps, seconds, timed = 0, 0.0, False
    for c in calls:
        dev = attr(c, "device_s")
        if dev is not None:
            timed = True
            steps += int(attr(c, "steps") or 0)
            seconds += float(dev)
    return (steps, seconds) if timed and steps else None
