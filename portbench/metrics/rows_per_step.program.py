"""Rows a decode step carries (``engine/scheduler.py``), from the
program's own spans: the mean ``batch`` of the window's decode calls,
weighted by their fused ``steps``."""

from portbench import recorder


def read(run):
    calls = recorder.spans(run, ("decode_window",))
    if not calls:
        return None
    shaped = [(int(recorder.attr(c, "steps") or 0), recorder.attr(c, "batch")) for c in calls]
    shaped = [(s, b) for s, b in shaped if s and b is not None]
    steps = sum(s for s, _ in shaped)
    return sum(s * b for s, b in shaped) / steps if steps else None
