"""Tokens the runner prefilled a row (the scheduler's prefix split and
``engine/prefixstore.py``), from the program's own spans: the ``tokens``
of the window's ``prefill`` spans over the rows that completed in the
window (the jobs' progress records)."""

from portbench import recorder


def read(run):
    calls = recorder.spans(run, ("prefill",))
    rows = run.traffic.rows_in(run.t_open, run.t_close)
    if not calls or rows <= 0:
        return None
    tokens = [recorder.attr(c, "tokens") for c in calls]
    if any(t is None for t in tokens):
        return None
    return sum(tokens) / rows
