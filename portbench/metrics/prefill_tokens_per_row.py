"""Tokens the runner prefilled a row (the scheduler's prefix split and
``engine/prefixstore.py``): the tokens of the window's prefill calls, from
the harness's span on the runner's prefill entries, over the rows that
completed in the window (the jobs' progress records)."""

from portbench import work


def read(run):
    rows = run.traffic.rows_in(run.t_open, run.t_close)
    tokens = sum(t for t, _ in work.prefill_rows(run))
    return tokens / rows if rows > 0 else None
