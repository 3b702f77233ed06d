"""Rows a decode step carries (``engine/scheduler.py``): the mean number of
active slots over the window's decode steps, from the harness's span on
the runner's decode entries."""


def read(run):
    calls = run.decode_calls()
    steps = sum(c[2] for c in calls)
    return sum(c[2] * len(c[3]) for c in calls) / steps if steps else None
