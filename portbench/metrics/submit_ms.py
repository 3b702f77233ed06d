"""Host milliseconds of a ``LocalEngine.submit_batch_inference`` call
(``engine/api.py``, ``engine/jobstore.py``): the mean over every submit of
the run, from the harness's span around each call."""


def read(run):
    spans = run.traffic.submits
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / len(spans) if spans else None
