"""Host milliseconds of a ``LocalEngine.submit_batch_inference`` call
(``engine/api.py``, ``engine/jobstore.py``), from the program's ``submit``
span around its own body: the mean over the run's submits up to the
window's close, set-up's included (the jobs the harness submitted, whose
calls ``submit_ms`` times from outside; spans of other jobs the process
holds are left out)."""

from portbench import recorder


def read(run):
    calls = recorder.spans(run, ("submit",), since=float("-inf"))
    if calls is None:
        return None
    ids = {j["id"] for j in run.traffic.jobs}
    calls = [c for c in calls if c["job_id"] in ids]
    return 1e3 * sum(c["dur_s"] for c in calls) / len(calls) if calls else None
