"""The port's JobStore against the JAX package's.

The same sequence of calls goes to both stores (the JAX one writes
parquet, the port's JSON-lines): statuses, records (minus timestamps),
failure logs (minus timestamps), quotas, priority refusals, partial
reads and results must be the same. Results compare as columns: the
JAX store's DataFrame turned into lists against the port's dict of
lists.
"""

import json

import pytest

from sutro_tpu.engine import faults as jax_faults
from sutro_tpu.engine import jobstore as jax_js
from sutro_tpu.interfaces import JobStatus as JaxStatus
from sutro_tpu_torch.engine import faults as t_faults
from sutro_tpu_torch.engine import jobstore as t_js
from sutro_tpu_torch.interfaces import JobStatus

@pytest.fixture
def stores(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    kw = dict(chunk_rows=4, io_retries=3, io_backoff=0.0, io_backoff_cap=0.0)
    yield (jax_js.JobStore(root=tmp_path / "jax", **kw),
           t_js.JobStore(root=tmp_path / "port", **kw))
    jax_faults.clear()
    t_faults.clear()


def _record(store, job_id):
    """The record with each timestamp replaced by whether it is set,
    and its failure log without timestamps and error texts."""
    d = store.get(job_id).to_dict()
    for k in ("datetime_created", "datetime_started", "datetime_completed"):
        d[k] = d[k] is not None
    # a quarantined chunk's name ends in its format's suffix
    d["failure_log"] = [
        {k: v.split(".")[0] if k == "chunk" else v
         for k, v in ev.items() if k not in ("ts", "error")}
        for ev in d["failure_log"] or ()
    ]
    return d


def _results(store, job_id):
    got = store.read_results(job_id)
    if not isinstance(got, dict):  # the JAX store's DataFrame: its null
        # strings read back as NaN in an all-null column (the JAX
        # engine's job_results maps them to None the same way)
        got = {c: [None if isinstance(v, float) and v != v and c in ("outputs", "error")
                   else v for v in got[c].tolist()] for c in got.columns}
    return got


def _both(stores, fn):
    a, b = fn(stores[0], jax_js, JaxStatus), fn(stores[1], t_js, JobStatus)
    assert a == b
    return b


def _rows(ids, reason="length", **extra):
    return [
        {"row_id": i, "outputs": f"out {i}" if reason != "error" else None,
         "cumulative_logprobs": -0.25 * i, "gen_tokens": i + 1,
         "finish_reason": reason, "error": "boom" if reason == "error" else None, **extra}
        for i in ids
    ]


def _make(store, mod, status, job_id="job-x", n=10):
    store.create(job_id=job_id, model="tiny-dense", engine_key="tiny-dense",
                 num_rows=n, job_priority=1, system_prompt="sys",
                 sampling_params={"max_new_tokens": 8}, tenant="acme")
    store.write_inputs(job_id, [f"row {i}" for i in range(n)])
    return job_id


@pytest.mark.parametrize("chunked", [False, True], ids=["one-flush", "many-flushes"])
def test_job_lifecycle_and_results_match(stores, chunked):
    def run(store, mod, S):
        terminal = []
        store.on_terminal = lambda rec: terminal.append(rec.status)
        jid = _make(store, mod, S)
        seen = [store.status(jid).value, store.read_inputs(jid)]
        store.set_status(jid, S.STARTING)
        store.set_status(jid, S.RUNNING)
        store.append_failure_log(jid, {"event": "row_retry", "row_id": 3, "attempt": 1})
        rows = _rows(range(0, 7)) + _rows([7], "error") + _rows([8], "cancelled")
        if chunked:
            for k in range(0, len(rows), 3):
                store.flush_partial(jid, rows[k:k + 3])
            # a re-run row: the later flush wins
            store.flush_partial(jid, _rows([2], "stop"))
        else:
            store.flush_partial(jid, rows)
        seen.append(store.read_partial_meta(jid))
        chunks = []
        store.write_results_streamed(
            jid, 10, on_chunk=lambda c: chunks.append(list(c["row_id"])))
        store.update(jid, input_tokens=40, output_tokens=17,
                     job_cost=mod.estimate_cost("tiny-dense", 40, 17))
        store.set_status(jid, S.SUCCEEDED)
        seen += [_record(store, jid), _results(store, jid), chunks, terminal,
                 store.status(jid).value]
        return seen

    got = _both(stores, run)
    assert got[-1] == "SUCCEEDED" and got[-2] == ["SUCCEEDED"]
    res = got[-4]
    # row 9 never ran: cancelled with no output; row 8 was cancelled
    assert res["finish_reason"][8:] == ["cancelled", "cancelled"]
    assert res["outputs"][9] is None and res["error"][7] == "boom"


def test_partial_rows_backfill_and_resume_meta(stores):
    """Rows without ``gen_tokens``/``error`` backfill; a row missing a
    required column refuses to finalize in both stores."""
    def run(store, mod, S):
        jid = _make(store, mod, S, n=5)
        rows = _rows(range(3))
        for r in rows:
            del r["gen_tokens"], r["error"]
        store.flush_partial(jid, rows)
        store.flush_partial(jid, _rows([4], "cancelled"))
        meta = store.read_partial_meta(jid)
        full = {i: {k: r[k] for k in ("outputs", "finish_reason")}
                for i, r in store.read_partial(jid).items()}
        store.write_results_streamed(jid, 5)
        store.set_status(jid, S.SUCCEEDED)
        bad = _make(store, mod, S, job_id="job-bad", n=2)
        store.flush_partial(bad, [{"row_id": 0, "outputs": "x", "finish_reason": "stop"}])
        with pytest.raises(ValueError, match="lack columns"):
            store.write_results_streamed(bad, 2)
        return [meta, full, _results(store, jid)]

    _both(stores, run)


def test_torn_chunk_is_quarantined_and_retried(stores):
    """A torn flush (fault kind ``torn``) lands a truncated chunk at a
    real name and retries; the reader quarantines it, and the results
    hold every row of the good retry."""
    def run(store, mod, S):
        (jax_faults if mod is jax_js else t_faults).configure(
            "jobstore.flush_partial:torn:times=1")
        jid = _make(store, mod, S, n=4)
        store.flush_partial(jid, _rows(range(4)))
        store.write_results_streamed(jid, 4)
        store.set_status(jid, S.SUCCEEDED)
        rec = _record(store, jid)
        corrupt = sorted(p.name.split(".")[0]
                         for p in (store._dir(jid) / "partial" / ".corrupt").iterdir())
        return [rec, _results(store, jid), corrupt]

    got = _both(stores, run)
    assert [e["event"] for e in got[0]["failure_log"]] == ["io_retry", "torn_chunk_quarantined"]


def test_finalize_retries_a_transient_io_error(stores):
    def run(store, mod, S):
        (jax_faults if mod is jax_js else t_faults).configure(
            "jobstore.finalize:ioerror:times=1")
        jid = _make(store, mod, S, n=6)
        store.flush_partial(jid, _rows(range(6)))
        counted = []

        def on_chunk(c):
            if c["row_id"][0] == 0:
                counted.clear()
            counted.extend(c["outputs"])

        store.write_results_streamed(jid, 6, on_chunk=on_chunk)
        store.set_status(jid, S.SUCCEEDED)
        return [_record(store, jid), _results(store, jid), counted]

    _both(stores, run)


def test_quotas_priorities_and_listing(stores, tmp_path):
    def run(store, mod, S):
        out = [store.get_quotas(), store.validate_priority(1),
               store.check_quota(0, 500_001, 0), store.check_quota(1, 10, 6_000_000_000),
               store.check_quota(0, 10, 10)]
        for bad in (-1, 2, "x", None):
            with pytest.raises(mod.InvalidPriority) as e:
                store.validate_priority(bad)
            out.append((str(e.value), e.value.code, e.value.status))
        a = _make(store, mod, S, job_id="job-a", n=1)
        b = _make(store, mod, S, job_id="job-b", n=1)
        store.set_status(a, S.CANCELLED)
        store.set_status(b, S.FAILED, failure_reason={"message": "no"})
        out.append(sorted((r["job_id"], r["status"]) for r in store.list_jobs()))
        out.append([_record(store, a), _record(store, b)])
        with pytest.raises(FileNotFoundError):
            store.read_results(b)
        with pytest.raises(KeyError):
            store.get("job-none")
        return out

    _both(stores, run)
    (tmp_path / "home" / "quotas.json").write_text(json.dumps(
        [{"row_quota": 3, "token_quota": 100}]))
    got = _both(stores, lambda s, m, S: [s.get_quotas(), s.check_quota(0, 4, 0),
                                        s.check_quota(0, 3, 101)])
    assert got[0] == [{"row_quota": 3, "token_quota": 100}]


def test_cost_model_matches():
    for key in ("qwen3-8b", "gpt-oss-20b", "tiny-dense"):
        assert t_js.estimate_cost(key, 12_345, 678) == jax_js.estimate_cost(key, 12_345, 678)
    assert t_js.COST_PER_MTOK == jax_js.COST_PER_MTOK
    assert t_js.DEFAULT_QUOTAS == jax_js.DEFAULT_QUOTAS


def test_cancelling_never_overwrites_a_terminal_status(stores):
    """The port's ``set_cancelling`` (its ``cancel_job`` writes through
    it): ``CANCELLING`` over a live job, nothing over a terminal one,
    so a cancel that crosses the worker's last write cannot leave a
    finished job ``CANCELLING``."""
    store = stores[1]
    got = []
    for k, end in enumerate((None, JobStatus.SUCCEEDED, JobStatus.FAILED,
                             JobStatus.CANCELLED)):
        jid = _make(store, t_js, JobStatus, job_id=f"job-{k}")
        store.set_status(jid, JobStatus.RUNNING)
        if end is not None:
            store.set_status(jid, end)
        got.append((store.set_cancelling(jid).value, store.status(jid).value))
    assert got == [("CANCELLING", "CANCELLING"), ("SUCCEEDED", "SUCCEEDED"),
                   ("FAILED", "FAILED"), ("CANCELLED", "CANCELLED")]
