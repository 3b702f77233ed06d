"""Embeddings in the port against the JAX package, on ``tiny-emb``.

- ``ModelRunner.embed_batch`` with mean pooling (``tiny-emb``) and with
  last-token pooling (Qwen3-Embedding's), on the same float32
  parameters, over ragged rows that pad to two different buckets:
  within 1e-5 of the JAX runner's (plain path); a row embedded alone
  gives the vector it gets in a batch, and the padding of a longer
  bucket does not move it.
- An embedding job on both ``LocalEngine``s (each over the same HF
  checkpoint): vectors within 1e-5, the records' token counts, cost and
  row count equal, ``finish_reason`` "stop"; a job cancelled after its
  second batch and resumed, and a job that yields to a higher-priority
  job and resumes, each end with the uninterrupted job's vectors and
  never embed a flushed row twice; a dry run's estimate equals the JAX
  engine's.
- ``so.embed`` returns the JAX façade's DataFrame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import sutro_tpu as jso
import sutro_tpu_torch as so
from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine import runner as jax_runner
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_api import ENGINE, let_go, wait
from tests.test_torch_weights_loader import write_hf_checkpoint

ATOL = 1e-5
RUNNER = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
              max_model_len=128, param_dtype="float32")
# 24 rows: three batches of 8 (the engine's batch is max(decode_batch_size, 8))
# (distinct rows: the tests tell rows apart by their tokens)
ROWS = [f"row {i}" + " word" * n for i, n in enumerate(
    (1, 3, 9, 2, 14, 5, 7, 4, 11, 6, 8, 3, 12, 2, 10, 1, 13, 9, 4, 6, 15, 7, 5, 8))]


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embed_batch_matches_the_jax_runner(pooling):
    mcfg = dataclasses.replace(MODEL_CONFIGS["tiny-emb"], pooling=pooling)
    params = jax_transformer.init_params(mcfg, jax.random.PRNGKey(3), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    jr = jax_runner.ModelRunner(mcfg, JaxEngineConfig(use_pallas=False, **RUNNER), params)
    tr = t_runner.ModelRunner(mcfg, EngineConfig(**RUNNER),
                              params_from_numpy(mcfg, tree, "cpu", torch.float32),
                              device="cpu")
    rng = np.random.default_rng(0)
    # bucket 16 (rows of 1-16 tokens) and bucket 64 (a row of 40)
    short = [rng.integers(3, 500, n).astype(np.int32) for n in (5, 16, 1, 9)]
    rows = short + [rng.integers(3, 500, 40).astype(np.int32)]
    want = jr.embed_batch(short)
    got = tr.embed_batch(short)
    assert got.dtype == np.float32 and got.shape == (4, mcfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    both = tr.embed_batch(rows)
    np.testing.assert_allclose(both, jr.embed_batch(rows), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(both, axis=1), 1.0, atol=1e-5)
    # padding to bucket 64 leaves the short rows' vectors where they were
    np.testing.assert_allclose(both[:4], got, atol=ATOL, rtol=0)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(tr.embed_batch([r])[0], both[i], atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over one ``tiny-emb`` checkpoint, a
    partial flush every 8 rows (one batch) so that a cancelled or
    yielded job resumes from its flushes."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-embed")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-emb"], 11, root / "weights" / "tiny-emb")
    cfg = dict(ENGINE, weights_dir=str(root / "weights"))
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setattr(jax_api, "_PARTIAL_FLUSH_EVERY", 8)
    mp.setattr(api, "_PARTIAL_FLUSH_EVERY", 8)
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **cfg))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    yield jeng, teng
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def _payload(rows=ROWS, **kw):
    return {"model": "tiny-emb", "inputs": list(rows), **kw}


def _run(eng, payload):
    jid = eng.submit_batch_inference(payload)
    assert wait(eng, jid) == "SUCCEEDED", eng.get_job(jid)
    return jid, eng.job_results(jid)


@pytest.fixture(scope="module")
def plain(engines):
    """The uninterrupted job on both engines: (JAX, port) x (job id,
    results)."""
    return [_run(e, _payload()) for e in engines]


def _vectors(res):
    return np.array(res["outputs"], np.float64)


def test_embedding_job_matches_the_jax_engine(engines, plain):
    (jj, jr), (tj, tr) = plain
    assert len(tr["outputs"]) == len(ROWS) and "errors" not in tr
    np.testing.assert_allclose(_vectors(tr), _vectors(jr), atol=ATOL, rtol=0)
    jrec, trec = engines[0].get_job(jj), engines[1].get_job(tj)
    for k in ("input_tokens", "output_tokens", "job_cost", "num_rows", "status"):
        assert trec[k] == jrec[k], k
    assert trec["output_tokens"] == 0 and trec["input_tokens"] > len(ROWS)
    cols = engines[1].jobs.read_results(tj)
    assert cols["finish_reason"] == ["stop"] * len(ROWS)
    assert cols["row_id"] == list(range(len(ROWS)))
    # the port's record also times the device calls and the jobstore
    assert trec["perf"]["embed"]["count"] == 3
    assert {"jobstore_flush", "jobstore_finalize"} <= set(trec["perf"])


class _Calls:
    """Wraps a runner's ``embed_batch``: records each call's rows and
    runs ``hook(n_calls)`` after each call."""

    def __init__(self, runner, hook):
        self.runner, self.hook, self.rows = runner, hook, []
        self.real = runner.embed_batch

    def __call__(self, rows):
        out = self.real(rows)
        self.rows.append([tuple(r) for r in rows])
        self.hook(len(self.rows))
        return out

    def __enter__(self):
        self.runner.embed_batch = self
        return self

    def __exit__(self, *exc):
        del self.runner.embed_batch


def _runner(eng):
    return eng._runner_cache["tiny-emb"][0]


def _rows_embedded(calls):
    return [r for batch in calls.rows for r in batch]


@pytest.mark.parametrize("side", [0, 1], ids=["jax", "port"])
def test_cancel_then_resume_gives_the_uninterrupted_vectors(engines, plain, side):
    eng = engines[side]
    held = {}

    def hook(n):
        if n == 2:
            eng.cancel_job(held["jid"])

    with _Calls(_runner(eng), hook) as calls:
        held["jid"] = jid = eng.submit_batch_inference(_payload())
        assert wait(eng, jid, until=("CANCELLED", "SUCCEEDED", "FAILED")) == "CANCELLED"
        let_go(eng, jid)
        assert eng.resume_job(jid)["resumed"]
        assert wait(eng, jid) == "SUCCEEDED"
    np.testing.assert_allclose(_vectors(eng.job_results(jid)), _vectors(plain[side][1]),
                               atol=ATOL, rtol=0)
    embedded = _rows_embedded(calls)
    assert len(calls.rows) == 3 and len(embedded) == len(ROWS) == len(set(embedded))


@pytest.mark.parametrize("side", [0, 1], ids=["jax", "port"])
def test_yield_then_resume_gives_the_uninterrupted_vectors(engines, plain, side):
    """A priority-1 job yields to a priority-0 job submitted during its
    first batch; it requeues, the other job runs, and it resumes from
    its flushed rows."""
    eng = engines[side]
    held, seen = {}, []
    other_rows = [f"other {i}" for i in range(5)]

    def hook(n):
        if n == 1:
            held["other"] = eng.submit_batch_inference(_payload(other_rows, job_priority=0))

    real_set_status = eng.jobs.set_status

    def set_status(job_id, status, **kw):
        if job_id == held.get("jid"):
            seen.append(status.value)
        return real_set_status(job_id, status, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(eng.jobs, "set_status", set_status)
    try:
        with _Calls(_runner(eng), hook) as calls:
            held["jid"] = jid = eng.submit_batch_inference(_payload(job_priority=1))
            assert wait(eng, jid) == "SUCCEEDED"
            assert wait(eng, held["other"]) == "SUCCEEDED"
    finally:
        mp.undo()
    np.testing.assert_allclose(_vectors(eng.job_results(jid)), _vectors(plain[side][1]),
                               atol=ATOL, rtol=0)
    other = {tuple(r) for r in calls.rows[1]}
    assert len(calls.rows[1]) == len(other_rows), "the other job ran between two batches"
    embedded = _rows_embedded(calls)
    mine = [r for r in embedded if r not in other]
    assert len(mine) == len(ROWS) == len(set(mine))
    assert seen[seen.index("RUNNING"):].count("RUNNING") == 2, seen
    assert "QUEUED" in seen[seen.index("RUNNING"):], seen


def test_embedding_dry_run_matches(engines):
    recs = []
    for eng in engines:
        jid = eng.submit_batch_inference(_payload(dry_run=True))
        assert wait(eng, jid) == "SUCCEEDED"
        recs.append(eng.get_job(jid))
    assert recs[1]["cost_estimate"] == recs[0]["cost_estimate"]
    assert recs[1]["input_tokens"] == recs[0]["input_tokens"]


def test_so_embed_returns_the_jax_dataframe(engines):
    mp = pytest.MonkeyPatch()
    mp.setattr(jso._instance, "_engine", engines[0])
    mp.setattr(so._instance, "_engine", engines[1])
    try:
        df = pd.DataFrame({"text": ROWS[:6], "n": range(6)})
        want = jso.embed(df, column="text", model="tiny-emb")
        got = so.embed(df, column="text", model="tiny-emb")
    finally:
        mp.undo()
    assert list(got.columns) == list(want.columns) == ["embedding"]
    np.testing.assert_allclose(np.array(got["embedding"].tolist()),
                               np.array(want["embedding"].tolist()), atol=ATOL, rtol=0)
