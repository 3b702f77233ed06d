"""The port's ``LocalEngine`` against the JAX package's.

Both engines run on one tiny config with ``weights_dir`` at the same
checkpoints (written from the JAX package's ``init_params``: tiny-dense
and tiny-moe), the JAX one on its plain path, the port's on the CPU
(``LocalEngine(ecfg, device="cpu")``). Each engine has its own
``SUTRO_HOME``. At temperature 0 the same payloads give the same
output strings for an ``infer`` job, a classify-schema job, a job with
stop sequences and a thinking-model job; and the two engines agree on
the dry-run cost estimate, the refusal of a bad priority and of an
unknown model at submit, a job whose model is gone when it runs (a
FAILED record), a quota-failed job's FAILED record, the final progress
frame, the ``job_results`` keys (with ``errors`` for a quarantined
row), cancel then ``resume_job`` (the uncancelled outputs), two jobs
co-batched (each job's solo outputs) and a higher-priority job of
another model preempting a running one (both end with their solo
outputs, the higher-priority job first).
"""

import time

import pytest
import torch

from sutro_tpu.common import MODEL_CATALOG as JAX_CATALOG
from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine import jobstore as jax_jobstore
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.common import MODEL_CATALOG
from sutro_tpu_torch.engine import api, jobstore
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.templates.classification import _prompt_and_schema
from tests.test_torch_weights_loader import write_hf_checkpoint

# One intra-op thread for the port's CPU runs: under pytest-xdist every
# worker is a process with torch's default of one thread a core, and the
# port's many small ops then wait on threads that are not scheduled (on
# an 8-core host a 12-row, 40-token tiny-dense job took 0.5 s alone and
# 84 s in each of six such processes at once; 0.5 s with one thread).
# Every worker collects this module, so the setting holds in each.
torch.set_num_threads(1)

ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", activation_dtype="float32",
    max_new_tokens=16, prefix_store=False,
)
TERMINAL = ("SUCCEEDED", "FAILED", "CANCELLED", "CANCELLING")
ROWS = ["hello there", "a much longer row of text for the engine", "x", "fourth row!",
        "the fifth", "six six six"]


def _no_native_masks(*a, **k):
    raise OSError("the JAX side's native mask core is not used here")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-api")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 7, root / "weights" / "tiny-dense")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-moe"], 8, root / "weights" / "tiny-moe")
    cfg = dict(ENGINE, weights_dir=str(root / "weights"))
    # the JAX engine's masks from its Python core (its native core's
    # load of a maxLength-400 string takes tens of seconds), and no
    # live monitor thread
    mp.setattr(jax_cpp, "CppMasker", _no_native_masks)
    mp.setenv("SUTRO_MONITOR", "0")
    # a thinking model on the tiny weights, in both catalogs
    for cat in (MODEL_CATALOG, JAX_CATALOG):
        mp.setitem(cat, "tiny-dense-thinking",
                   {"engine_key": "tiny-dense", "thinking": True, "embedding": False})
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **cfg))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    yield jeng, teng
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def wait(eng, jid, until=TERMINAL, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = eng.job_status(jid)
        if s in until:
            return s
        time.sleep(0.01)
    raise TimeoutError(f"{jid} stuck in {eng.job_status(jid)}")


def let_go(eng, jid, timeout=120):
    """Wait until the engine's worker has let go of ``jid`` (neither
    queued, running nor attached): ``resume_job`` waits only 5 s for
    that, and the worker's epilogue, or a first job's runner build, can
    take longer on a loaded host."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with eng._lock:
            if (jid not in eng._queued and eng._current_job != jid
                    and jid not in eng._attached):
                return
        time.sleep(0.01)
    raise TimeoutError(f"{jid} still held by the worker ({eng.job_status(jid)})")


def run(eng, payload, **kw):
    jid = eng.submit_batch_inference(payload)
    assert wait(eng, jid) == "SUCCEEDED", eng.get_job(jid)
    return jid, eng.job_results(jid, **kw)


def both(engines, payload, **kw):
    """Run ``payload`` on both engines: (JAX results, port results,
    JAX record, port record)."""
    (jj, jr), (tj, tr) = (run(e, payload, **kw) for e in engines)
    return jr, tr, engines[0].get_job(jj), engines[1].get_job(tj)


def payload(rows=ROWS, model="tiny-dense", max_new=12, **kw):
    sampling = {"temperature": 0.0, "max_new_tokens": max_new, **kw.pop("sampling", {})}
    return {"model": model, "inputs": list(rows), "sampling_params": sampling, **kw}


def test_infer_job_is_token_identical(engines):
    jr, tr, jrec, trec = both(engines, payload(system_prompt="Be brief."),
                              include_cumulative_logprobs=True, include_inputs=True)
    assert tr["outputs"] == jr["outputs"]
    assert tr["gen_tokens"] == jr["gen_tokens"] and tr["inputs"] == jr["inputs"] == ROWS
    assert tr["cumulative_logprobs"] == pytest.approx(jr["cumulative_logprobs"], abs=1e-3)
    for k in ("input_tokens", "output_tokens", "job_cost", "num_rows", "status"):
        assert trec[k] == jrec[k], k
    assert trec["perf"]["cobatch"]["session_job"] == trec["job_id"]
    assert {"jobstore_flush", "jobstore_finalize"} <= set(trec["perf"])


def test_classify_schema_job_is_token_identical(engines):
    import json

    system, schema = _prompt_and_schema({"pos": "good", "neg": "bad", "meh": "neither"})
    jr, tr, jrec, trec = both(engines, payload(ROWS[:4], system_prompt=system,
                                               output_schema=schema, max_new=8))
    assert tr["outputs"] == jr["outputs"]
    # the cap was raised to the schema's room, the same on both
    assert trec["sampling_params"] == jrec["sampling_params"]
    assert trec["sampling_params"]["max_new_tokens"] > 8
    for out in tr["outputs"]:
        assert json.loads(out)["classification"] in ("pos", "neg", "meh")


def test_stop_sequences_cut_the_same(engines):
    p = payload(ROWS[:4], max_new=24)
    jr, _, _, _ = both(engines, p)
    # a stop string taken from the middle of an output (an ASCII
    # character: generation stops on bytes, rendering cuts the string)
    row, stop = next((r, c) for r, text in enumerate(jr["outputs"])
                     for c in text[1:] if c.isascii())
    sj, st, _, _ = both(engines, {**p, "sampling_params": {**p["sampling_params"],
                                                            "stop": [stop]}})
    assert st["outputs"] == sj["outputs"]
    text = jr["outputs"][row]
    assert st["outputs"][row] == text[: text.index(stop)]


def test_thinking_model_job_is_identical(engines):
    import json

    jr, tr, _, _ = both(engines, payload(ROWS[:3], model="tiny-dense-thinking"))
    assert tr["outputs"] == jr["outputs"]
    assert set(json.loads(tr["outputs"][0])) == {"content", "reasoning_content"}


def test_dry_run_cost_estimate_matches(engines):
    recs = []
    for eng in engines:
        jid = eng.submit_batch_inference(payload(dry_run=True, system_prompt="s" * 40))
        assert wait(eng, jid) == "SUCCEEDED"
        recs.append(eng.get_job(jid))
    assert recs[1]["cost_estimate"] == recs[0]["cost_estimate"] is not None
    assert recs[1]["input_tokens"] == recs[0]["input_tokens"] > 0


def test_refusals_match(engines):
    """A bad priority and an unknown model are refused at submit, with
    the same messages, before any record exists."""
    jeng, teng = engines
    msgs = []
    for eng, exc in ((jeng, jax_jobstore.InvalidPriority), (teng, jobstore.InvalidPriority)):
        n_jobs = len(eng.list_jobs())
        with pytest.raises(exc) as e:
            eng.submit_batch_inference(payload(job_priority=5))
        msgs.append((str(e.value), e.value.code))
        with pytest.raises(ValueError) as e:
            eng.submit_batch_inference(payload(model="no-such-model"))
        msgs.append(str(e.value).split(" Catalog:")[0])
        assert len(eng.list_jobs()) == n_jobs
    assert msgs[:2] == msgs[2:]


def test_job_of_a_model_no_longer_known_fails_its_record(engines):
    """A job whose model the engine no longer resolves when it runs (a
    catalog entry gone before a resume) lands FAILED with the reason,
    the same on both engines."""
    recs = []
    for eng in engines:
        for cat in (MODEL_CATALOG, JAX_CATALOG):
            cat["tiny-gone"] = {"engine_key": "tiny-dense", "thinking": False,
                                "embedding": False}
        try:
            jid = eng.submit_batch_inference(
                payload([f"gone row {i}" for i in range(12)], model="tiny-gone", max_new=40))
            eng.cancel_job(jid)
            assert wait(eng, jid, until=("CANCELLED", "SUCCEEDED")) == "CANCELLED"
            # the model stays known until the worker is done with the
            # cancelled job (it may have taken it before the cancel)
            let_go(eng, jid)
            assert eng.job_status(jid) == "CANCELLED"
        finally:
            for cat in (MODEL_CATALOG, JAX_CATALOG):
                del cat["tiny-gone"]
        assert eng.resume_job(jid)["resumed"]
        assert wait(eng, jid) == "FAILED"
        rec = eng.get_job(jid)
        recs.append((rec["failure_reason"]["message"].split(" Catalog:")[0],
                     rec["failure_log"][-1]["event"], rec["model"]))
    assert recs[0] == recs[1]
    assert recs[1][0] == "ValueError: Unknown model 'tiny-gone'."


def test_quota_failed_record_matches(engines, monkeypatch):
    recs = []
    for eng in engines:
        monkeypatch.setattr(eng.jobs, "get_quotas",
                            lambda: [{"row_quota": 2, "token_quota": 10 ** 9}])
        jid = eng.submit_batch_inference(payload(ROWS[:3]))
        assert wait(eng, jid) == "FAILED"
        rec = eng.get_job(jid)
        recs.append((rec["failure_reason"],
                     [e["event"] for e in rec["failure_log"]], rec["num_rows"]))
    assert recs[0] == recs[1]
    assert "exceeds priority-0 quota" in recs[1][0]["message"]


def test_progress_stream_ends_at_the_row_count(engines):
    frames = []
    for eng in engines:
        jid = eng.submit_batch_inference(payload(ROWS, max_new=20))
        live = list(eng.stream_job_progress(jid))
        assert wait(eng, jid) == "SUCCEEDED"
        last = [f["result"] for f in live if f["update_type"] == "progress"][-1]
        frames.append((last, list(eng.stream_job_progress(jid))))
    assert frames[0] == frames[1]
    assert frames[1][0] == len(ROWS)


def test_job_results_keys_with_a_quarantined_row(engines):
    """A row too long for the context with ``truncate_rows=False`` is
    quarantined: its output is None, ``errors`` is 1:1 with the outputs,
    and the other rows are what the JAX engine gives them. The JAX
    engine itself fails such a job under pandas 3 (its finalize counts
    tokens of a NaN output; ROADMAP.md §3), so its side runs the clean
    rows alone, and the keys are held to the ones its ``job_results``
    returns for a clean job plus ``errors``."""
    rows = ["short", "y" * 400, "also short"]
    kw = dict(include_inputs=True, include_cumulative_logprobs=True)
    _, tr = run(engines[1], payload(rows, truncate_rows=False), **kw)
    _, jr = run(engines[0], payload(rows[::2], truncate_rows=False), **kw)
    assert sorted(tr) == sorted([*jr, "errors"])
    assert tr["outputs"][::2] == jr["outputs"] and tr["outputs"][1] is None
    assert tr["inputs"] == rows and tr["gen_tokens"][1] == 0
    assert tr["errors"][0] is None and tr["errors"][2] is None
    assert "truncate_rows is off" in tr["errors"][1]


def _solo(engines, p):
    jr, tr, _, _ = both(engines, p)
    assert tr["outputs"] == jr["outputs"]
    return tr["outputs"]


DECODE_ENTRIES = ("decode_step", "decode_multi", "decode_multi_async", "decode_window")


def hold_decode(monkeypatch, eng, engine_key="tiny-dense"):
    """Hold every decode call of ``eng``'s resident ``engine_key`` runner
    until the returned event is set; ``go.calls`` counts the calls that
    reached the hold."""
    import threading

    runner = eng._runner_cache[engine_key][0]
    go = threading.Event()

    go.calls = 0

    def held(real):
        def call(*a, **k):
            go.calls += 1
            go.wait(120)
            return real(*a, **k)
        return call

    for name in DECODE_ENTRIES:
        if hasattr(runner, name):
            monkeypatch.setattr(runner, name, held(getattr(runner, name)))
    return go


def test_cancel_then_resume_gives_the_uncancelled_outputs(engines, monkeypatch):
    p = payload([f"resume row {i}" for i in range(12)], max_new=40)
    want = _solo(engines, p)
    for eng in engines:
        # the cancel lands while the job's worker is held inside its
        # first decode call. A cancel that lands earlier (the job is
        # RUNNING from before its batcher's first cancel poll, and a
        # loaded host can take seconds to its first decode) is seen at
        # that poll, and the JAX worker's CANCELLED can then race the
        # cancel's own CANCELLING write and lose, leaving the job
        # CANCELLING (sutro_tpu/engine/api.py:565-577)
        go = hold_decode(monkeypatch, eng)
        jid = eng.submit_batch_inference(p)
        try:
            deadline = time.monotonic() + 120
            while go.calls == 0:
                status = eng.job_status(jid)
                assert status not in TERMINAL, f"{jid} {status} before its first decode"
                assert time.monotonic() < deadline, f"{jid} reached no decode ({status})"
                time.sleep(0.01)
            assert eng.job_status(jid) == "RUNNING"
            eng.cancel_job(jid)
        finally:
            go.set()
        assert wait(eng, jid, until=("CANCELLED", "SUCCEEDED")) == "CANCELLED"
        let_go(eng, jid)
        res = eng.resume_job(jid)
        assert res["resumed"] and res["status"] == "QUEUED"
        assert wait(eng, jid) == "SUCCEEDED"
        assert eng.job_results(jid)["outputs"] == want


def test_cobatched_jobs_give_their_solo_outputs(engines):
    pa = payload([f"alpha {i}" for i in range(8)], max_new=24)
    pb = payload([f"bravo {i}" for i in range(3)], max_new=6)
    want_a, want_b = _solo(engines, pa), _solo(engines, pb)
    for eng in engines:
        ja = eng.submit_batch_inference(pa)
        jb = eng.submit_batch_inference(pb)
        assert wait(eng, ja) == wait(eng, jb) == "SUCCEEDED"
        assert eng.job_results(ja)["outputs"] == want_a
        assert eng.job_results(jb)["outputs"] == want_b
    # the port's record says job B ran in job A's session
    assert engines[1].get_job(jb)["perf"]["cobatch"]["session_job"] == ja


def test_higher_priority_job_of_another_model_preempts(engines):
    p1 = payload([f"batch row {i}" for i in range(12)], max_new=40, job_priority=1)
    p0 = payload(["quick a", "quick b"], model="tiny-moe", max_new=6, job_priority=0)
    want1, want0 = _solo(engines, p1), _solo(engines, p0)
    for eng in engines:
        j1 = eng.submit_batch_inference(p1)
        wait(eng, j1, until=("RUNNING",) + TERMINAL)
        j0 = eng.submit_batch_inference(p0)
        assert wait(eng, j0) == "SUCCEEDED"
        assert eng.job_status(j1) != "SUCCEEDED"
        assert wait(eng, j1) == "SUCCEEDED"
        assert eng.job_results(j1)["outputs"] == want1
        assert eng.job_results(j0)["outputs"] == want0
