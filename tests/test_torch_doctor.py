"""The port's roofline table, trace export and doctor against the JAX
package's, and the telemetry getters of the port's engine and façade.

- ``engine/roofline.py``: the JAX table's rows and grades unchanged,
  and the H100 row (3,350 GB/s, 989 bf16 TFLOP/s) matched by the kind
  ``torch.cuda.get_device_name`` reports.
- ``telemetry/traceexport.py``: the golden request trace
  (``tests/data/trace_export.golden``), a job's flight record and the
  coverage gap render as the JAX package renders them.
- ``telemetry/doctor.py``: the pinned dp document
  (``tests/data/doctor_verdict.golden``) and the verdict matrix of
  ``tests/test_distributed_telemetry.py`` and ``tests/test_traces.py``
  give the JAX doctor's diagnoses; a decode window on an H100 grades
  against its row.
- On a port engine (CPU): after an embedding job, ``get_job_telemetry``
  holds its ``embed`` spans and counters, ``get_trace`` Chrome trace
  events, ``diagnose_job`` a verdict that says the CPU has no roofline
  row and, with the runner reporting an H100, grades against that row;
  ``get_metrics_text`` is Prometheus text.
"""

import json

import pytest

import sutro_tpu_torch as so
from sutro_tpu.engine import roofline as jax_roofline
from sutro_tpu.telemetry import doctor as jax_doctor
from sutro_tpu.telemetry import traceexport as jax_traceexport
from sutro_tpu_torch.engine import api, roofline
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.telemetry import doctor, traceexport
from sutro_tpu_torch.telemetry.traces import TraceStore
from tests.test_distributed_telemetry import DOCTOR_GOLDEN, _V5E, _golden_case, _span
from tests.test_torch_api import ENGINE, wait
from tests.test_traces import GOLDEN as TRACE_GOLDEN
from tests.test_traces import _doc as _request_doc
from tests.test_traces import _golden_trace_doc

H100_KIND = "NVIDIA H100 80GB HBM3"
_H100 = {**_V5E, "device_kind": H100_KIND}


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v5p", "TPU v6e", "TPU v4", "cpu", ""])
def test_roofline_rows_equal_the_jax_table(kind):
    assert roofline.hw_specs(kind) == jax_roofline.hw_specs(kind)
    kw = dict(param_bytes=16_000_000_000, batch=64, avg_ctx=300.0, num_layers=36,
              kv_heads=8, head_dim=128)
    assert roofline.decode_bytes_per_step(**kw) == jax_roofline.decode_bytes_per_step(**kw)
    bps = roofline.decode_bytes_per_step(**kw)
    assert roofline.grade_decode(900.0, batch=64, bytes_per_step=bps, device_kind=kind) == \
        jax_roofline.grade_decode(900.0, batch=64, bytes_per_step=bps, device_kind=kind)
    assert roofline.grade_prefill(2e4, n_params=8_000_000_000, device_kind=kind) == \
        jax_roofline.grade_prefill(2e4, n_params=8_000_000_000, device_kind=kind)


def test_roofline_h100_row():
    assert roofline.hw_specs(H100_KIND) == (3350.0, 989.0)
    assert roofline.hw_specs("NVIDIA H100 PCIe") == (3350.0, 989.0)
    assert jax_roofline.hw_specs(H100_KIND) is None
    # a step that moves 3.35 GB at 64 rows, 1,000 steps a second: the bound
    g = roofline.grade_decode(64_000.0, batch=64, bytes_per_step=3.35e9, device_kind=H100_KIND)
    assert g["pct_hbm_roofline"] == 100.0 and g["hbm_gb_s"] == 3350.0
    # 2 x 0.6 G params x 1,000 tok/s = 1.2 TFLOP/s of 989
    assert roofline.grade_prefill(1000.0, n_params=600_000_000,
                                  device_kind=H100_KIND)["mfu_prefill"] == 0.1


def test_trace_export_matches_the_golden_and_the_jax_export():
    doc = _golden_trace_doc()
    chrome = traceexport.trace_to_chrome(doc)
    assert chrome == jax_traceexport.trace_to_chrome(doc)
    assert traceexport.render(chrome) == TRACE_GOLDEN.read_text()
    assert traceexport.largest_gap_s(doc) == jax_traceexport.largest_gap_s(doc)


def test_trace_store_copy_gives_the_same_document():
    store = TraceStore(capacity=8)
    store.start_trace("tr-a", "batch", {"job_id": "a"}, t0_mono=10.0, created_unix=1.0)
    store.add("tr-a", "prefill", 10.5, 0.25, {"tokens": 12})
    store.event("tr-a", "finish", {"outcome": "ok"}, t_mono=11.0)
    store.end_trace("tr-a", "ok")
    doc = store.doc("tr-a")
    assert traceexport.render(traceexport.trace_to_chrome(doc)) == jax_traceexport.render(
        jax_traceexport.trace_to_chrome(doc))


def test_job_doc_export_equals_the_jax_export():
    doc = _golden_case()["doc"]
    assert traceexport.job_doc_to_chrome(doc) == jax_traceexport.job_doc_to_chrome(doc)


def test_doctor_golden_document():
    got = json.dumps(doctor.diagnose(**_golden_case()), indent=2) + "\n"
    assert got == DOCTOR_GOLDEN.read_text()


DOCS = {
    "host_bound_admit": {"job_id": "j", "counters": {}, "spans": [
        _span("constraint_compile", 0.0, 4.0), _span("accept", 4.0, 1.0),
        _span("decode_window", 5.0, 1.0)]},
    "io_bound": {"job_id": "j", "counters": {}, "spans": [
        _span("flush", 0.0, 3.0), _span("finalize", 3.0, 2.0),
        _span("decode_window", 5.0, 1.0), _span("tokenize", 6.0, 0.1)]},
    "below_roofline_v5e": {"job_id": "j", "attrs": {"device": _V5E}, "counters": {
        "rows_ok": 8, "input_tokens": 1024, "output_tokens": 256}, "spans": [
        _span("decode_window", 0.0, 0.08, batch=8, steps=4, avg_ctx=128.0)] * 4},
    "below_roofline_h100": {"job_id": "j", "attrs": {"device": _H100}, "counters": {
        "rows_ok": 8, "input_tokens": 1024, "output_tokens": 256}, "spans": [
        _span("decode_window", 0.0, 0.08, batch=8, steps=4, avg_ctx=128.0)] * 4},
    "embed_on_h100": {"job_id": "j", "attrs": {"device": _H100},
                      "counters": {"rows_ok": 64, "input_tokens": 30000}, "spans": [
        _span("embed", 0.0, 0.3, rows=64), _span("flush", 0.3, 0.01),
        _span("finalize", 0.31, 0.02)]},
    "unknown_device": {"job_id": "j", "attrs": {"device": {**_V5E, "device_kind": "cpu"}},
                       "counters": {}, "spans": [
        _span("decode_window", 0.0, 0.08, batch=8, steps=4)]},
    "empty": {"job_id": "j", "counters": {}, "spans": []},
}


@pytest.mark.parametrize("name", sorted(DOCS))
@pytest.mark.parametrize("status", [None, "RUNNING", "SUCCEEDED"])
def test_doctor_verdicts_equal_the_jax_doctor(name, status):
    doc = DOCS[name]
    got = doctor.diagnose(doc, status=status, num_rows=8)
    want = jax_doctor.diagnose(doc, status=status, num_rows=8)
    if name.endswith("h100"):
        # the JAX table has no H100 row: its grade says so, the port's grades
        rl = got["processes"]["rank0"]["roofline"]
        assert "reason" in want["processes"]["rank0"]["roofline"]
        assert "reason" not in rl and rl["device_kind"] == H100_KIND
        if name == "below_roofline_h100":
            assert rl["graded_windows"] == 4 and rl["decode_pct_hbm_median"] < 40.0
            assert got["verdict"] == "decode_below_roofline"
        return
    assert got == want


def test_request_verdicts_equal_the_jax_doctor():
    docs = [
        _request_doc([("queue_wait", 0.0, 0.8, None), ("prefill", 0.8, 0.1, None),
                      ("decode_window", 0.9, 0.1, None)]),
        _request_doc([("prefill", 0.0, 0.1, None),
                      ("preempt_suspend", 0.1, 0.0, {"row_id": 1, "lost_tokens": 4}),
                      ("resume", 0.9, 0.0, {"row_id": 1}), ("decode_window", 0.9, 0.1, None)]),
        _request_doc([("prefill", 0.0, 0.1, None), ("stream_flush", 0.1, 0.9, {"bytes": 1})]),
        _request_doc([("prefill", 0.0, 0.1, None), ("preempt_suspend", 0.1, 0.0, {"row_id": 2}),
                      ("decode_window", 0.9, 0.1, None)]),
        {"trace_id": "tr-e", "spans": []},
        _golden_trace_doc(),
    ]
    got = [doctor.diagnose_request(d) for d in docs]
    assert got == [jax_doctor.diagnose_request(d) for d in docs]
    assert [g["verdict"] for g in got] == [
        "queue_wait_bound", "preemption_bound", "stream_flush_bound", "preemption_bound",
        "insufficient_data", got[-1]["verdict"]]


def _pipelined_h100(device_s: bool):
    """Four pipelined windows on an H100: each a short dispatch carrying
    the window's shape and, where ``device_s``, its device time from CUDA
    events, and a long fetch."""
    spans = [_span("prefill", 0.0, 0.3, tokens=600,
                   **({"device_s": 0.25, "gap_s": 0.0} if device_s else {}))]
    for w in range(1, 5):
        t = 0.3 + 0.1 * w
        dev = {"device_s": 0.05, "gap_s": 0.001} if device_s else {}
        spans.append(_span("decode_window", t, 0.002, batch=8, steps=4, avg_ctx=128.0,
                           win=w, **dev))
        spans.append(_span("decode_fetch", t + 0.002, 0.08, win=w))
    return {"job_id": "j", "attrs": {"device": _H100},
            "counters": {"rows_ok": 8, "input_tokens": 1024, "output_tokens": 256},
            "spans": spans}


def test_doctor_grades_each_pipelined_window_once_by_its_device_time():
    rank0 = doctor.diagnose(_pipelined_h100(True), status="SUCCEEDED")["processes"]["rank0"]
    rl = rank0["roofline"]
    bps = roofline.decode_bytes_per_step(
        param_bytes=_H100["param_bytes"], batch=8, avg_ctx=128.0,
        num_layers=_H100["num_layers"], kv_heads=_H100["kv_heads"],
        head_dim=_H100["head_dim"], kv_dtype_bytes=_H100["kv_dtype_bytes"])
    want = roofline.grade_decode(8 * 4 / 0.05, batch=8, bytes_per_step=bps,
                                 device_kind=H100_KIND)["pct_hbm_roofline"]
    assert rl["graded_windows"] == 4 and rl["decode_pct_hbm_median"] == round(want, 1)
    # device seconds from the events: the windows' and the prefill's, not
    # the dispatches' enqueue or the fetches' wait; the fetch is waiting
    assert rank0["device_s"] == pytest.approx(4 * 0.05 + 0.25)
    assert rank0["wait_s"] == pytest.approx(4 * 0.08)
    assert rank0["stages"]["decode_fetch"]["count"] == 4
    # a document without events (old dumps, the CPU) falls back on the
    # spans' durations: the dispatch is the window's device stage
    old = doctor.diagnose(_pipelined_h100(False), status="SUCCEEDED")["processes"]["rank0"]
    assert old["roofline"]["graded_windows"] == 4
    assert old["device_s"] == pytest.approx(0.3 + 4 * 0.002)
    assert old["wait_s"] == pytest.approx(4 * 0.08)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SUTRO_HOME", str(tmp_path_factory.mktemp("torch-doctor")))
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    mp.setattr(so._instance, "_engine", eng)
    yield eng
    assert eng.close(timeout=30)
    mp.undo()


def test_getters_after_an_embedding_job(engine):
    jid = engine.submit_batch_inference({"model": "tiny-emb",
                                         "inputs": [f"row {i}" for i in range(10)]})
    assert wait(engine, jid) == "SUCCEEDED"
    tel = so.get_job_telemetry(jid)
    assert "embed" in tel["stages"] and tel["counters"]["rows_ok"] == 10
    assert tel["counters"]["input_tokens"] == engine.get_job(jid)["input_tokens"]
    assert tel["attrs"]["device"]["device_kind"] == "cpu"
    assert engine.get_job(jid)["has_telemetry_dump"]
    chrome = so.get_trace(jid)
    names = {ev["name"] for ev in chrome["traceEvents"] if ev["ph"] == "X"}
    assert {"embed", "flush", "finalize"} <= names
    diag = so.diagnose_job(jid)
    assert diag["verdict"] in doctor.VERDICTS
    assert "no roofline spec" in diag["processes"]["rank0"]["roofline"]["reason"]
    with pytest.raises(KeyError):
        so.get_trace("job-none")
    text = so.get_metrics_text()
    assert "sutro_rows_total" in text and 'stage="embed"' in text


def test_diagnose_grades_an_h100_runner_against_its_row(engine):
    # the engine builds its tiny-emb runner at its first tiny-emb job
    # (this test may run without the one above, on another xdist worker)
    jid = engine.submit_batch_inference({"model": "tiny-emb", "inputs": ["warm"]})
    assert wait(engine, jid) == "SUCCEEDED"
    runner = engine._runner_cache["tiny-emb"][0]
    real = runner.device_info
    mp = pytest.MonkeyPatch()
    mp.setattr(runner, "device_info", lambda: {**real(), "device_kind": H100_KIND})
    try:
        jid = engine.submit_batch_inference({"model": "tiny-emb", "inputs": ["a", "b c"]})
        assert wait(engine, jid) == "SUCCEEDED"
    finally:
        mp.undo()
    rl = so.diagnose_job(jid)["processes"]["rank0"]["roofline"]
    assert rl["device_kind"] == H100_KIND and "reason" not in rl
