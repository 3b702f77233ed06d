"""The port's distributed telemetry (``telemetry/distributed.py``, the
registry's snapshot/delta and federation, the doctor's dp verdicts)
against the JAX package's: each scenario of
``tests/test_distributed_telemetry.py`` run through both packages with
the same result, and the doctor's golden diagnosis equal to the
reference's pinned file.
"""

import importlib
import json
import threading
import time
from pathlib import Path

import pytest

from tests.test_torch_dphost import PACKAGES, both
from tests.test_telemetry import assert_valid_prometheus

DOCTOR_GOLDEN = Path(__file__).parent / "data" / "doctor_verdict.golden"


class Tel:
    """One package's telemetry pieces."""

    def __init__(self, root):
        self.root = root
        self.telemetry = importlib.import_module(f"{root}.telemetry")
        self.distributed = importlib.import_module(f"{root}.telemetry.distributed")
        self.doctor = importlib.import_module(f"{root}.telemetry.doctor")
        registry = importlib.import_module(f"{root}.telemetry.registry")
        spans = importlib.import_module(f"{root}.telemetry.spans")
        self.MetricsRegistry = registry.MetricsRegistry
        self.snapshot_delta = registry.snapshot_delta
        self.FlightRecorder = spans.FlightRecorder
        self.JobTelemetryStore = spans.JobTelemetryStore


def each(fn, *args):
    """``fn(Tel(root), *args)`` for both packages; equal results."""
    got = {root: fn(Tel(root), *args) for root in PACKAGES}
    assert got["sutro_tpu_torch"] == got["sutro_tpu"], got
    return got["sutro_tpu_torch"]


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for root in PACKAGES:
        t = Tel(root).telemetry
        t.reset_for_tests()
        t.set_enabled(True)
    yield
    for root in PACKAGES:
        t = Tel(root).telemetry
        t.reset_for_tests()
        t.set_enabled(True)


# ---------------------------------------------------------------------------
# wire pieces
# ---------------------------------------------------------------------------


def _trace_context(T):
    ctx = T.distributed.trace_context("job-x", 3)
    T.telemetry.set_enabled(False)
    off = T.distributed.trace_context("job-x", 4)
    T.telemetry.set_enabled(True)
    # the recorder's epoch is each process clock's own
    assert ctx.pop("epoch_unix") == T.telemetry.RECORDER.epoch_wall
    return {"ctx": ctx, "off": off, "wire": T.distributed.WIRE_VERSION}


def test_trace_context_versioned_and_disabled_off():
    got = each(_trace_context)
    assert got["ctx"]["v"] == got["wire"]
    assert got["ctx"]["trace"] == "job-x/r3" and got["ctx"]["round"] == 3
    assert got["off"] is None


def _foreign_wire(T):
    w = T.distributed.WorkerTelemetry("j", 1)
    w2 = T.distributed.WorkerTelemetry("j", 1)  # no context (old coordinator)
    return [
        w.begin({"v": T.distributed.WIRE_VERSION + 1}), w.payload(),
        w2.begin(None), w2.payload(),
    ]


def test_worker_telemetry_rejects_foreign_wire_version():
    assert each(_foreign_wire) == [False, None, False, None]


def _spans_bounded(T, monkeypatch):
    monkeypatch.setattr(T.distributed, "MAX_SHIP_SPANS", 16)
    rec = T.FlightRecorder(capacity=256)
    w = T.distributed.WorkerTelemetry(
        "j", 1, registry=T.MetricsRegistry(), recorder=rec, jobs=T.JobTelemetryStore()
    )
    assert w.begin(T.distributed.trace_context("j", 1)) is True
    for i in range(40):
        rec.record("accept", "j", time.monotonic(), 0.001, {"i": i})
    p = w.payload()
    return {
        "n": len(p["spans"]), "dropped": p["spans_dropped"],
        "last": p["spans"][-1]["name"], "v": p["v"] == T.distributed.WIRE_VERSION,
        "rank": p["rank"], "names": [s["name"] for s in p["spans"]],
    }


def test_worker_payload_spans_bounded(monkeypatch):
    got = each(_spans_bounded, monkeypatch)
    # 40 spans + the dp_round envelope, capped at the 16 newest
    assert got["n"] == 16 and got["dropped"] == 25
    assert got["last"] == "dp_round" and got["v"] and got["rank"] == 1


def _snapshot_delta(T):
    r = T.MetricsRegistry()
    c = r.counter("d_total", "x", labels=("k",))
    h = r.histogram("d_seconds", "x", buckets=(0.1, 1.0))
    g = r.gauge("d_gauge", "x")
    c.inc(5, "a")
    h.observe(0.05)
    g.set(1.0)
    before = r.export_snapshot()
    c.inc(2, "a")
    c.inc(1, "b")
    h.observe(5.0)
    g.set(42.0)
    d = T.snapshot_delta(before, r.export_snapshot())
    d2 = T.snapshot_delta(r.export_snapshot(), r.export_snapshot())
    return {"d": d, "quiet": (d2["counters"], d2["hists"])}


def test_snapshot_delta_counters_hists_gauges():
    got = each(_snapshot_delta)
    d = got["d"]
    assert d["counters"] == [["d_total", ["a"], 2.0], ["d_total", ["b"], 1.0]]
    ((name, _lv, acc),) = d["hists"]
    assert name == "d_seconds" and acc[-1] == 1.0  # one new observation
    assert ["d_gauge", [], 42.0] in d["gauges"]  # the value, not a delta
    assert got["quiet"] == ([], [])


def _federate(T):
    r = T.MetricsRegistry()
    r.counter("f_total", "x", labels=("k",)).inc(10, "a")
    r.histogram("f_seconds", "x", buckets=(0.1, 1.0)).observe(0.5)
    shard = {
        "counters": [["f_total", ["a"], 3.0]],
        "hists": [["f_seconds", [], [1.0, 0.0, 0.0, 0.05, 1.0]]],
        "gauges": [],
    }
    r.ingest_remote("1", shard)
    r.ingest_remote("1", shard)  # deltas accumulate per worker
    text = r.to_prometheus()
    assert_valid_prometheus(text)
    return {"snap": r.collect(), "lines": sorted(
        ln for ln in text.splitlines() if ln.startswith("f_total{")
    )}


def test_ingest_remote_federates_with_worker_label():
    got = each(_federate)
    snap = got["snap"]
    assert snap["f_total"]["labels"] == ["k", "worker"]
    assert snap["f_total"]["series"]["a,0"] == 10.0
    assert snap["f_total"]["series"]["a,1"] == 6.0
    assert snap["f_seconds"]["series"]["1"]["count"] == 2
    assert 'f_total{k="a",worker="0"} 10' in got["lines"]
    assert 'f_total{k="a",worker="1"} 6' in got["lines"]


def _malformed(T):
    r = T.MetricsRegistry()
    r.counter("k_total", "x")
    r.ingest_remote("1", {
        "counters": [
            ["unknown_total", [], 5.0],  # undeclared -> skipped
            ["k_total", ["extra"], 1.0],  # label arity mismatch
            ["k_total"],  # malformed triple
            ["k_total", [], 2.0],  # valid
        ],
        "hists": [["k_total", [], [1.0]]],  # wrong kind -> skipped
    })
    return r.collect()["k_total"]["series"]


def test_ingest_remote_skips_unknown_and_malformed():
    assert each(_malformed) == {"1": 2.0}


def _cardinality(T):
    r = T.MetricsRegistry()
    r.counter("w_total", "x")
    for i in range(T.MetricsRegistry.MAX_WORKERS + 10):
        r.ingest_remote(str(i + 1), {"counters": [["w_total", [], 1.0]]})
    return {"series": r.collect()["w_total"]["series"], "max": T.MetricsRegistry.MAX_WORKERS}


def test_ingest_remote_worker_cardinality_bounded():
    got = each(_cardinality)
    assert got["series"]["_overflow"] == 10.0
    # a bounded store: at most MAX_WORKERS + overflow + local
    assert len(got["series"]) <= got["max"] + 2


def _store_rounds(T):
    store = T.distributed.DistributedTelemetry(max_sections=4)
    rounds = [store.next_round("j"), store.next_round("j")]
    payload = {
        "v": T.distributed.WIRE_VERSION, "rank": 1, "round": 1,
        "epoch_unix": T.telemetry.RECORDER.epoch_wall,
        "spans": [{"name": "accept", "t0_s": 1.0, "dur_s": 0.5}],
        "counters": {"rows_ok": 3}, "registry": {},
    }
    ingests = [
        store.ingest("j", 1, payload),
        # the same (round, rank) replaces (a reconnect's retry), a new rank adds
        store.ingest("j", 1, payload),
        store.ingest("j", 2, {**payload, "rank": 2}),
    ]
    secs = store.sections("j")
    got = {
        "rounds": rounds, "ingests": ingests,
        "sections": [(s["round"], s["rank"]) for s in secs],
        "t0_coord": round(secs[0]["spans"][0]["t0_coord_s"], 6),
        # wire-version drift and garbage degrade to False, never raise
        "refused": [
            store.ingest("j", 3, {**payload, "v": 99}),
            store.ingest("j", 3, "not a dict"),
            store.ingest("j", 3, {**payload, "round": "NaNsense"}),
        ],
    }
    for rr in range(3, 9):
        store.ingest("j", rr, {**payload, "rank": rr})
    got["capped"] = len(store.sections("j")) <= 4
    return got


def test_distributed_store_rounds_and_bounds():
    assert each(_store_rounds) == {
        "rounds": [1, 2], "ingests": [True, True, True],
        "sections": [(1, 1), (1, 2)], "t0_coord": 1.0,
        "refused": [False, False, False], "capped": True,
    }


# ---------------------------------------------------------------------------
# a channel round with telemetry riding the frames
# ---------------------------------------------------------------------------


def _run_round(P, port, worker_tele, tele_ctx, on_worker_tele, worker_spans=3):
    """One coordinator/worker round over localhost with stub shards;
    returns (outcome, merged row ids)."""
    cw, ww = P.worlds(port)
    reqs = P.reqs(8)
    merged, out = {}, {}

    def coord_shard(shard, on_result, on_progress, should_cancel):
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    def worker_shard(shard, on_result, on_progress, should_cancel):
        for _ in range(worker_spans):
            P.telemetry.RECORDER.record(
                "decode_window", "wjob", time.monotonic(), 0.004,
                {"batch": 8, "steps": 4, "avg_ctx": 64.0},
            )
        P.telemetry.TOKENIZE_ROWS_TOTAL.inc(float(len(shard)))
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    def worker_main():
        out["w"] = P.dphost.run_dp_worker(
            ww, worker_shard, P.dphost.shard_requests(reqs, 1, 2), tele=worker_tele,
        )

    t = threading.Thread(target=worker_main)
    t.start()
    outcome = P.dphost.run_dp_coordinator(
        cw, coord_shard, P.dphost.shard_requests(reqs, 0, 2),
        on_result=lambda r: merged.__setitem__(r.row_id, r),
        tele_ctx=tele_ctx, on_worker_tele=on_worker_tele,
    )
    t.join(timeout=120)
    assert not t.is_alive()
    assert out["w"] == "completed"
    return outcome, sorted(merged)


def _ships_shard(P, port):
    dist = P.telemetry.distributed
    store = dist.DistributedTelemetry()
    ctx = dist.trace_context("cjob", store.next_round("cjob"))
    got = []

    def on_worker_tele(rank, shard):
        got.append((rank, shard))
        store.ingest("cjob", rank, shard)

    outcome, merged = _run_round(P, port, dist.WorkerTelemetry("wjob", 1), ctx, on_worker_tele)
    ((rank, shard),) = got
    (sec,) = store.sections("cjob")
    snap = P.telemetry.REGISTRY.collect()
    assert_valid_prometheus(P.telemetry.REGISTRY.to_prometheus())
    tok = snap["sutro_tokenize_rows_total"]
    return {
        "outcome": outcome, "merged": merged, "rank": rank, "trace": shard["trace"],
        "span_names": [s["name"] for s in sec["spans"]],
        "federated": (tok["labels"][-1], tok["series"]["1"]),
        "tele_shard_events": snap["sutro_dp_events_total"]["series"]["tele_shard"],
    }


def test_channel_round_ships_worker_shard():
    got = both(_ships_shard)
    assert got["outcome"] == "completed" and got["merged"] == list(range(8))
    assert got["rank"] == 1 and got["trace"] == "cjob/r1"
    assert got["span_names"].count("decode_window") == 3
    assert got["span_names"][-1] == "dp_round"
    # the worker's registry delta federated into the live registry
    assert got["federated"] == ("worker", 4.0)
    assert got["tele_shard_events"] == 1


def _old_worker(P, port):
    dist = P.telemetry.distributed
    store = dist.DistributedTelemetry()
    ctx = dist.trace_context("cjob", store.next_round("cjob"))
    got = []
    outcome, merged = _run_round(P, port, None, ctx, lambda r, s: got.append(r))
    doctor = importlib.import_module(f"{P.root}.telemetry.doctor")
    diag = doctor.diagnose({
        "job_id": "cjob",
        "spans": [
            {"name": "dp_round", "t0_s": 0.0, "dur_s": 2.0, "attrs": {"world": 2}},
            {"name": "decode_window", "t0_s": 0.1, "dur_s": 1.5},
        ],
        "counters": {"rows_ok": 8},
    })
    return {
        "outcome": outcome, "n": len(merged), "got": got,
        "sections": store.sections("cjob"), "diag": diag,
    }


def test_channel_old_worker_degrades_to_partial_data():
    """A worker that ships nothing: the round completes, the document
    reports partial data and the doctor names the silent rank."""
    got = both(_old_worker)
    assert got["outcome"] == "completed" and got["n"] == 8
    assert got["got"] == [] and got["sections"] == []
    diag = got["diag"]
    assert diag["partial"] is True and diag["missing_ranks"] == [1]
    assert any("rank(s) 1" in e for e in diag["evidence"])
    assert diag["verdict"] != "insufficient_data"


def _old_coordinator(P, port):
    w = P.telemetry.distributed.WorkerTelemetry("wjob", 1)
    outcome, merged = _run_round(P, port, w, None, None)
    return {"outcome": outcome, "n": len(merged), "payload": w.payload()}


def test_channel_old_coordinator_worker_ships_nothing():
    """No trace context from the coordinator: the worker's session stays
    inert and the round completes."""
    assert both(_old_coordinator) == {"outcome": "completed", "n": 8, "payload": None}


# ---------------------------------------------------------------------------
# doctor
# ---------------------------------------------------------------------------


def _span(name, t0, dur, **attrs):
    d = {"name": name, "job_id": "j", "t0_s": t0, "dur_s": dur}
    if attrs:
        d["attrs"] = attrs
    return d


_V5E = {
    "device_kind": "TPU v5 lite", "n_devices": 1,
    "param_bytes": 2_000_000_000, "n_params": 1_000_000_000,
    "num_layers": 24, "kv_heads": 8, "head_dim": 128, "kv_dtype_bytes": 2,
}


def _diagnose(T, doc):
    return T.doctor.diagnose(json.loads(json.dumps(doc)))


def test_doctor_straggler_worker():
    diag = each(_diagnose, {
        "job_id": "j",
        "spans": [_span("dp_round", 0.0, 10.0, world=3), _span("decode_window", 0.0, 2.0)],
        "counters": {"rows_ok": 10},
        "workers": [
            {"rank": 1, "round": 1, "spans": [_span("decode_window", 0.0, 2.0)],
             "counters": {"rows_ok": 5}},
            {"rank": 2, "round": 1, "spans": [_span("decode_window", 0.0, 9.5)],
             "counters": {"rows_ok": 5}},
        ],
    })
    assert diag["verdict"] == "straggler_worker"
    assert any("rank2" in e for e in diag["evidence"])
    assert diag["processes"]["rank2"]["wall_s"] == 9.5


def test_doctor_host_bound_admit():
    diag = each(_diagnose, {
        "job_id": "j",
        "spans": [_span("constraint_compile", 0.0, 4.0), _span("accept", 4.0, 1.0),
                  _span("decode_window", 5.0, 1.0)],
        "counters": {},
    })
    assert diag["verdict"] == "host_bound_admit"
    assert any("constraint_compile" in e for e in diag["evidence"])


def test_doctor_io_bound():
    diag = each(_diagnose, {
        "job_id": "j",
        "spans": [_span("flush", 0.0, 3.0), _span("finalize", 3.0, 2.0),
                  _span("decode_window", 5.0, 1.0), _span("tokenize", 6.0, 0.1)],
        "counters": {},
    })
    assert diag["verdict"] == "io_bound"


def test_doctor_decode_below_roofline():
    # 8 rows x 4 steps in 80 ms: far under the roofline for this budget
    diag = each(_diagnose, {
        "job_id": "j",
        "attrs": {"device": _V5E},
        "spans": [_span("decode_window", 0.0, 0.08, batch=8, steps=4, avg_ctx=128.0)
                  for _ in range(4)],
        "counters": {"rows_ok": 8, "input_tokens": 1024, "output_tokens": 256},
    })
    assert diag["verdict"] == "decode_below_roofline"
    rl = diag["processes"]["rank0"]["roofline"]
    assert rl["graded_windows"] == 4 and rl["decode_pct_hbm_median"] < 40.0


def test_doctor_unknown_device_grades_omitted_not_fabricated():
    diag = each(_diagnose, {
        "job_id": "j",
        "attrs": {"device": {**_V5E, "device_kind": "cpu"}},
        "spans": [_span("decode_window", 0.0, 0.08, batch=8, steps=4)],
        "counters": {},
    })
    rl = diag["processes"]["rank0"]["roofline"]
    assert rl["graded_windows"] == 0 and "no roofline spec" in rl["reason"]
    assert diag["verdict"] == "healthy"


def test_doctor_golden_pinned():
    """The reference's deterministic merged document (a 2-worker dp job,
    rank 2 straggling, graded v5e decode windows): the port's diagnosis
    equals the reference's pinned file byte for byte."""
    from tests.test_distributed_telemetry import _golden_case

    port = importlib.import_module("sutro_tpu_torch.telemetry.doctor")
    got = json.dumps(port.diagnose(**_golden_case()), indent=2) + "\n"
    assert got == DOCTOR_GOLDEN.read_text()
