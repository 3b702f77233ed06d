"""The port's live SLO monitor (``telemetry/monitor.py``) against the JAX
package's.

- ``percentile_from_buckets`` gives the JAX function's value on seeded
  accumulators, edge cases included (exact equality: the same float
  arithmetic);
- the rule state machines (the stock rules and a few of their own, with
  dormant ticks) emit the same alert events over the same seeded
  series;
- ``_window_stats`` and the rules give the same document and events,
  tick by tick, over identical registry feeds: two fresh registries (one
  of each package's ``MetricsRegistry``) fed the same seeded counters,
  gauges and histograms, sampled into each monitor's ring at the same
  timestamps;
- over the port's server, ``GET /monitor`` serves the document (the JAX
  engine's keys and stock rules) and ``GET /monitor/stream?ticks=2``
  two NDJSON ticks and an end record, while a job runs;
- the ``telemetry.monitor`` fault degrades the monitor to disabled, and
  the job it watches still succeeds;
- with telemetry off, or ``SUTRO_MONITOR=0``, the engine builds no
  monitor: ``monitor_doc`` raises ``KeyError`` and both routes 404.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sutro_tpu import telemetry as jax_telemetry
from sutro_tpu.telemetry import monitor as jax_monitor
from sutro_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from sutro_tpu_torch import telemetry
from sutro_tpu_torch.engine import api, faults
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.server import start_server_thread
from sutro_tpu_torch.telemetry import monitor
from sutro_tpu_torch.telemetry.registry import DEFAULT_BUCKETS, MetricsRegistry

ENGINE = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4, max_model_len=128,
              param_dtype="float32", activation_dtype="float32", max_new_tokens=8)


# ---------------------------------------------------------------------------
# percentiles and rules on synthetic inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_percentile_from_buckets_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = list(DEFAULT_BUCKETS)
    acc = [float(x) for x in rng.integers(0, 6, len(buckets) + 1)]
    if seed == 0:
        acc = [0.0] * len(acc)                    # empty: None
    elif seed == 1:
        acc = [0.0] * len(buckets) + [5.0]        # all in +Inf: the top bound
    acc += [float(rng.random() * 10), float(sum(acc))]   # sum, count
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        got = monitor.percentile_from_buckets(buckets, acc, q)
        want = jax_monitor.percentile_from_buckets(buckets, acc, q)
        assert got == want, (q, got, want)


def _rule_sets():
    """(port rules, JAX rules): the stock set and three of their own."""
    extra = [dict(name="low_rate", metric="batch_rows_per_s", op="<", threshold=2.0,
                  for_ticks=1, clear_ticks=3),
             dict(name="hot", metric="ttft_p99_s", op=">", threshold=0.3, clear=0.1,
                  for_ticks=3, clear_ticks=1, severity="critical"),
             dict(name="fleet", metric="dp_fleet_size", op="<", threshold=2.0)]
    return ([*monitor.DEFAULT_RULES, *(monitor.SLORule(**d) for d in extra)],
            [*jax_monitor.DEFAULT_RULES, *(jax_monitor.SLORule(**d) for d in extra)])


@pytest.mark.parametrize("seed", range(4))
def test_alert_events_equal_the_reference_over_a_seeded_series(seed, monkeypatch):
    # fresh registries: a firing event carries the TTFT histogram's
    # exemplars, which other tests in the process may have recorded
    monkeypatch.setattr(telemetry, "REGISTRY", MetricsRegistry())
    monkeypatch.setattr(jax_telemetry, "REGISTRY", JaxRegistry())
    rng = np.random.default_rng(100 + seed)
    ours, theirs = (m.Monitor(rules=r) for m, r in zip((monitor, jax_monitor), _rule_sets()))
    events = ([], [])
    for t in range(120):
        stats = {}
        for key, scale in (("ttft_p99_s", 8.0), ("itl_p99_s", 2.0), ("batch_rows_per_s", 3.0),
                           ("quarantine_rate", 0.1), ("dp_fleet_size", 3.0)):
            if rng.random() < 0.85:   # a dormant tick now and then
                stats[key] = float(np.round(rng.random() * scale, 3))
        for mon, out in zip((ours, theirs), events):
            out.extend(mon._evaluate_rules(stats, 1000.0 + t))
    assert events[0] == events[1]
    assert sum(e["state"] == "firing" for e in events[0]) >= 3
    assert {r: s.state for r, s in ours._rule_state.items()} == {
        r: s.state for r, s in theirs._rule_state.items()}


# ---------------------------------------------------------------------------
# window statistics over identical registry feeds
# ---------------------------------------------------------------------------


def _registry(cls):
    """A fresh registry with the series the monitor reads, declared as
    the packages declare them."""
    reg = cls()
    m = dict(
        rows=reg.counter("sutro_rows_total", labels=("outcome",)),
        tokens=reg.counter("sutro_tokens_total", labels=("direction",)),
        failures=reg.counter("sutro_failure_events_total", labels=("event",)),
        running=reg.gauge("sutro_jobs_running"),
        active=reg.gauge("sutro_interactive_active"),
        rps=reg.gauge("sutro_rows_per_second", labels=("workload",)),
        ttft=reg.histogram("sutro_interactive_ttft_seconds"),
        itl=reg.histogram("sutro_interactive_itl_seconds"),
        stage=reg.histogram("sutro_stage_seconds", labels=("stage",)),
        t_rows=reg.counter("sutro_tenant_rows_total", labels=("tenant", "outcome")),
        t_tok=reg.counter("sutro_tenant_tokens_total", labels=("tenant", "direction")),
        t_req=reg.counter("sutro_tenant_requests_total", labels=("tenant", "kind")),
    )
    return reg, m


@pytest.mark.parametrize("seed", range(3))
def test_window_stats_and_rules_equal_the_reference_on_identical_feeds(seed, monkeypatch):
    regs = {"port": _registry(MetricsRegistry), "jax": _registry(JaxRegistry)}
    monkeypatch.setattr(telemetry, "REGISTRY", regs["port"][0])
    monkeypatch.setattr(jax_telemetry, "REGISTRY", regs["jax"][0])
    rules = _rule_sets()
    mons = {"port": monitor.Monitor(window_s=5.0, history=12, rules=rules[0]),
            "jax": jax_monitor.Monitor(window_s=5.0, history=12, rules=rules[1])}
    rng = np.random.default_rng(seed)
    for t in range(40):
        draw = dict(
            ok=int(rng.integers(0, 20)), quar=int(rng.integers(0, 3)) * (t % 7 == 3),
            tin=int(rng.integers(0, 3000)), tout=int(rng.integers(0, 800)),
            fail=int(rng.integers(0, 2)), running=float(t % 11 < 8),
            active=float(rng.integers(0, 4)), rps=float(np.round(rng.random() * 50, 2)),
            ttft=np.round(rng.lognormal(-1.0, 1.2, int(rng.integers(0, 6))), 4).tolist(),
            itl=np.round(rng.lognormal(-4.0, 1.0, int(rng.integers(0, 30))), 5).tolist(),
            stage=[(s, float(np.round(rng.random(), 4))) for s in ("prefill", "decode_window")
                   for _ in range(int(rng.integers(0, 3)))],
            tenant=["acme", "beta"][int(rng.integers(0, 2))],
        )
        out = {}
        for name, (reg, m) in regs.items():
            m["rows"].inc(draw["ok"], "ok")
            if draw["quar"]:
                m["rows"].inc(draw["quar"], "quarantined")
            m["tokens"].inc(draw["tin"], "in")
            m["tokens"].inc(draw["tout"], "out")
            if draw["fail"]:
                m["failures"].inc(1.0, "row_retry")
            m["running"].set(draw["running"])
            m["active"].set(draw["active"])
            m["rps"].set(draw["rps"], "generate")
            for v in draw["ttft"]:
                m["ttft"].observe(v)
            for v in draw["itl"]:
                m["itl"].observe(v)
            for s, v in draw["stage"]:
                m["stage"].observe(v, s)
            m["t_rows"].inc(draw["ok"], draw["tenant"], "ok")
            m["t_tok"].inc(draw["tout"], draw["tenant"], "out")
            m["t_req"].inc(1.0, draw["tenant"], "batch")
            mon = mons[name]
            mon._ring.append((float(t), 1000.0 + t, reg.export_snapshot()))
            stats = mon._window_stats()
            out[name] = (stats, mon._evaluate_rules(stats, 1000.0 + t))
        assert out["port"] == out["jax"], t
    stats = out["port"][0]
    assert stats["window_s"] == 5.0 and stats["percentiles"]["ttft"]["count"] >= 0
    assert set(stats["tenants"]) == {"acme", "beta"}


# ---------------------------------------------------------------------------
# the engine's monitor and the server's routes
# ---------------------------------------------------------------------------


@pytest.fixture
def engine(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_MONITOR_INTERVAL", "0.05")
    monkeypatch.setenv("SUTRO_MONITOR_WINDOW", "2")
    monkeypatch.delenv("SUTRO_MONITOR", raising=False)
    monkeypatch.delenv("SUTRO_CONTROL", raising=False)
    telemetry.set_enabled(True)
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    yield eng
    faults.clear()
    assert eng.close(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def _run_job(eng, rows=6, max_new=8):
    jid = eng.submit_batch_inference({
        "model": "tiny-dense", "inputs": [f"row {i} of the job" for i in range(rows)],
        "sampling_params": {"temperature": 0.0, "max_new_tokens": max_new}})
    deadline = time.monotonic() + 120
    while eng.job_status(jid) not in ("SUCCEEDED", "FAILED", "CANCELLED"):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return jid


def test_monitor_routes_over_the_port_server(engine, tmp_path, monkeypatch):
    srv, thread, url = start_server_thread(engine)
    try:
        assert engine.job_status(_run_job(engine)) == "SUCCEEDED"
        status, body = _get(f"{url}/monitor")
        doc = json.loads(body)["monitor"]
        assert status == 200 and doc["enabled"] and doc["running"] and doc["ticks"] >= 1
        assert "enforcement" not in doc   # no control plane
        status, body = _get(f"{url}/monitor/stream?ticks=2")
        recs = [json.loads(line) for line in body.decode().splitlines() if line]
        assert status == 200 and [r["t"] for r in recs] == ["tick", "tick", "end"]
        assert recs[0]["seq"] < recs[1]["seq"] and recs[-1]["degraded"] is None
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    # the JAX engine's document has the same keys and stock rules
    from sutro_tpu.engine.api import LocalEngine as JaxEngine
    from sutro_tpu.engine.config import EngineConfig as JaxConfig

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "jax-home"))
    jeng = JaxEngine(JaxConfig(use_pallas=False, **ENGINE))
    try:
        jdoc = jeng.monitor_doc()
    finally:
        jeng.close(timeout=30)
    assert set(doc) == set(jdoc)
    assert [r["name"] for r in doc["rules"]] == [r["name"] for r in jdoc["rules"]]
    # the keys ``_window_stats`` can give (their values are held to the
    # JAX monitor's above, on identical feeds)
    assert {"window_s", "rates", "percentiles", "gauges", "tenants"} <= set(doc["stats"]) <= {
        "window_s", "rates", "percentiles", "gauges", "tenants", "quarantine_rate",
        "batch_rows_per_s", "dp_fleet_size", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
        "itl_p99_s"}


def test_the_monitor_fault_degrades_it_to_disabled(engine):
    faults.configure("telemetry.monitor:error:times=1")
    deadline = time.monotonic() + 30
    while engine.monitor.failed is None:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    faults.clear()
    doc = engine.monitor_doc()
    assert doc["degraded"] and not doc["running"] and not engine.monitor.running
    # a broken monitor never fails a job
    assert engine.job_status(_run_job(engine)) == "SUCCEEDED"


@pytest.mark.parametrize("switch", ["telemetry", "env"])
def test_no_monitor_when_telemetry_or_its_switch_is_off(tmp_path, monkeypatch, switch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    was = telemetry.ENABLED
    if switch == "telemetry":
        telemetry.set_enabled(False)
    else:
        monkeypatch.setenv("SUTRO_MONITOR", "0")
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    srv, thread, url = start_server_thread(eng)
    try:
        assert eng.monitor is None
        with pytest.raises(KeyError):
            eng.monitor_doc()
        for path in ("monitor", "monitor/stream?ticks=1"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{url}/{path}")
            assert e.value.code == 404
    finally:
        telemetry.set_enabled(was)
        srv.shutdown()
        thread.join(timeout=30)
        assert eng.close(timeout=30)
