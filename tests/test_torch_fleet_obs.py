"""The port's fleet observability plane (``fleet/obs.py``,
``fleet/replay.py``) against the JAX package's.

Layout follows ``tests/test_fleet_obs.py``:

1. units, each driven alike through both packages: the stitched export
   with pinned clocks (equal to the JAX package's golden file), its
   re-anchoring and clock-skew clamp, the degrade to router-only lanes;
   the federated delta cache; ``observe_route``; ``synthetic_records``
   for one seed; ``records_from_traces``; the open-loop replay driver
   against a stub server;
2. the fleet rules' catalog, and ``FleetMonitor`` firing and resolving
   on scripted ticks;
3. one stitched trace through a two-replica port fleet, and the SDK's
   fleet getters over it.
"""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import requests  # noqa: F401 — the JAX replay imports it in each request's
# thread: imported here, its first import does not delay the first arrival

from sutro_tpu import telemetry as jax_telemetry
from sutro_tpu.fleet import frames as jax_frames
from sutro_tpu.fleet import obs as jax_obs
from sutro_tpu.fleet import replay as jax_replay
from sutro_tpu.fleet import router as jax_router
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.telemetry import registry as jax_registry
from sutro_tpu.telemetry import traceexport as jax_traceexport
from sutro_tpu.telemetry import traces as jax_traces
from sutro_tpu_torch import telemetry
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.fleet import frames, obs, replay, router
from sutro_tpu_torch.fleet.membership import CLOSED
from sutro_tpu_torch.sdk import Sutro
from sutro_tpu_torch.server import start_server_thread
from sutro_tpu_torch.telemetry import registry, traceexport, traces
from tests.test_torch_fleet import FLEET, _post, _wait
from tests.test_torch_weights_loader import write_hf_checkpoint

GOLDEN = Path(__file__).parent / "data" / "fleet_trace_export.golden"
PACKAGES = {
    "jax": (jax_obs, jax_frames, jax_traces, jax_traceexport, jax_registry, jax_replay,
            jax_router, jax_telemetry),
    "port": (obs, frames, traces, traceexport, registry, replay, router, telemetry),
}

pytestmark = pytest.mark.skipif(
    not (telemetry.ENABLED and jax_telemetry.ENABLED),
    reason="fleet observability needs telemetry",
)


def _both(fn):
    return fn(*PACKAGES["jax"]), fn(*PACKAGES["port"])


# ---------------------------------------------------------------------
# 1a. stitching: the golden export with pinned clocks, the skew clamp
# ---------------------------------------------------------------------

SKEW_S = 0.004


def _golden_stitched_doc(ob, fr, tr, skew_s=SKEW_S):
    store = tr.TraceStore()
    half = store.start_trace("tr-fr-1", "interactive", {"model": "tiny-dense"},
                             t0_mono=500.0, created_unix=1700000000.0 + skew_s)
    half.add("admit_gateway", 500.0, 0.0004, {"slot": 0})
    half.add("prefill", 500.0008, 0.003, {"tokens": 7})
    half.add("decode_window", 500.004, 0.0025, {"steps": 4})
    half.end("ok")
    rdoc = half.to_doc()

    def canned_send(method, url, timeout=None):
        assert method == "get" and url.endswith("/trace-doc/tr-fr-1")
        return fr.trace_doc_frame(1700000000.2, rdoc)

    o = ob.FleetObservability(send=canned_send)
    tid = o.trace_begin("interactive", {"kind": "chat", "model": "tiny-dense"},
                        t0_mono=100.0, created_unix=1700000000.0)
    assert tid == "tr-fr-1"
    o.span(tid, "route_pick", 100.0, 0.0031, {"n_candidates": 2})
    o.span(tid, "affinity_probe", 100.0005, 0.0018, {"n_healthy": 2})
    o.annotate(tid, {"replica": "r1", "replica_url": "http://rb"})
    o.span(tid, "upstream_connect", 100.0032, 0.0009, {"rid": "r1", "status": 200})
    o.event(tid, "first_byte", {"rid": "r1"}, t_mono=100.0125)
    o.end(tid, "ok")
    return o.stitch_trace(tid)


@pytest.mark.parametrize("skew", [SKEW_S, 0.0, -0.25, 1.5])
def test_the_stitched_export_matches_the_jax_package(skew):
    def run(ob, fr, tr, te, *_):
        doc = _golden_stitched_doc(ob, fr, tr, skew)
        return doc, te.render(te.stitched_to_chrome(doc)), te.stitched_spans(doc)

    (jdoc, jtext, jspans), (doc, text, spans) = _both(run)
    assert (doc, text, spans) == (jdoc, jtext, jspans)
    assert doc["processes"][1]["t_off_s"] == max(0.0, skew)
    assert all(s["t0_s"] >= 0.0 for s in spans)
    if skew == SKEW_S:
        assert text == GOLDEN.read_text()
        by_name = {s["name"]: s for s in spans}
        assert by_name["admit_gateway"]["t0_s"] >= by_name["route_pick"]["t0_s"]


def test_the_stitch_degrades_to_router_only_as_the_jax_package():
    def run(ob, *_):
        def dead_send(method, url, timeout=None):
            raise OSError("connection refused")

        out = []
        for send in (dead_send, lambda *a, **k: {"t": "nope"}):
            o = ob.FleetObservability(send=send)
            tid = o.trace_begin("interactive", t0_mono=1.0, created_unix=2.0)
            o.span(tid, "route_pick", 1.0, 0.001)
            o.annotate(tid, {"replica": "r0", "replica_url": "http://gone"})
            o.end(tid, "error")
            out.append([p["process"] for p in o.stitch_trace(tid)["processes"]])
            out.append(o.stitch_trace("tr-fr-404"))
        return out

    jax_out, port_out = _both(run)
    assert port_out == jax_out == [["router"], None, ["router"], None]


# ---------------------------------------------------------------------
# 1b. federation, route latency
# ---------------------------------------------------------------------


class _FakeMembership:
    def __init__(self, rows):
        self.rows = rows

    def all(self):
        return list(self.rows)


def test_the_federated_delta_cache_matches_the_jax_package():
    def run(ob, fr, tr, te, reg_mod, *_):
        def snap(n):
            reg = reg_mod.MetricsRegistry()
            c = reg.counter("sutro_interactive_requests_total", "requests",
                            labels=("outcome",), max_series=8)
            for _ in range(n):
                c.inc(1, "ok")
            reg.gauge("sutro_interactive_active", "in flight").set(3.0)
            return reg.export_snapshot()

        sent = []

        def send(method, url, timeout=None):
            sent.append(url)
            return fr.metrics_snapshot_frame(0.0, send.snap)

        send.snap = snap(5)
        o = ob.FleetObservability(scrape_interval_s=10.0, send=send)
        mem = _FakeMembership([
            {"rid": "rA", "url": "http://a", "state": CLOSED, "fleet_obs": True},
            {"rid": "rOld", "url": "http://b", "state": CLOSED, "fleet_obs": False},
        ])
        ns = [o.federate(mem, now=100.0), o.federate(mem, now=100.5)]
        send.snap = snap(8)
        ns.append(o.federate(mem, now=111.0))
        remote = {w: sorted((n, lv, v) for (n, lv), v in sh["counters"].items())
                  for w, sh in o.registry._remote.items()}
        text = [ln for ln in o.registry.to_prometheus().splitlines()
                if 'replica="' in ln]
        return ns, sent, remote, o.registry._remote["rA"]["gauges"], text

    jax_out, port_out = _both(run)
    assert port_out == jax_out
    ns, sent, remote, gauges, text = port_out
    assert ns == [1, 0, 1] and sent == ["http://a/metrics-snapshot"] * 2
    assert sum(v for n, _, v in remote["rA"]
               if n == "sutro_interactive_requests_total") == 8
    assert gauges == {} and any('replica="_fleet"' in ln for ln in text)
    assert not any("sutro_interactive_active" in ln for ln in text)


def test_observe_route_matches_the_jax_package():
    def run(ob, *rest):
        tel = rest[-1]
        o = ob.FleetObservability(send=lambda *a, **k: None)
        for i, d in enumerate((0.002, 0.004, 0.0007, 0.03)):
            o.observe_route(d, "chat" if i % 2 else "batch", trace_id=f"tr-fr-90{i}")
        tids = sorted(ex.get("trace_id")
                      for ex in o.registry.exemplars("sutro_fleet_route_seconds"))
        return o.route_latency_summary(), tids

    jax_out, port_out = _both(run)
    assert port_out == jax_out
    assert port_out[0]["count"] == 4 and port_out[0]["p99_s"] > 0


def test_telemetry_off_is_a_zero_op(monkeypatch):
    def no_send(method, url, timeout=None):
        raise AssertionError("telemetry off must not touch the network")

    o = obs.FleetObservability(send=no_send)
    monkeypatch.setattr(telemetry, "ENABLED", False)
    tid = o.trace_begin("interactive", {"kind": "chat"})
    assert tid is None
    o.span(tid, "route_pick", 0.0, 0.001)
    o.observe_route(0.001, "chat", trace_id=tid)
    mem = _FakeMembership([{"rid": "rA", "url": "http://a", "state": CLOSED,
                            "fleet_obs": True}])
    assert o.federate(mem, now=1e9) == 0
    assert len(o.traces.ids()) == 0 and o.route_latency_summary() is None


# ---------------------------------------------------------------------
# 1c. replay: synthesis, capture, file format, driver
# ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1234, 7])
def test_synthetic_records_match_the_jax_package(seed):
    got = replay.synthetic_records(n=16, n_sessions=4, seed=seed)
    assert got == jax_replay.synthetic_records(n=16, n_sessions=4, seed=seed)
    assert [r["session_id"] for r in got[:5]] == [
        "replay-sess-0", "replay-sess-1", "replay-sess-2", "replay-sess-3", "replay-sess-0"]


def test_records_from_traces_match_the_jax_package(tmp_path):
    def run(ob, fr, tr, te, reg, rp, *_):
        store = tr.TraceStore()
        body = {"model": "tiny-dense", "messages": [], "stream": True}
        store.start_trace("tr-fr-2", "interactive",
                          rp.replay_attrs(body, True, True, 1000.5, 64))
        store.start_trace("tr-fr-1", "interactive",
                          rp.replay_attrs(body, True, True, 1000.2, 64))
        store.start_trace("tr-fr-3", "interactive",
                          rp.replay_attrs(body, False, False, 1000.9,
                                          rp.REPLAY_BODY_MAX_BYTES + 1))
        store.start_trace("tr-fr-4", "probe", {"kind": "probe"})
        recs = rp.records_from_traces(store)
        path = tmp_path / f"{rp.__name__}.jsonl"
        rp.dump_jsonl(recs, path)
        return recs, path.read_text(), rp.load_jsonl(path) == recs

    jax_out, port_out = _both(run)
    assert port_out == jax_out
    recs = port_out[0]
    assert [r["arrival_offset_s"] for r in recs] == [0.0, 0.3, 0.7]
    assert "body" not in recs[2] and port_out[2]


def test_the_replay_driver_is_open_loop_as_the_jax_package():
    hits = []

    class Stub(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            hits.append((time.perf_counter(), self.path))
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            data = b'data: {"ok": true}\n\ndata: [DONE]\n\n'
            self.send_response(404 if self.path.startswith("/nowhere") else 200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    recs = [
        {"arrival_offset_s": 0.0, "kind": "chat", "body": {"model": "m"}},
        {"arrival_offset_s": 0.4, "kind": "completions", "body": {"model": "m"}},
        {"arrival_offset_s": 0.5, "kind": "chat"},  # no body: skipped
    ]
    docs = {}
    try:
        for name, mod in (("jax", jax_replay), ("port", replay)):
            hits.clear()
            docs[name] = mod.replay(url, recs, speedup=2.0, timeout=30.0)
            ts = sorted(t for t, _ in hits)
            # 0.4 s at 2x replays ~0.2 s after the start, never before
            assert ts[1] - ts[0] >= 0.15, name
            assert sorted(p for _, p in hits) == ["/v1/chat/completions", "/v1/completions"]
        # a 404 is a counted error, not a raise
        docs["refused"] = replay.replay(url + "/nowhere", recs[:1], timeout=10.0)
    finally:
        srv.shutdown()
        srv.server_close()
    keys = ("n", "sent", "ok", "errors", "skipped_no_body")
    assert {k: docs["port"][k] for k in keys} == {k: docs["jax"][k] for k in keys}
    assert docs["port"]["ok"] == 2 and docs["port"]["ttft"]["count"] == 2
    assert docs["refused"]["ok"] == 0 and docs["refused"]["errors"] == ["http 404"]


# ---------------------------------------------------------------------
# 2. the fleet monitor on scripted ticks
# ---------------------------------------------------------------------


def test_the_fleet_rules_catalog_matches_the_jax_package():
    def fields(rules):
        return [(r.name, r.metric, r.op, r.threshold, r.clear, r.for_ticks, r.workload,
                 r.severity) for r in rules]

    assert fields(obs.FLEET_RULES) == fields(jax_obs.FLEET_RULES)
    assert {r.name for r in obs.FLEET_RULES} == {
        "fleet_ttft_p99", "fleet_failover_rate", "fleet_prefix_hit_floor",
        "fleet_replica_imbalance", "fleet_replicas_down"}


def _scripted_monitor(ob, rt):
    """Drive a FleetMonitor through a failover spike and a dead replica
    on hand-driven ticks; returns the rule states after each tick."""
    rtr = rt.FleetRouter(["http://127.0.0.1:1"], probe_interval=3600.0)
    mon = ob.FleetMonitor(rtr, interval_s=0.05, window_s=0.4)
    rtr.obs.observe_route(0.003, "chat", trace_id="tr-fr-7171")
    rtr.membership.note_probe_success("r0", {"ready": True, "draining": False, "load": {}})
    seen = []

    def tick():
        mon.tick()
        doc = mon.snapshot_doc()
        seen.append(sorted(a["name"] for a in doc["alerts"]["active"]))
        return doc

    tick()
    time.sleep(0.05)
    rtr.counters["failover_stream_error"] += 10
    tick()
    time.sleep(0.05)
    doc = tick()
    fired = [e for e in doc["alerts"]["events"]
             if e["rule"] == "fleet_failover_rate" and e["state"] == "firing"]
    # the spike ages out of the 0.4 s window: the rule resolves
    time.sleep(0.6)
    tick()
    time.sleep(0.05)
    doc = tick()
    resolved = any(e["rule"] == "fleet_failover_rate" and e["state"] == "resolved"
                   for e in doc["alerts"]["events"])
    for _ in range(10):  # the breaker opens past the fail threshold
        rtr.membership.note_probe_failure("r0")
    tick()
    time.sleep(0.05)
    doc = tick()
    return (seen, [f["exemplar_trace_ids"] for f in fired], resolved,
            doc["stats"]["n_unhealthy"], doc["verdicts"]["fleet"]["verdict"])


def test_the_fleet_monitor_fires_and_resolves_as_the_jax_package():
    jax_out = _scripted_monitor(jax_obs, jax_router)
    port_out = _scripted_monitor(obs, router)
    assert port_out == jax_out
    seen, exemplars, resolved, n_unhealthy, verdict = port_out
    assert "fleet_failover_rate" in seen[2] and "fleet_failover_rate" not in seen[4]
    assert exemplars and "tr-fr-7171" in exemplars[0] and resolved
    assert "fleet_replicas_down" in seen[-1] and n_unhealthy >= 1.0
    assert verdict != "healthy"


# ---------------------------------------------------------------------
# 3. a stitched trace through a two-replica port fleet
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-fleet-obs")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 17, root / "weights" / "tiny-dense")
    cfg = dict(FLEET, weights_dir=str(root / "weights"))
    mp.setenv("SUTRO_HOME", str(root / "home"))
    # the engines run no monitor thread; the router's fleet monitor runs
    mp.setenv("SUTRO_MONITOR", "0")
    eng_a = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    eng_b = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    mp.setenv("SUTRO_MONITOR", "1")
    srv_a, _, url_a = start_server_thread(eng_a)
    srv_b, _, url_b = start_server_thread(eng_b)
    rtr, fsrv, _, furl = router.start_fleet_thread(
        [url_a, url_b], probe_interval=0.2, monitor_interval=0.25, monitor_window=3.0)
    sdk = Sutro(api_key="fleet-key", base_url=furl, backend="fleet")
    _wait(lambda: rtr.membership.snapshot()["n_healthy"] == 2, timeout=30,
          what="both replicas healthy")
    yield rtr, furl, sdk
    rtr.stop()
    fsrv.shutdown()
    srv_a.shutdown()
    srv_b.shutdown()
    eng_a.close(timeout=30)
    eng_b.close(timeout=30)
    mp.undo()


def test_a_stitched_trace_through_a_two_replica_port_fleet(fleet):
    rtr, furl, sdk = fleet
    before = set(rtr.obs.traces.ids())
    req = urllib.request.Request(
        furl + "/v1/chat/completions", method="POST",
        data=json.dumps({"model": "tiny-dense", "stream": True, "temperature": 0,
                         "max_tokens": 4, "session_id": "stitch-sess",
                         "messages": [{"role": "user", "content": "stitch me"}]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        lines = [ln.strip() for ln in resp if ln.strip()]
    assert lines[-1] == b"data: [DONE]" and lines.count(b"data: [DONE]") == 1
    new = [t for t in rtr.obs.traces.ids() if t not in before]
    assert len(new) == 1 and new[0].startswith("tr-fr-")
    tid = new[0]
    _wait(lambda: rtr.obs.traces.get(tid).finished, timeout=10, what="the trace to end")
    doc = rtr.obs.stitch_trace(tid)
    assert len(doc["processes"]) == 2 and doc["processes"][0]["process"] == "router"
    merged = traceexport.stitched_spans(doc)
    names = {s["name"] for s in merged}
    assert {"route_pick", "upstream_connect", "first_byte"} <= names
    assert {"admit_gateway", "decode_window"} <= names
    assert all(s["t0_s"] >= 0.0 for s in merged), merged
    with urllib.request.urlopen(f"{furl}/trace/{tid}", timeout=30) as resp:
        chrome = json.loads(resp.read())
    assert chrome["otherData"]["trace_id"] == tid
    procs = chrome["otherData"]["processes"]
    assert procs[0] == "router" and procs[1].startswith("replica r")
    # federated metrics under the replica label, the census exact
    time.sleep(0.3)
    status, text = _post(furl + "/v1/chat/completions",
                         {"model": "tiny-dense", "max_tokens": 3,
                          "messages": [{"role": "user", "content": "fodder"}]})
    assert status == 200
    time.sleep(0.3)
    text = sdk.get_metrics_text()
    ttft = [ln for ln in text.splitlines()
            if ln.startswith("sutro_interactive_ttft_seconds")]
    assert any('replica="r0"' in ln or 'replica="r1"' in ln for ln in ttft)
    assert any('replica="_fleet"' in ln for ln in ttft)
    assert "sutro_fleet_route_seconds" in text and "tr-fr-" in text
    assert 'sutro_fleet_replicas{state="healthy"} 2' in text


def test_the_sdk_fleet_getters_over_a_port_router(fleet, tmp_path):
    rtr, furl, sdk = fleet
    snap = sdk.get_fleet()
    assert snap["n_healthy"] == 2 and snap["probe_only_routes"] == 0
    _wait(lambda: rtr.monitor is not None and rtr.monitor.snapshot_doc()["ticks"] >= 1,
          timeout=15, what="a fleet monitor tick")
    mon = sdk.get_fleet_monitor()
    assert mon["running"] and mon["degraded"] is None
    assert {r["name"] for r in mon["rules"]} == {r.name for r in obs.FLEET_RULES}
    with urllib.request.urlopen(furl + "/fleet-monitor/stream?ticks=2", timeout=30) as r:
        recs = [json.loads(ln) for ln in r if ln.strip()]
    assert len(recs) == 3 and recs[-1]["t"] == "end"
    # a chat of its own for the router's trace ring: under xdist this
    # test may run on a worker where no other test of the module has
    status, _ = _post(furl + "/v1/chat/completions",
                      {"model": "tiny-dense", "max_tokens": 3,
                       "messages": [{"role": "user", "content": "to replay"}]})
    assert status == 200
    records = sdk.get_replay_log()
    assert records and all("arrival_offset_s" in r for r in records)
    assert all(r["kind"] == "chat" and r.get("body") for r in records)
    path = tmp_path / "captured.jsonl"
    replay.dump_jsonl(records, path)
    out = replay.replay(furl, replay.load_jsonl(path), speedup=50.0, timeout=60.0)
    assert out["ok"] == out["sent"] >= 1 and out["errors"] == []
    # a local client, or a plain replica, has no fleet surface
    assert Sutro(api_key="k", backend="tpu").get_fleet() is None
    replica = Sutro(api_key="k", base_url=rtr.membership.get("r0")["url"],
                    backend="remote")
    assert replica.get_fleet() is None and replica.get_fleet_monitor() is None
    assert replica.get_replay_log() is None


def test_a_disabled_fleet_monitor_raises_key_error(fleet, monkeypatch):
    rtr, furl, sdk = fleet
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    rtr2, fsrv2, _, furl2 = router.start_fleet_thread(
        [rtr.membership.get("r0")["url"]], probe_interval=0.2)
    try:
        assert rtr2.monitor is None
        with pytest.raises(KeyError, match="disabled"):
            Sutro(api_key="k", base_url=furl2, backend="fleet").get_fleet_monitor()
    finally:
        rtr2.stop()
        fsrv2.shutdown()
