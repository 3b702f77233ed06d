"""The port's replica fleet (``sutro_tpu_torch/fleet/``) against the JAX
package's.

Layout follows ``tests/test_fleet.py``:

1. units — the breaker's transitions, backoff bounds and flap
   detection, the doctor's fleet verdicts, the frame parsers on junk,
   ``pick_batch``/``pick_interactive`` on seeded replica lists and
   ``WarmAffinity``'s keys and scores: the same scripted calls through
   both packages give the same answers;
2. prober degradation against fake transports (an old replica's
   ``/healthz`` fallback, garbage answers, the ``fleet.probe`` fault
   site), both packages driven alike;
3. two port engines on one tiny-dense checkpoint, sharing one
   ``SUTRO_HOME``, behind the port's router (its transport is
   ``http.client``; the JAX side uses ``requests``): a routed submit
   whose progress and results are token-identical to the JAX engine's on
   the same checkpoint, warm affinity, the route fault's retry, drain,
   the legacy replica's probe-only routing, and a replica's 404, 503 and
   429 relayed with their status and body;
4. chaos — a replica killed mid-job fails over with zero rows lost or
   duplicated and the unkilled run's outputs; a replica dying mid-SSE
   stream gives a structured error frame, never a hang;
5. wire compatibility both ways: the JAX router over the port's
   replicas, the port's router over JAX replicas.

Destructive tests build their own servers and routers around the shared
engines, so the module fixture stays healthy.
"""

import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine import faults as jax_faults
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.fleet import affinity as jax_affinity
from sutro_tpu.fleet import frames as jax_frames
from sutro_tpu.fleet import health as jax_health
from sutro_tpu.fleet import membership as jax_membership
from sutro_tpu.fleet import router as jax_router
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.sdk import Sutro as JaxSutro
from sutro_tpu.server import start_server_thread as jax_start_server_thread
from sutro_tpu.telemetry import doctor as jax_doctor
from sutro_tpu_torch.engine import api, faults
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.fleet import affinity, frames, health, membership, router
from sutro_tpu_torch.interfaces import JobStatus
from sutro_tpu_torch.sdk import Sutro
from sutro_tpu_torch.server import EngineHTTPHandler, start_server_thread
from sutro_tpu_torch.telemetry import doctor
from tests.test_torch_api import ENGINE, _no_native_masks
from tests.test_torch_weights_loader import write_hf_checkpoint

FLEET = dict(ENGINE, prefix_store=True, interactive_slots=2, max_new_tokens=8)
PACKAGES = {
    "jax": (jax_membership, jax_health, jax_affinity, jax_frames, jax_faults, jax_router,
            jax_doctor),
    "port": (membership, health, affinity, frames, faults, router, doctor),
}

STATE_OK = {
    "ready": True,
    "draining": False,
    "load": {},
    "models": [],
    "fleet_protocol": True,
    "warm_probe": True,
}


def _wait(pred, timeout=60.0, interval=0.05, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def _both(fn):
    """``fn(package modules)`` for the JAX package and the port."""
    return fn(*PACKAGES["jax"]), fn(*PACKAGES["port"])


def _post(url, body, headers=None, timeout=120):
    """(status, body bytes) of a JSON POST over urllib; non-2xx too."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sse_lines(url, body, timeout=60):
    """The non-empty lines of a streamed chat reply, as they arrive."""
    req = urllib.request.Request(
        url, data=json.dumps({**body, "stream": True}).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200
        return [ln.decode().rstrip("\r\n") for ln in resp if ln.strip()]


def _chat(content, **kw):
    return {"model": "tiny-dense", "messages": [{"role": "user", "content": content}],
            "max_tokens": 4, "temperature": 0, **kw}


# ---------------------------------------------------------------------
# 1. breaker state machine + frames + pick policies (pure units)
# ---------------------------------------------------------------------


def test_breaker_transitions_match_the_jax_package():
    def script(mem, *_):
        trans, seen = [], []
        m = mem.FleetMembership(["http://x:1"], probe_interval=1.0,
                                on_transition=lambda *a: trans.append(a))
        now = 100.0
        m.note_probe_success("r0", STATE_OK, now=now)
        seen.append([r["rid"] for r in m.healthy()])
        for _ in range(3):
            m.note_probe_failure("r0", now=now)
            seen.append(m.get("r0")["state"])
        seen.append(m.healthy())
        m.note_half_open("r0", now=now)
        seen.append(m.get("r0")["state"])
        m.note_probe_failure("r0", now=now)
        seen.append(m.get("r0")["state"])
        seen.append(m.due_probes(now=now + 1.5))
        seen.append(m.due_probes(now=now + 2.5))
        m.note_half_open("r0", now=now + 2.5)
        m.note_probe_success("r0", STATE_OK, now=now + 2.5)
        seen.append(m.get("r0"))
        seen.append([r["rid"] for r in m.healthy()])
        return trans, seen

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    trans, seen = port_out
    assert ("r0", "closed", "open") in trans
    assert seen[3] == "open" and seen[5] == "half_open" and seen[6] == "open"
    assert seen[-1] == ["r0"]


@pytest.mark.parametrize("cap", [2.0, 8.0, 30.0])
def test_breaker_backoff_is_bounded_as_in_the_jax_package(cap):
    def script(mem, *_):
        m = mem.FleetMembership(["http://x:1"], probe_interval=1.0, backoff_cap=cap)
        for _ in range(23):
            m.note_probe_failure("r0", now=0.0)
        return [bool(m.due_probes(now=t)) for t in np.arange(0.0, cap + 1.0, 0.1)]

    jax_due, port_due = _both(script)
    assert port_due == jax_due
    assert not port_due[int(round((cap - 0.1) * 10))] and port_due[-1]


def test_flap_detection_feeds_the_doctor_as_in_the_jax_package():
    def script(mem, health, aff, fr, flt, rt, doc):
        m = mem.FleetMembership(["http://x:1"], probe_interval=0.01)
        m.note_probe_success("r0", STATE_OK)
        for _ in range(3):
            m.note_probe_failure("r0")
        m.note_half_open("r0")
        m.note_probe_success("r0", STATE_OK)
        snap = m.snapshot()
        for row in snap["replicas"]:
            row.pop("age_s")
        return m.flapping(), snap, doc.diagnose_fleet(snap)

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    assert port_out[0] == ["r0"] and port_out[2]["verdict"] == "replica_flapping"


def test_doctor_fleet_verdicts_match_the_jax_package():
    row = {"rid": "r0", "state": "closed", "ready": True, "draining": False,
           "transitions_in_window": 0}
    docs = [
        {"replicas": [], "n_healthy": 0},
        {"replicas": [row], "n_healthy": 1},
        {"replicas": [row, dict(row, rid="r1", state="open")], "n_healthy": 1},
        {"replicas": [row, dict(row, rid="r1", draining=True)], "n_healthy": 1},
        {"replicas": [row, dict(row, rid="r1", transitions_in_window=5)], "n_healthy": 2},
        {"replicas": [dict(row, state="half_open")], "n_healthy": 0,
         "failovers": {"batch": 2, "interactive": 1, "stream_error": 0}},
    ]
    want = [jax_doctor.diagnose_fleet(d) for d in docs]
    assert [doctor.diagnose_fleet(d) for d in docs] == want
    assert [w["verdict"] for w in want[:4]] == [
        "no_healthy_replicas", "healthy", "fleet_degraded", "fleet_degraded"]


JUNK = [
    "nonsense", None, 7, [], {"t": "not_fleet_state"}, {"ok": True, "junk": 1},
    {"t": "fleet_state", "v": 99, "future_knob": {"nested": True}, "ok": True,
     "ready": True, "load": {"jobs_queued": 2, "new_field": "x"}},
    {"t": "fleet_state", "ready": "yes", "load": "bogus", "models": "m"},
    {"t": "warm_report", "warm_tokens": "bogus"}, {"warm_tokens": 7, "x": 1},
    {"t": "metrics_snapshot", "snapshot": None}, {"t": "trace_doc", "doc": 5},
    {"t": "trace_doc", "doc": {"trace_id": "tr-1"}, "unix": 3.0},
]


@pytest.mark.parametrize("i", range(len(JUNK)))
def test_frame_parsers_on_junk_match_the_jax_package(i):
    doc = JUNK[i]
    for fn in ("parse_fleet_state", "parse_warm_report", "parse_metrics_snapshot",
               "parse_trace_doc"):
        assert getattr(frames, fn)(doc) == getattr(jax_frames, fn)(doc), fn
    load = doc.get("load") if isinstance(doc, dict) else doc
    if isinstance(load, dict):
        assert frames.load_score(load) == jax_frames.load_score(load)


@pytest.mark.parametrize("seed", range(6))
def test_pick_policies_on_seeded_replicas_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    reps = [{"rid": f"r{i}", "load": int(rng.integers(0, 4))} for i in rng.permutation(n)]
    scores = {f"r{i}": int(rng.choice([0, 0, 16, 64])) for i in range(n)
              if rng.random() < 0.6}
    got_b = [r["rid"] for r in router.pick_batch(reps)]
    got_i = [r["rid"] for r in router.pick_interactive(reps, scores)]
    assert got_b == [r["rid"] for r in jax_router.pick_batch(reps)]
    assert got_i == [r["rid"] for r in jax_router.pick_interactive(reps, scores)]
    assert [r["load"] for r in router.pick_batch(reps)] == sorted(r["load"] for r in reps)


def test_warm_affinity_keys_and_scores_match_the_jax_package():
    rng = np.random.default_rng(11)
    bodies = []
    for i in range(12):
        words = " ".join(rng.choice(["alpha", "beta", "gamma", "delta"], 5))
        if i % 2:
            bodies.append(({"model": "tiny-dense", "prompt": words,
                            "temperature": float(rng.random())}, False))
        else:
            bodies.append(({"model": "tiny-dense", "temperature": float(rng.random()),
                            "messages": [{"role": "user", "content": words}]}, True))
    for body, chat in bodies:
        assert affinity.shell_key(body, chat) == jax_affinity.shell_key(body, chat)
    # sampling parameters are not part of the key
    b0 = bodies[0][0]
    assert affinity.shell_key(b0, True) == affinity.shell_key(dict(b0, temperature=9), True)

    rows = [{"rid": "r0", "url": "http://a", "warm_probe": True},
            {"rid": "r1", "url": "http://b", "warm_probe": True},
            {"rid": "r2", "url": "http://c", "warm_probe": False}]

    def run(aff_mod, fr_mod):
        sent = []

        def send(method, url, frame=None, timeout=2.0):
            sent.append((method, url, frame))
            if url.startswith("http://a"):
                return {"t": "warm_report", "warm_tokens": 24, "_status": 200}
            raise OSError("replica down")

        a = aff_mod.WarmAffinity(send=send)
        out = [a.scores(b, c, rows) for b, c in bodies[:3]]
        out.append(a.scores(*bodies[0], rows))  # a cache hit sends nothing
        a.invalidate()
        out.append(a.scores(*bodies[0], rows))
        return out, sent

    assert run(affinity, frames) == run(jax_affinity, jax_frames)


# ---------------------------------------------------------------------
# 2. prober degradation against fake transports
# ---------------------------------------------------------------------


def _legacy_send(calls):
    def send(method, url, frame=None, timeout=2.0):
        calls.append(url)
        if url.endswith("/fleet-state"):
            return {"detail": "Unknown endpoint GET /fleet-state", "_status": 404}
        if url.endswith("/healthz"):
            return {"ok": True, "unexpected_key": [1, 2], "_status": 200}
        raise AssertionError(f"unexpected probe url {url}")
    return send


def test_prober_degrades_an_old_replica_to_healthz_as_the_jax_package():
    def script(mem, hl, aff, fr, *_):
        m = mem.FleetMembership(["http://legacy:9"], probe_interval=0.01)
        calls = []
        p = hl.HealthProber(m, send=_legacy_send(calls))
        p.sweep_once()
        row = m.get("r0")
        first = list(calls)
        calls.clear()
        m.note_probe_success("r0", fr.parse_fleet_state({"ok": True}))
        p.probe_one("r0", "http://legacy:9")
        scores = aff.WarmAffinity(send=_legacy_send([])).scores(
            {"model": "m", "messages": []}, True, [row])
        return row, first, list(calls), scores

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    row, first, second, scores = port_out
    assert row["state"] == "closed" and row["ready"] and not row["fleet_protocol"]
    assert first == ["http://legacy:9/fleet-state", "http://legacy:9/healthz"]
    assert second == ["http://legacy:9/healthz"] and scores == {}


def test_prober_opens_the_breaker_on_garbage_as_the_jax_package():
    def script(mem, hl, *_):
        m = mem.FleetMembership(["http://weird:9"], probe_interval=0.01)
        p = hl.HealthProber(m, send=lambda *a, **k: {"t": "completely_unknown",
                                                     "_status": 200})
        states = []
        for _ in range(5):
            m._replicas["r0"].next_probe_at = 0.0
            p.sweep_once()
            states.append(m.get("r0")["state"])
        return states, m.healthy()

    jax_out, port_out = _both(script)
    assert port_out == jax_out
    assert port_out[0][-1] == "open" and port_out[1] == []


def test_fleet_probe_fault_site_drives_the_breaker_as_the_jax_package():
    def script(mem, hl, aff, fr, flt, *_):
        m = mem.FleetMembership(["http://a:1", "http://b:2"], probe_interval=0.01)

        def ok_send(method, url, frame=None, timeout=2.0):
            return dict(fr.fleet_state_frame("ready", False, True, {}, []), _status=200)

        p = hl.HealthProber(m, send=ok_send)
        flt.configure("fleet.probe:error:job=r0")
        try:
            for _ in range(4):
                for r in ("r0", "r1"):
                    m._replicas[r].next_probe_at = 0.0
                p.sweep_once()
        finally:
            flt.clear()
        return m.get("r0")["state"], [r["rid"] for r in m.healthy()]

    jax_out, port_out = _both(script)
    assert port_out == jax_out == ("open", ["r1"])


# ---------------------------------------------------------------------
# 3. two live port engines, one shared home, one router
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two port engines sharing one SUTRO_HOME behind the port's router
    (r0 -> eng_a, r1 -> eng_b), and a JAX engine on the same checkpoint
    with its own home."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-fleet")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 13, root / "weights" / "tiny-dense")
    cfg = dict(FLEET, weights_dir=str(root / "weights"))
    mp.setattr(jax_cpp, "CppMasker", _no_native_masks)
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **cfg))
    mp.setenv("SUTRO_HOME", str(root / "fleet-home"))
    eng_a = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    eng_b = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    srv_a, _, url_a = start_server_thread(eng_a)
    srv_b, _, url_b = start_server_thread(eng_b)
    rtr, fsrv, _, furl = router.start_fleet_thread([url_a, url_b], probe_interval=0.2)
    sdk = Sutro(api_key="fleet-key", base_url=furl, backend="fleet")
    _wait(lambda: rtr.membership.snapshot()["n_healthy"] == 2, timeout=30,
          what="both replicas healthy")

    class F:
        pass

    f = F()
    f.jeng, f.eng_a, f.eng_b = jeng, eng_a, eng_b
    f.url_a, f.url_b = url_a, url_b
    f.router, f.furl, f.sdk, f.root = rtr, furl, sdk, root
    f.cfg = cfg
    yield f
    faults.clear()
    rtr.stop()
    fsrv.shutdown()
    srv_a.shutdown()
    srv_b.shutdown()
    eng_a.close(timeout=30)
    eng_b.close(timeout=30)
    jeng.close(timeout=30)
    mp.undo()


def _jax_outputs(f, payload):
    jid = f.jeng.submit_batch_inference(dict(payload))
    _wait(lambda: f.jeng.job_status(jid) in ("SUCCEEDED", "FAILED"), timeout=300,
          what="the JAX engine's job")
    assert f.jeng.job_status(jid) == "SUCCEEDED"
    return f.jeng.job_results(jid)["outputs"]


def _payload(rows, max_new=5):
    return {"model": "tiny-dense", "inputs": list(rows), "job_priority": 0,
            "sampling_params": {"max_new_tokens": max_new, "temperature": 0.0}}


def test_routed_submit_progress_and_results_equal_the_jax_engines(fleet):
    rows = [f"fleet row {i}" for i in range(6)]
    want = _jax_outputs(fleet, _payload(rows))
    jid = fleet.sdk.infer(rows, model="tiny-dense", stay_attached=False,
                          sampling_params={"max_new_tokens": 5, "temperature": 0.0})
    assert fleet.router.job_owner(jid) in ("r0", "r1")
    progress = [u for u in fleet.sdk._iter_progress(jid)
                if u.get("update_type") == "progress"]
    assert progress and int(progress[-1]["result"]) == 6
    assert fleet.sdk.get_job_status(jid) == JobStatus.SUCCEEDED.value
    res = fleet.sdk._remote_json("post", "job-results", json={"job_id": jid})["results"]
    assert res["outputs"] == want
    assert fleet.router.counters["batch_routed"] >= 1
    assert fleet.sdk._fetch_job(jid)["num_rows"] == 6
    doc = fleet.sdk.get_fleet()
    assert doc["n_replicas"] == 2 and doc["n_healthy"] == 2
    assert doc["doctor"]["verdict"] == "healthy"
    assert {r["rid"] for r in doc["replicas"]} == {"r0", "r1"}


def test_a_burst_of_clients_is_answered(fleet):
    """The router and the replicas listen with a backlog for bursts
    (``frames.ListeningServer``, not ``socketserver``'s 5): 48 clients
    at once all get their answer."""
    from sutro_tpu_torch.server import make_server

    srv = make_server(fleet.eng_a, port=0)
    try:
        assert srv.request_queue_size == frames.ListeningServer.request_queue_size == 128
    finally:
        srv.server_close()
    got, barrier = [], threading.Barrier(48)

    def hit(url):
        barrier.wait(30)
        got.append(_get(url)[0])

    threads = [threading.Thread(target=hit, args=(u + "/healthz",), daemon=True)
               for u in [fleet.furl] * 32 + [fleet.url_a] * 16]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == [200] * 48


def test_interactive_routes_to_the_warm_replica(fleet):
    body = dict(_chat("affinity probe turn"), session_id="fleet-affinity-sess")
    # warm replica B directly (not through the router)
    status, _ = _post(fleet.url_b + "/v1/chat/completions", body)
    assert status == 200
    follow = dict(body, messages=[{"role": "user", "content": "second turn"}])
    cands, scores = fleet.router.candidates_interactive(follow, chat=True)
    assert scores["r1"] > 0 and scores.get("r0", 0) == 0
    assert cands[0]["rid"] == "r1"
    before = fleet.router.counters["prefix_hits"]
    status, raw = _post(fleet.furl + "/v1/chat/completions", follow)
    assert status == 200 and json.loads(raw)["choices"]
    assert fleet.router.counters["prefix_hits"] == before + 1


def test_route_fault_retries_on_the_next_replica_before_the_first_token(fleet):
    before = dict(fleet.router.counters)
    faults.configure("fleet.route:error:nth=1,times=1")
    try:
        status, raw = _post(fleet.furl + "/v1/chat/completions", _chat("retry me"))
    finally:
        faults.clear()
    assert status == 200 and json.loads(raw)["choices"]
    after = fleet.router.counters
    assert after["failover_interactive"] == before["failover_interactive"] + 1
    assert after["interactive_routed"] == before["interactive_routed"] + 1


def test_drain_excludes_a_replica_without_failover(fleet):
    failovers_before = fleet.router.counters["failover_batch"]
    try:
        fleet.eng_a.gateway.begin_drain()
        _wait(lambda: fleet.router.membership.snapshot()["n_draining"] == 1,
              timeout=30, what="the router to see the drain")
        snap = fleet.router.membership.snapshot()
        r0 = next(r for r in snap["replicas"] if r["rid"] == "r0")
        assert r0["draining"] and r0["state"] == "closed" and snap["n_healthy"] == 1
        assert fleet.router.snapshot()["doctor"]["verdict"] == "fleet_degraded"
        jid = fleet.sdk.infer(["drained row"], model="tiny-dense", stay_attached=False,
                              sampling_params={"max_new_tokens": 4, "temperature": 0.0})
        assert fleet.router.job_owner(jid) == "r1"
        fleet.sdk.await_job_completion(jid, timeout=300, obtain_results=False)
    finally:
        fleet.eng_a.gateway.draining = False
    _wait(lambda: fleet.router.membership.snapshot()["n_healthy"] == 2, timeout=30,
          what="the replica to rejoin")
    assert fleet.router.counters["failover_batch"] == failovers_before


def _legacy_server(eng):
    """A server on ``eng`` that 404s the fleet endpoints (an old
    replica)."""
    from http.server import ThreadingHTTPServer

    class LegacyHandler(EngineHTTPHandler):
        engine = eng

        def do_GET(self):  # noqa: N802
            head = self.path.split("?")[0].strip("/").partition("/")[0]
            if head in ("fleet-state", "metrics-snapshot", "trace-doc"):
                self._error(404, f"Unknown endpoint GET /{head}")
                return
            super().do_GET()

        def do_POST(self):  # noqa: N802
            head = self.path.split("?")[0].strip("/").partition("/")[0]
            if head == "fleet-warm":
                self._error(404, f"Unknown endpoint POST /{head}")
                return
            super().do_POST()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), LegacyHandler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_a_legacy_replica_routes_probe_only(fleet):
    srv, legacy_url = _legacy_server(fleet.eng_b)
    router2, fsrv2, _, furl2 = router.start_fleet_thread([legacy_url], probe_interval=0.2)
    try:
        _wait(lambda: router2.membership.snapshot()["n_healthy"] == 1, timeout=30,
              what="the legacy replica probed healthy")
        row = router2.membership.get("r0")
        assert not row["fleet_protocol"] and not row["warm_probe"]
        status, raw = _post(furl2 + "/v1/chat/completions", _chat("legacy route"))
        assert status == 200 and json.loads(raw)["choices"]
        assert router2.counters["probe_only_routes"] >= 1
        assert router2.counters["prefix_hits"] == 0
    finally:
        router2.stop()
        fsrv2.shutdown()
        srv.shutdown()
        srv.server_close()


def test_a_replicas_404_and_503_reach_the_client_with_status_and_body(fleet):
    status, raw = _get(fleet.furl + "/jobs/job-no-such-job")
    assert status == 404 and "job-no-such-job" in json.loads(raw)["detail"]
    direct = _get(fleet.url_a + "/jobs/job-no-such-job")
    assert (status, raw) == direct
    # a router that probes once, then not again: the replica drains
    # unseen, and its 503 is relayed as it answered
    srv, _, url = start_server_thread(fleet.eng_a)
    router2, fsrv2, _, furl2 = router.start_fleet_thread([url], probe_interval=3600.0)
    try:
        assert router2.membership.snapshot()["n_healthy"] == 1
        fleet.eng_a.gateway.begin_drain()
        status, raw = _post(furl2 + "/v1/chat/completions", _chat("while draining"))
        want = _post(url + "/v1/chat/completions", _chat("while draining"))
        assert status == 503 and (status, raw) == want
        assert json.loads(raw)["error"]["code"] == 503
        status, raw = _post(furl2 + "/v1/chat/completions",
                            _chat("while draining", stream=True))
        assert status == 503 and json.loads(raw)["error"]["code"] == 503
    finally:
        fleet.eng_a.gateway.draining = False
        router2.stop()
        fsrv2.shutdown()
        srv.shutdown()
        srv.server_close()


def test_a_replicas_429_quota_exceeded_reaches_the_client(fleet, tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    eng = api.LocalEngine(EngineConfig(**fleet.cfg, control="rows=3,wait=0.2,window=600"),
                          device="cpu")
    srv, _, url = start_server_thread(eng)
    router2, fsrv2, _, furl2 = router.start_fleet_thread([url], probe_interval=0.2)
    body = {"model": "tiny-dense", "inputs": ["a", "b", "c"], "tenant": "acme",
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 2}}
    try:
        _wait(lambda: router2.membership.snapshot()["n_healthy"] == 1, timeout=30,
              what="the replica healthy")
        ok_status, ok_raw = _post(furl2 + "/batch-inference", body)
        status, raw = _post(furl2 + "/batch-inference", body)
        assert ok_status == 200
        doc = json.loads(raw)
        assert status == 429 and doc["error"]["code"] == "QUOTA_EXCEEDED"
        assert eng.get_job(doc["results"])["status"] == "FAILED"
        # a refused submit is not routed work: the router tracks the one
        assert router2.job_owner(json.loads(ok_raw)["results"]) == "r0"
        assert router2.job_owner(doc["results"]) is None
        _wait(lambda: eng.job_status(json.loads(ok_raw)["results"]) == "SUCCEEDED",
              timeout=120, what="the admitted job")
    finally:
        router2.stop()
        fsrv2.shutdown()
        srv.shutdown()
        eng.close(timeout=30)


# ---------------------------------------------------------------------
# 4. chaos: replica death mid-stream and mid-batch-job
# ---------------------------------------------------------------------


def test_a_replica_dying_mid_stream_gives_a_structured_error_not_a_hang(fleet):
    srv, _, url = start_server_thread(fleet.eng_a)
    router2, fsrv2, _, furl2 = router.start_fleet_thread([url], probe_interval=0.2,
                                                         stall_timeout=10.0)
    try:
        _wait(lambda: router2.membership.snapshot()["n_healthy"] == 1, timeout=30,
              what="replica healthy")
        warm = _sse_lines(furl2 + "/v1/chat/completions", _chat("warmup"))
        assert warm[-1] == "data: [DONE]"
        assert warm.count("data: [DONE]") == 1
        # the second token frame: a reply of 8 tokens may stream as a
        # content frame and the finish frame alone
        faults.install(faults.parse_plan(json.dumps([
            {"site": "fleet.replica_crash", "kind": "crash", "job": "stream:", "nth": 2,
             "times": 1}])))
        t0 = time.monotonic()
        lines = _sse_lines(furl2 + "/v1/chat/completions",
                           _chat("stream then die", max_tokens=8))
        elapsed = time.monotonic() - t0
    finally:
        faults.clear()
        router2.stop()
        fsrv2.shutdown()
        srv.shutdown()
        srv.server_close()
    assert any(ln.startswith("data: {") and "error" not in ln for ln in lines)
    err_lines = [ln for ln in lines if '"error"' in ln]
    assert err_lines, f"no structured error frame in {lines}"
    err = json.loads(err_lines[-1][len("data: "):])["error"]
    assert err["code"] == 502 and err["replica"] == "r0"
    assert lines[-1] == "data: [DONE]"
    assert elapsed < 30.0
    assert router2.counters["failover_stream_error"] == 1
    assert fleet.router.counters["failover_stream_error"] == 0


def _raw_replica(answer):
    """A replica on a raw socket that answers ``/fleet-state`` and
    ``/healthz`` as a ready replica without warm probes, and hands
    every other request's socket and path to ``answer``. Returns
    (stop, url)."""
    lsock = socket.create_server(("127.0.0.1", 0))
    lsock.settimeout(0.1)
    stop = threading.Event()

    def serve_one(conn):
        with conn:
            buf = b""
            while b"\r\n\r\n" not in buf:
                data = conn.recv(65536)
                if not data:
                    return
                buf += data
            head, _, rest = buf.partition(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            n = 0
            for ln in lines[1:]:
                key, _, value = ln.partition(":")
                if key.strip().lower() == "content-length":
                    n = int(value)
            while len(rest) < n:
                rest += conn.recv(65536)
            path = lines[0].split()[1]
            if path.startswith(("/fleet-state", "/healthz")):
                _raw_answer(conn, 200, json.dumps({**STATE_OK, "warm_probe": False}))
            else:
                answer(conn, path)

    def loop():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            threading.Thread(target=serve_one, args=(conn,), daemon=True).start()
        lsock.close()

    threading.Thread(target=loop, daemon=True).start()
    return stop, f"http://127.0.0.1:{lsock.getsockname()[1]}"


def _raw_answer(conn, status, body):
    body = body.encode()
    conn.sendall(b"HTTP/1.1 %d X\r\nContent-Type: application/json\r\n"
                 b"Content-Length: %d\r\nConnection: close\r\n\r\n%s"
                 % (status, len(body), body))


def _raw_chunk(data):
    return b"%X\r\n%s\r\n" % (len(data), data)


def _reset(conn):
    """Close ``conn`` with a TCP reset (``SO_LINGER`` 0), as a replica
    whose process dies does."""
    time.sleep(0.2)  # the router has read what was sent before
    conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    conn.close()


def test_a_replica_resetting_mid_stream_gives_a_structured_error_not_a_hang():
    """A reset is the replica's failure, not the client's: the router
    ends the stream with the error frame and ``[DONE]``, as the
    reference does on ``requests``' ``ChunkedEncodingError``."""
    def answer(conn, path):
        if path != "/v1/chat/completions":
            _raw_answer(conn, 404, json.dumps({"detail": path}))
            return
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n" + _raw_chunk(
                         b'data: {"choices": [{"index": 0, "delta": {"content": "a"}}]}\n\n'))
        _reset(conn)

    stop, url = _raw_replica(answer)
    rtr, fsrv, _, furl = router.start_fleet_thread([url], probe_interval=0.2,
                                                   stall_timeout=10.0)
    try:
        _wait(lambda: rtr.membership.snapshot()["n_healthy"] == 1, timeout=30,
              what="the replica healthy")
        t0 = time.monotonic()
        lines = _sse_lines(furl + "/v1/chat/completions", _chat("reset"), timeout=20)
        elapsed = time.monotonic() - t0
    finally:
        rtr.stop()
        fsrv.shutdown()
        stop.set()
    assert lines[0].startswith("data: {") and '"error"' not in lines[0]
    err = json.loads(lines[-2][len("data: "):])["error"]
    assert err["code"] == 502 and err["replica"] == "r0"
    assert "replica connection lost mid-stream" in err["message"]
    assert lines[-1] == "data: [DONE]"
    assert elapsed < 10.0
    assert rtr.counters["failover_stream_error"] == 1


def test_a_replica_resetting_the_progress_stream_is_reattached_with_its_cursor():
    """The NDJSON progress relay takes a reset as the replica's drop and
    reconnects from the rows it has seen, as on a clean EOF."""
    seen = []
    progress = json.dumps({"update_type": "progress", "result": 3}).encode() + b"\n"
    end = json.dumps({"t": "end", "status": "SUCCEEDED"}).encode() + b"\n"

    def answer(conn, path):
        if not path.startswith("/stream-job-progress/"):
            _raw_answer(conn, 404, json.dumps({"detail": path}))
            return
        seen.append(path)
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")
        if len(seen) == 1:
            conn.sendall(_raw_chunk(progress))
            _reset(conn)
        else:
            conn.sendall(_raw_chunk(end) + b"0\r\n\r\n")

    stop, url = _raw_replica(answer)
    rtr, fsrv, _, furl = router.start_fleet_thread([url], probe_interval=0.2,
                                                   stall_timeout=10.0)
    try:
        _wait(lambda: rtr.membership.snapshot()["n_healthy"] == 1, timeout=30,
              what="the replica healthy")
        status, raw = _get(furl + "/stream-job-progress/job-reset", timeout=20)
    finally:
        rtr.stop()
        fsrv.shutdown()
        stop.set()
    assert status == 200
    assert [json.loads(ln) for ln in raw.splitlines()] == [
        json.loads(progress), json.loads(end)]
    assert seen == ["/stream-job-progress/job-reset?cursor=0",
                    "/stream-job-progress/job-reset?cursor=3"]


def test_a_replica_killed_mid_job_fails_over_with_no_row_lost_or_duplicated(
        fleet, monkeypatch):
    """The reference's acceptance gate: the job fails on its owner after
    partial progress, the owner's server dies, the breaker opens, the job
    resumes on the survivor through the shared store and ends SUCCEEDED
    with every row once, the pre-kill rows as they were stored and the
    unkilled run's outputs (the JAX engine's too). The partial store
    takes a chunk every 4 rows here (every 256 by default), so that the
    kill finds rows stored and the resumed run must skip them."""
    monkeypatch.setattr(api, "_PARTIAL_FLUSH_EVERY", 4)
    n = 24
    payload = _payload([f"failover row {i}" for i in range(n)])
    jid_ref = fleet.eng_b.submit_batch_inference(dict(payload))
    _wait(lambda: JobStatus(fleet.eng_b.job_status(jid_ref)).is_terminal(), timeout=300,
          what="the reference job")
    ref = fleet.eng_b.job_results(jid_ref)["outputs"]
    assert ref == _jax_outputs(fleet, payload)

    srv_a, _, url_a = start_server_thread(fleet.eng_a)
    srv_b, _, url_b = start_server_thread(fleet.eng_b)
    servers = {"r0": srv_a, "r1": srv_b}
    router2, fsrv2, _, furl2 = router.start_fleet_thread([url_a, url_b], probe_interval=0.2)
    sdk2 = Sutro(api_key="k", base_url=furl2, backend="fleet")
    store = fleet.eng_b.jobs  # either handle: the jobstore is shared
    try:
        _wait(lambda: router2.membership.snapshot()["n_healthy"] == 2, timeout=30,
              what="both replicas healthy")
        # the fault fires in the third decode call, after the first
        # rows are done and flushed
        faults.configure("runner.decode:oom:nth=3,times=1")
        jid = sdk2.infer(payload["inputs"], model="tiny-dense", stay_attached=False,
                         sampling_params=payload["sampling_params"])
        owner = router2.job_owner(jid)
        assert owner in ("r0", "r1")
        survivor = "r1" if owner == "r0" else "r0"
        _wait(lambda: store.status(jid) == JobStatus.FAILED, timeout=300,
              what="the job to fail on its first owner")
        faults.clear()
        partial = store.read_partial(jid)
        assert 0 < len(partial) < n
        servers[owner].shutdown()
        servers[owner].server_close()
        _wait(lambda: router2.counters["failover_batch"] >= 1, timeout=60,
              what="the router to fail the job over")
        assert router2.job_owner(jid) == survivor
        _wait(lambda: sdk2.get_job_status(jid) == JobStatus.SUCCEEDED.value, timeout=300,
              what="the failed-over job to succeed")
        snap = router2.snapshot()
        assert snap["n_healthy"] == 1 and snap["doctor"]["verdict"] != "healthy"
        assert snap["failovers"]["batch"] >= 1
        res = store.read_results(jid)
        assert sorted(res["row_id"]) == list(range(n))
        assert fleet.eng_b.job_results(jid)["outputs"] == ref
        by_row = dict(zip(res["row_id"], res["outputs"]))
        assert all(by_row[i] == row["outputs"] for i, row in partial.items())
    finally:
        faults.clear()
        router2.stop()
        fsrv2.shutdown()
        for srv in servers.values():
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass


# ---------------------------------------------------------------------
# 5. wire compatibility, router to replica, both ways
# ---------------------------------------------------------------------


def test_the_jax_router_routes_a_job_over_the_port_replicas(fleet):
    rows = ["wire row one", "wire row two", "three"]
    want = _jax_outputs(fleet, _payload(rows))
    jr, jsrv, _, jurl = jax_router.start_fleet_thread([fleet.url_a, fleet.url_b],
                                                      probe_interval=0.2)
    try:
        _wait(lambda: jr.membership.snapshot()["n_healthy"] == 2, timeout=30,
              what="the JAX router to see both port replicas")
        assert all(r["fleet_protocol"] for r in jr.membership.all())
        c = JaxSutro(api_key="k", base_url=jurl, backend="fleet")
        jid = c.infer(rows, model="tiny-dense", stay_attached=False,
                      sampling_params={"max_new_tokens": 5, "temperature": 0.0})
        assert jr.job_owner(jid) in ("r0", "r1")
        c.await_job_completion(jid, timeout=300, obtain_results=False)
        assert c.get_job_status(jid) == "SUCCEEDED"
        res = c._remote_json("post", "job-results", json={"job_id": jid})["results"]
        assert res["outputs"] == want
    finally:
        jr.stop()
        jsrv.shutdown()


def test_the_port_router_routes_a_job_over_jax_replicas(fleet):
    rows = ["jax replica row", "and another one"]
    want = _jax_outputs(fleet, _payload(rows))
    s1, _, u1 = jax_start_server_thread(fleet.jeng)
    s2, _, u2 = jax_start_server_thread(fleet.jeng)
    rtr, fsrv, _, furl = router.start_fleet_thread([u1, u2], probe_interval=0.2)
    try:
        _wait(lambda: rtr.membership.snapshot()["n_healthy"] == 2, timeout=30,
              what="the port router to see both JAX replicas")
        assert all(r["fleet_protocol"] and r["warm_probe"] for r in rtr.membership.all())
        c = Sutro(api_key="k", base_url=furl, backend="fleet")
        jid = c.infer(rows, model="tiny-dense", stay_attached=False,
                      sampling_params={"max_new_tokens": 5, "temperature": 0.0})
        assert rtr.job_owner(jid) in ("r0", "r1")
        ups = [u for u in c._iter_progress(jid) if u.get("update_type") == "progress"]
        assert ups and int(ups[-1]["result"]) == len(rows)
        assert c.get_job_status(jid) == "SUCCEEDED"
        res = c._remote_json("post", "job-results", json={"job_id": jid})["results"]
        assert res["outputs"] == want
        status, raw = _post(furl + "/v1/chat/completions", _chat("a chat over JAX"))
        assert status == 200 and json.loads(raw)["choices"]
    finally:
        rtr.stop()
        fsrv.shutdown()
        s1.shutdown()
        s2.shutdown()


# ---------------------------------------------------------------------
# 6. chip_smoke.py's serve 9 at a tiny size
# ---------------------------------------------------------------------


def test_smoke_serve9_runs_at_a_tiny_size(tmp_path, monkeypatch):
    """``chip_smoke.py``'s serve 9 end to end on the CPU at a tiny size
    (two tiny-dense replicas from a bfloat16 checkpoint, 8-row jobs, a
    24-row failover job whose store takes a chunk every 8 rows, 4 chat
    sessions): every check it makes on the card passes here with the
    plain versions."""
    import torch

    import chip_smoke
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS as PORT_CONFIGS

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_MONITOR", "1")
    mcfg = PORT_CONFIGS["tiny-dense"]
    geometry = dict(kv_page_size=8, max_pages_per_seq=64, decode_batch_size=4,
                    max_model_len=512, decode_multi_step=4, param_dtype="float32",
                    activation_dtype="float32")
    runner = ModelRunner(mcfg, EngineConfig(**{**geometry, "param_dtype": "bfloat16"}),
                         device="cpu")
    chip_smoke.write_checkpoint(torch, runner.params, mcfg, tmp_path / "ckpt" / mcfg.name)
    out = chip_smoke.serve_fleet(
        torch, [], [], "cpu", tmp_path / "ckpt", model="tiny-dense", device="cpu",
        geometry=geometry, n_rows=8, n_failover=24, n_new=8, n_sessions=4, chat_new=8,
        system_chars=40, flush_every=8)
    fo = out["failover"]
    assert fo["rows_lost"] == fo["rows_duplicated"] == 0
    assert fo["rows_stored_before_kill"] >= 8 and fo["doctor"] != "healthy"
    # the CPU's arithmetic is the same at every batch shape
    assert fo["resumed_equal_to_unkilled"] == fo["resumed_rows"]
    assert out["routing"]["a"]["owner"] == "r0" and out["routing"]["b"]["owner"] == "r1"
    assert out["trace"]["cpu_ops"] > 0 and out["trace"]["kernel_events"] == 0
    assert out["replay"]["ok"] == 8 and out["stitched"]["processes"][0] == "router"
    assert out["split_vs_full_rel_l2"] < chip_smoke.REL_L2
    summary = chip_smoke.fleet_summary(out)
    assert summary["rows_lost"] == 0 and summary["stitched_spans"] > 0
