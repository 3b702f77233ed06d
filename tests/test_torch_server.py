"""The port's HTTP server (``server.py``) against the JAX package's.

A JAX server and the port's, each on an ephemeral port over its own
engine (both on the same tiny-dense checkpoint, interactive tier on),
are driven by the port's remote SDK (``Sutro(backend="remote")``, over
``urllib``) and by raw ``urllib`` requests. They give the same JSON,
once job and dataset ids and times are blanked, for: auth, quotas,
submit, detach and results, the NDJSON progress records with their end
record, the job list and status, the cancel of a queued job, datasets
(multipart upload, list, download), ``/functions/run``,
``/fleet-state``, ``/fleet-warm``, ``/v1/chat/completions`` and
``/v1/completions`` collected, the typed ``InvalidPriority`` 400, a
404 on an unknown route, ``/monitor`` with the monitor off and a bad
``stages`` payload and ``/job-fleet/{id}`` (a 404 for an unknown job,
the fleet view of one that ran no dp round). ``_graceful_shutdown``
refuses new requests with a 503 while a stream finishes.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from sutro_tpu import server as jax_server
from sutro_tpu_torch import server
from sutro_tpu_torch.engine.jobstore import InvalidPriority
from sutro_tpu_torch.sdk import Sutro
from tests.test_torch_api import wait
from tests.test_torch_serving import engine_pair

ROWS = ["first row", "the second row", "row three"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"jax": (engine, url), "port": (engine, url)}."""
    jeng, teng, mp = engine_pair(tmp_path_factory, "torch-server")
    jsrv, _, jurl = jax_server.start_server_thread(jeng)
    tsrv, tthread, turl = server.start_server_thread(teng)
    yield {"jax": (jeng, jurl), "port": (teng, turl)}
    jsrv.shutdown()
    tsrv.shutdown()
    tthread.join(timeout=30)
    assert not tthread.is_alive()
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def _req(url, method="GET", body=None, headers=None):
    """(status, decoded JSON or text) of one raw ``urllib`` request."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


_IDS = [(re.compile(r"job-[0-9a-f]{8,}"), "job-X"), (re.compile(r"dataset-[0-9a-f]+"), "dataset-X"),
        (re.compile(r"ivr-\d+"), "ivr-N")]
_DROP = {"created", "datetime_created", "datetime_started", "datetime_completed",
         "datetime_added", "updated_at", "total_tokens_processed_per_second",
         "tokens_per_second_per_chip", "perf", "has_telemetry_dump"}


def norm(obj):
    """``obj`` with ids blanked and times and rates dropped."""
    if isinstance(obj, dict):
        return {norm(k): norm(v) for k, v in obj.items() if k not in _DROP}
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    if isinstance(obj, str):
        for pat, rep in _IDS:
            obj = pat.sub(rep, obj)
    return obj


def both(served, fn):
    """``fn(engine, url)`` on the JAX server and the port's, normalized."""
    return tuple(norm(fn(*served[k])) for k in ("jax", "port"))


def test_auth_quotas_and_unknown_routes(served):
    for path, method in (("try-authentication", "GET"), ("get-quotas", "GET"),
                         ("no-such-route", "GET"), ("no-such-route", "POST"),
                         ("jobs/job-0000000000000000", "GET"), ("healthz", "GET"),
                         ("fleet-state", "GET"), ("list-datasets", "POST")):
        got, want = both(served, lambda e, u: _req(f"{u}/{path}", method,
                                                  b"{}" if method == "POST" else None))
        assert got == want, path
    got, want = both(served, lambda e, u: Sutro(backend="remote", base_url=u).get_quotas())
    assert got == want


def test_submit_detach_progress_results(served):
    def run(eng, url):
        c = Sutro(backend="remote", base_url=url, api_key="k")
        jid = c.infer(ROWS, model="tiny-dense", stay_attached=False, system_prompt="Be brief.",
                      sampling_params={"temperature": 0.0, "max_new_tokens": 6})
        assert c.await_job_completion(jid, obtain_results=False, timeout=300) == jid
        status, lines = _req(f"{url}/stream-job-progress/{jid}")
        assert status == 200
        records = [json.loads(x) for x in lines.splitlines() if x]
        listed = [j for j in c.list_jobs() if j["job_id"] == jid]
        return {
            "status": c.get_job_status(jid),
            "job_status": _req(f"{url}/job-status/{jid}"),
            "progress": [r for r in records if r.get("update_type") != "tokens"],
            "sdk_progress": [u for u in c._iter_progress(jid) if u["update_type"] == "progress"],
            "results": _req(f"{url}/job-results", "POST",
                            {"job_id": jid, "include_inputs": True,
                             "include_cumulative_logprobs": True}),
            "record": {k: c._fetch_job(jid)[k] for k in (
                "status", "num_rows", "input_tokens", "output_tokens", "job_priority",
                "model", "system_prompt", "sampling_params")},
            "listed": [{k: j[k] for k in ("job_id", "status", "num_rows")} for j in listed],
        }

    got, want = both(served, run)
    assert got["status"] == "SUCCEEDED" and got["progress"][-1] == {"t": "end",
                                                                  "status": "SUCCEEDED"}
    got["results"][1]["results"]["cumulative_logprobs"] = pytest.approx(
        want["results"][1]["results"]["cumulative_logprobs"], abs=1e-3)
    assert got == want


def test_cancel_of_a_queued_job(served):
    def run(eng, url):
        gate, real = threading.Event(), eng._run_job

        def held(job_id):
            gate.wait(60)
            return real(job_id)

        eng._run_job = held
        try:
            c = Sutro(backend="remote", base_url=url)
            payload = dict(model="tiny-dense", stay_attached=False,
                           sampling_params={"temperature": 0.0, "max_new_tokens": 4})
            first = c.infer(ROWS[:1], **payload)
            queued = c.infer(ROWS[1:], job_priority=1, **payload)
            before = c.get_job_status(queued)
            cancelled = _req(f"{url}/job-cancel/{queued}")
        finally:
            gate.set()
            del eng._run_job
        assert wait(eng, first) == "SUCCEEDED"
        return before, cancelled, c.get_job_status(queued), _req(f"{url}/job-cancel/{queued}")

    got, want = both(served, run)
    assert got == want and got[1] == [200, {"status": "CANCELLED"}]


def test_invalid_priority_is_a_typed_400(served):
    for k in ("jax", "port"):
        c = Sutro(backend="remote", base_url=served[k][1])
        with pytest.raises(InvalidPriority) as e:
            c.infer(ROWS, model="tiny-dense", job_priority=7, stay_attached=False)
        assert e.value.n_levels == 2 and e.value.priority == 7
    got, want = both(served, lambda e, u: _req(f"{u}/batch-inference", "POST", {
        "model": "tiny-dense", "inputs": ROWS, "job_priority": 9}))
    assert got == want and got[0] == 400


def test_datasets_over_multipart(served, tmp_path):
    src = tmp_path / "rows.csv"
    src.write_text("id,text\n1,alpha\n2,beta gamma\n")

    def run(eng, url):
        c = Sutro(backend="remote", base_url=url)
        ds = c.create_dataset()
        up = c.upload_to_dataset(ds, str(src))
        files = c.list_dataset_files(ds)
        out = tmp_path / ("dl-" + url.rsplit(":", 1)[1])
        got = c.download_from_dataset(ds, output_path=str(out))
        listed = [d for d in c.list_datasets() if d["dataset_id"] == ds]
        jid = c.infer(ds, column="text", model="tiny-dense", stay_attached=False,
                      sampling_params={"temperature": 0.0, "max_new_tokens": 3})
        assert c.await_job_completion(jid, obtain_results=False, timeout=300) == jid
        inputs = _req(f"{url}/job-results", "POST", {"job_id": jid, "include_inputs": True})
        return (up, files, [open(p).read() for p in got], listed, inputs,
                _req(f"{url}/upload-to-dataset", "POST", b"not multipart",
                     {"Content-Type": "text/plain"}))

    got, want = both(served, run)
    assert got == want and got[2] == [src.read_text()]


def test_functions_run(served):
    """The engine's default sampling is not greedy (and the port's random
    streams are its own), so the reply's text and length may differ."""
    got, want = both(served, lambda e, u: _req(f"{u}/functions/run", "POST", {
        "name": "tiny-dense", "input_data": {"q": "what is two plus two"}}))
    assert got[0] == want[0] == 200
    for doc in (got[1], want[1]):
        doc.pop("response")
        doc["usage"].pop("output_tokens")
    assert got == want
    assert set(got[1]) == {"confidence", "predictions", "run_id", "usage"}


def test_openai_routes_and_fleet_frames(served):
    chat = {"model": "tiny-dense", "temperature": 0.0, "max_tokens": 5,
            "messages": [{"role": "system", "content": "You are terse."},
                         {"role": "user", "content": "say something"}]}
    for path, body in (("v1/chat/completions", chat),
                       ("v1/completions", {"model": "tiny-dense", "prompt": "once upon a",
                                           "max_tokens": 5, "temperature": 0.0}),
                       ("v1/chat/completions", {"model": "tiny-dense", "messages": []}),
                       ("v1/chat/completions", dict(chat, model="no-such-model")),
                       ("v1/completions", {"model": "tiny-dense", "prompt": "x",
                                           "session_id": "s"}),
                       ("fleet-warm", {"t": "warm_probe", "chat": True, "body": chat}),
                       ("fleet-warm", {"t": "warm_probe"})):
        got, want = both(served, lambda e, u: _req(f"{u}/{path}", "POST", body))
        assert got == want, path
    got, want = both(served, lambda e, u: Sutro(backend="remote", base_url=u).chat(
        "hello", model="tiny-dense", temperature=0.0, max_tokens=4))
    assert got == want
    streamed = list(Sutro(backend="remote", base_url=served["port"][1]).chat(
        "hello", model="tiny-dense", temperature=0.0, max_tokens=4, stream=True))
    assert "".join(c["choices"][0]["delta"].get("content", "") for c in streamed) == \
        got["choices"][0]["message"]["content"]
    status, frame = _req(f"{served['port'][1]}/fleet-state")
    assert status == 200 and frame["t"] == "fleet_state" and frame["models"] == ["tiny-dense"]


def test_what_the_port_has_not_ported(served):
    """Nothing is refused any more. With the monitor off (as in this
    module) both servers answer ``/monitor`` 404; ``/job-fleet/{id}``
    answers 404 for an unknown job and the same fleet view for a job
    that ran no dp round; a ``stages`` payload is a stage-graph job, and
    a bad one the same 400."""
    eng, url = served["port"]
    jurl = served["jax"][1]
    for path in ("monitor", "monitor/stream"):
        (status, body), (jstatus, jbody) = (_req(f"{u}/{path}") for u in (url, jurl))
        assert status == jstatus == 404 and "disabled" in body["detail"]
    (status, _), (jstatus, _) = (_req(f"{u}/job-fleet/job-0000000000000000")
                                 for u in (url, jurl))
    assert status == jstatus == 404
    views = []
    for u in (url, jurl):
        _, sub = _req(f"{u}/batch-inference", "POST",
                      {"model": "tiny-dense", "inputs": ROWS, "dry_run": True})
        views.append((sub["results"], _req(f"{u}/job-fleet/{sub['results']}")))
    for jid, (status, body) in views:
        assert (status, body) == (200, {"fleet": {"job_id": jid, "elastic": False}})
    bad = {"model": "tiny-dense", "inputs": ROWS, "stages": [{"name": "a", "after": ["b"]}]}
    assert _req(f"{url}/batch-inference", "POST", bad) == _req(f"{jurl}/batch-inference",
                                                                "POST", bad)
    status, body = _req(f"{url}/batch-inference", "POST",
                        {"model": "tiny-dense", "inputs": ROWS, "stages": [{"name": "a"}],
                         "sampling_params": {"max_new_tokens": 2}})
    assert status == 200
    assert wait(eng, body["results"]) == "SUCCEEDED"


def test_graceful_shutdown_refuses_new_requests_and_finishes_streams(served):
    """A second port server over the same engine: a stream in flight
    finishes with ``[DONE]`` while new requests get a 503."""
    eng, _ = served["port"]
    srv, thread, url = server.start_server_thread(eng)
    c = Sutro(backend="remote", base_url=url)
    stream = c.chat("a long answer please", model="tiny-dense", temperature=0.0,
                    max_tokens=48, stream=True)
    first = next(stream)
    shut = threading.Thread(target=server._graceful_shutdown, args=(eng, srv, 60))
    shut.start()
    try:
        deadline = 200
        while not eng.gateway.draining and deadline:
            deadline -= 1
            threading.Event().wait(0.01)
        status, body = _req(f"{url}/v1/chat/completions", "POST", {
            "model": "tiny-dense", "messages": [{"role": "user", "content": "late"}]})
        assert status == 503 and body["error"]["type"] == "service_unavailable"
        assert _req(f"{url}/healthz")[0] == 503
        rest = list(stream)
        assert rest and rest[-1]["choices"][0]["finish_reason"] in ("stop", "length")
        assert first["choices"][0]["delta"].get("role") == "assistant"
    finally:
        shut.join(timeout=120)
        thread.join(timeout=30)
        eng.gateway.draining = False
    assert not shut.is_alive() and not thread.is_alive()


def test_smoke_serve7_runs_at_a_tiny_size(tmp_path, monkeypatch):
    """``chip_smoke.py``'s serve 7 end to end on the CPU at a tiny size
    (tiny-dense from a bfloat16 checkpoint, 16 rows, 3 sessions): every
    check it makes on the card passes here with the plain versions."""
    import torch

    import chip_smoke
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    # serve 7 reads the live monitor, which this module's engines run without
    monkeypatch.setenv("SUTRO_MONITOR", "1")
    mcfg = MODEL_CONFIGS["tiny-dense"]
    geometry = dict(kv_page_size=8, max_pages_per_seq=128, decode_batch_size=8,
                    max_model_len=1024, decode_multi_step=4, param_dtype="float32",
                    activation_dtype="float32")
    runner = ModelRunner(mcfg, EngineConfig(**{**geometry, "param_dtype": "bfloat16"}),
                         device="cpu")
    chip_smoke.write_checkpoint(torch, runner.params, mcfg, tmp_path / "ckpt" / mcfg.name)
    out = chip_smoke.serve_online(
        torch, [], [], "cpu", tmp_path / "ckpt", model="tiny-dense", device="cpu",
        geometry=geometry, n_rows=16, n_sessions=3, n_stream=2, n_oneshot=1, n_new=16,
        system_chars=40, burst_after=2)
    assert out["store"]["hits"] >= 2 and out["tier"]["promoted_pages_checked"] >= 1
    assert out["warm_vs_cold_rel_l2"] < chip_smoke.REL_L2
    assert len(out["replayed"]) == 4
