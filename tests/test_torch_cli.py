"""The port's ``sutro`` CLI (``sutro_tpu_torch/cli.py``) under click's
``CliRunner``, against the JAX package's CLI.

The scenarios of ``tests/test_cli.py``, with the port's engine built on
the CPU first (``get_engine(ecfg, device="cpu")``: the CLI's local
backend builds its engine on the card otherwise). Where the output does
not name the backend or a job's own ids and times, the same command on
the same kind of state gives the JAX CLI's output, byte for byte. Also:
``engine info`` on the CPU, a data-parallel job's fleet view in ``jobs
status``, and the ``fleet status`` and ``replay record`` commands over a
port router (the JAX package's ``test_fleet.py`` and
``test_fleet_obs.py`` hold its own CLI there).
"""

import json
import time

import pytest
import torch
from click.testing import CliRunner

from sutro_tpu.cli import cli as jax_cli
from sutro_tpu.engine import api as jax_api
from sutro_tpu_torch.cli import cli
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine.config import EngineConfig, load_engine_config
from sutro_tpu_torch.validation import load_config

torch.set_num_threads(1)

TINY = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", activation_dtype="float32",
    max_new_tokens=8,
)


@pytest.fixture()
def runner(tmp_path, monkeypatch):
    """A fresh empty home with the port's engine built on the CPU."""
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "port"))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    api.reset_engine()
    api.get_engine(EngineConfig(**TINY), device="cpu")
    yield CliRunner()
    api.reset_engine()


def jax_invoke(args, home, monkeypatch, input=None):
    """The JAX CLI's run of ``args`` in a fresh home of its own."""
    with monkeypatch.context() as m:
        m.setenv("SUTRO_HOME", str(home))
        jax_api.reset_engine()
        try:
            return CliRunner().invoke(jax_cli, args, input=input)
        finally:
            jax_api.reset_engine()


def same_as_jax(runner, args, tmp_path, monkeypatch, input=None):
    """Run ``args`` through both CLIs on fresh homes: the same exit code
    and output. Returns the port's result."""
    res = runner.invoke(cli, args, input=input)
    ref = jax_invoke(args, tmp_path / "jax", monkeypatch, input=input)
    assert (res.exit_code, res.output) == (ref.exit_code, ref.output)
    return res


def test_quotas(runner, tmp_path, monkeypatch):
    res = same_as_jax(runner, ["quotas"], tmp_path, monkeypatch)
    assert res.exit_code == 0 and "row_quota" in res.output


def test_engine_models(runner, tmp_path, monkeypatch):
    res = same_as_jax(runner, ["engine", "models"], tmp_path, monkeypatch)
    assert res.exit_code == 0
    assert "qwen-3-32b" in res.output and "gpt-oss-120b" in res.output


def test_engine_info(runner, tmp_path, monkeypatch):
    """On the CPU: the backend and devices torch sees, the mesh for one
    device, and the JAX CLI's kv line for the same config."""
    res = runner.invoke(cli, ["engine", "info"])
    assert res.exit_code == 0
    lines = res.output.splitlines()
    assert lines[:3] == [
        "backend: cpu", "devices: ['cpu']", "mesh: dp=1 pp=1 sp=1 ep=1 tp=1",
    ]
    ref = jax_invoke(["engine", "info"], tmp_path / "jax", monkeypatch)
    assert lines[3] == ref.output.splitlines()[3]
    assert lines[3].startswith("kv: page_size=")


def test_engine_info_on_cuda_names_each_card(runner, monkeypatch):
    """With a card, ``engine info`` names the backend ``cuda`` and each
    device torch reports (torch's device calls stubbed here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"H100 #{i}")
    res = runner.invoke(cli, ["engine", "info"])
    assert res.exit_code == 0
    dp, pp, sp, ep, tp = load_engine_config().resolved_mesh(2)
    assert res.output.splitlines()[:3] == [
        "backend: cuda", "devices: ['H100 #0', 'H100 #1']",
        f"mesh: dp={dp} pp={pp} sp={sp} ep={ep} tp={tp}",
    ]


def test_datasets_create_and_files(runner, tmp_path):
    res = runner.invoke(cli, ["datasets", "create"])
    assert res.exit_code == 0
    ds = res.output.strip().splitlines()[-1]
    assert ds.startswith("dataset-")
    f = tmp_path / "a.txt"
    f.write_text("row1\nrow2\n")
    assert runner.invoke(cli, ["datasets", "upload", ds, str(f)]).exit_code == 0
    assert "a.txt" in runner.invoke(cli, ["datasets", "files", ds]).output
    assert ds in runner.invoke(cli, ["datasets", "list"]).output


def test_cache_show_empty(runner, tmp_path, monkeypatch):
    assert same_as_jax(runner, ["cache", "show"], tmp_path, monkeypatch).exit_code == 0


def test_set_base_url_and_backend(runner, tmp_path, monkeypatch):
    same_as_jax(runner, ["set-base-url", "https://example.test"], tmp_path, monkeypatch)
    same_as_jax(runner, ["set-backend", "tpu"], tmp_path, monkeypatch)
    cfg = load_config()
    assert cfg["base_url"] == "https://example.test" and cfg["backend"] == "tpu"


def test_jobs_list_empty(runner, tmp_path, monkeypatch):
    assert same_as_jax(runner, ["jobs", "list"], tmp_path, monkeypatch).exit_code == 0


def test_jobs_attach_no_jobs_fails(runner, tmp_path, monkeypatch):
    res = same_as_jax(runner, ["jobs", "attach", "--latest"], tmp_path, monkeypatch)
    assert res.exit_code == 1 and "No jobs" in res.output


# ---------------------------------------------------------------------------
# the job lifecycle against a live port engine: one module home and
# engine, so every `get_sdk()` the CLI builds shares the singleton
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live(tmp_path_factory, monkeypatch_module):
    from sutro_tpu_torch.sdk import Sutro

    home = tmp_path_factory.mktemp("torch-cli-home")
    monkeypatch_module.setenv("SUTRO_HOME", str(home))
    monkeypatch_module.setenv("SUTRO_MONITOR", "0")
    (home / "engine.json").write_text(json.dumps(TINY))
    api.reset_engine()
    api.get_engine(load_engine_config(), device="cpu")
    yield CliRunner(), Sutro(), home
    api.reset_engine()


def _submitted_job(sdk, n=2, await_done=True, **kw):
    jid = sdk.infer(
        [f"cli row {i}" for i in range(n)], model="tiny-dense", stay_attached=False,
        sampling_params={"max_new_tokens": 4, "temperature": 0.0}, **kw,
    )
    if await_done:
        sdk.await_job_completion(jid, unpack_json=False)
    return jid


def test_jobs_status_and_list_show_job(live):
    runner, sdk, _ = live
    jid = _submitted_job(sdk)
    res = runner.invoke(cli, ["jobs", "status", jid])
    assert res.exit_code == 0 and "SUCCEEDED" in res.output
    res = runner.invoke(cli, ["jobs", "list"])
    assert res.exit_code == 0 and jid in res.output


def test_jobs_results_stdout_and_parquet(live, tmp_path):
    import pandas as pd

    runner, sdk, _ = live
    jid = _submitted_job(sdk)
    res = runner.invoke(cli, ["jobs", "results", jid])
    assert res.exit_code == 0 and "inference_result" in res.output
    out = tmp_path / "res.parquet"
    res = runner.invoke(cli, ["jobs", "results", jid, "--output-path", str(out)])
    assert res.exit_code == 0
    df = pd.read_parquet(out)
    assert len(df) == 2 and "inference_result" in df.columns


def test_jobs_results_unknown_id_exits_nonzero(live, tmp_path, monkeypatch):
    runner, _, _ = live
    res = runner.invoke(cli, ["jobs", "results", "job-nonexistent"])
    ref = jax_invoke(["jobs", "results", "job-nonexistent"], tmp_path / "jax", monkeypatch)
    assert res.exit_code != 0 and res.exit_code == ref.exit_code


def test_jobs_cancel_then_resume(live):
    runner, sdk, _ = live
    # enough rows that cancellation lands mid-flight or queued
    jid = _submitted_job(sdk, n=6, await_done=False)
    res = runner.invoke(cli, ["jobs", "cancel", jid])
    assert res.exit_code == 0 and "Status:" in res.output
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if sdk.get_job_status(jid) in ("CANCELLED", "SUCCEEDED"):
            break
        time.sleep(0.05)
    status = sdk.get_job_status(jid)
    res = runner.invoke(cli, ["jobs", "resume", jid])
    assert res.exit_code == 0
    if status == "CANCELLED":
        assert "Resumed" in res.output
        sdk.await_job_completion(jid, unpack_json=False)
        assert sdk.get_job_status(jid) == "SUCCEEDED"
    else:
        # raced to completion before the cancel landed: resume refuses
        assert "Not resumed" in res.output


def test_doctor_command_renders_verdict(live):
    runner, sdk, _ = live
    jid = _submitted_job(sdk)
    res = runner.invoke(cli, ["doctor", jid])
    assert res.exit_code == 0 and "verdict:" in res.output and "rank0" in res.output
    res = runner.invoke(cli, ["doctor", jid, "--json"])
    assert res.exit_code == 0
    diag = json.loads(res.output)
    assert diag["job_id"] == jid and diag["verdict"]


def test_trace_command_writes_perfetto_json(live, tmp_path):
    runner, sdk, _ = live
    jid = _submitted_job(sdk)
    out = tmp_path / "trace.json"
    res = runner.invoke(cli, ["trace", jid, "-o", str(out)])
    assert res.exit_code == 0, res.output
    assert "ui.perfetto.dev" in res.output and "verdict:" in res.output
    doc = json.loads(out.read_text())
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "decode_window" in names and "queue_wait" in names
    assert doc["otherData"]["verdict"]["trace_id"] == f"tr-{jid}"
    res = runner.invoke(cli, ["trace", f"tr-{jid}", "--json"])
    assert res.exit_code == 0 and json.loads(res.output)["otherData"]["verdict"]
    assert runner.invoke(cli, ["trace", "tr-nope"]).exit_code != 0


def test_jobs_status_hints_at_telemetry_dump(live):
    runner, sdk, _ = live
    jid = _submitted_job(sdk)
    sdk.get_job_telemetry(jid)  # an on-demand refresh persists telemetry.json
    res = runner.invoke(cli, ["jobs", "status", jid])
    assert res.exit_code == 0 and "sutro doctor" in res.output


def test_jobs_status_shows_a_dp_jobs_fleet(live):
    """A data-parallel job's final fleet view (``jobs/<id>/fleet.json``,
    as rank 0 writes it after its round) renders under ``jobs status``
    as the JAX CLI renders it."""
    runner, sdk, home = live
    jid = _submitted_job(sdk)
    snap = {
        "job_id": jid, "elastic": True, "world": 2, "live_ranks": 0,
        "rows": {"total": 2, "done": 2, "pending": 0, "inflight": 0},
        "counters": {"requeued_rows": 1, "stolen_rows": 0, "duplicate_results_dropped": 0},
        "ranks": {
            "0": {"state": "done", "elastic": True, "late_join": False, "rows_remaining": 0},
            "1": {"state": "lost", "elastic": True, "late_join": False,
                  "rows_remaining": 1, "reason": "worker connection lost"},
        },
    }
    (home / "jobs" / jid / "fleet.json").write_text(json.dumps(snap))
    res = runner.invoke(cli, ["jobs", "status", jid])
    assert res.exit_code == 0
    assert (
        "dp fleet (final): 0 live rank(s) of world 2; rows 2/2 done, 0 pending, "
        "0 in flight; requeued=1 stolen=0 dup_dropped=0"
    ) in res.output
    assert "  rank 0: done\n  rank 1: lost 1 row(s) remaining worker connection lost" in res.output


def test_jobs_resume_succeeded_refuses(live):
    runner, sdk, _ = live
    jid = _submitted_job(sdk)
    res = runner.invoke(cli, ["jobs", "resume", jid])
    assert res.exit_code == 0
    assert "Not resumed" in res.output and "succeeded" in res.output


def test_jobs_attach_latest_completed(live):
    runner, sdk, _ = live
    _submitted_job(sdk)
    assert runner.invoke(cli, ["jobs", "attach", "--latest"]).exit_code == 0


def test_login_local_backend_no_key(live):
    runner, _, _ = live
    res = runner.invoke(cli, ["login"], input="\n")
    assert res.exit_code == 0 and "Logged in" in res.output


def test_login_stores_key(live):
    runner, _, _ = live
    assert runner.invoke(cli, ["login"], input="sk-test-123\n").exit_code == 0
    assert load_config().get("api_key") == "sk-test-123"


def test_datasets_download(live, tmp_path):
    runner, _, _ = live
    ds = runner.invoke(cli, ["datasets", "create"]).output.strip().splitlines()[-1]
    src = tmp_path / "up.txt"
    src.write_text("hello\nworld\n")
    assert runner.invoke(cli, ["datasets", "upload", ds, str(src)]).exit_code == 0
    dest = tmp_path / "down"
    dest.mkdir()
    res = runner.invoke(cli, ["datasets", "download", ds, "--output-path", str(dest)])
    assert res.exit_code == 0
    assert (dest / "up.txt").read_text() == "hello\nworld\n"


# ---------------------------------------------------------------------------
# fleet and replay over a port router
# ---------------------------------------------------------------------------


@pytest.fixture()
def port_fleet(tmp_path, monkeypatch):
    """Two port engines on the CPU behind the port's router, and the
    CLI's config pointing at the router."""
    from sutro_tpu_torch.fleet import router
    from sutro_tpu_torch.server import start_server_thread

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    cfg = EngineConfig(interactive_slots=2, **TINY)
    engines = [api.LocalEngine(cfg, device="cpu") for _ in range(2)]
    servers = [start_server_thread(e) for e in engines]
    monkeypatch.setenv("SUTRO_MONITOR", "1")
    rtr, fsrv, _, furl = router.start_fleet_thread(
        [url for _, _, url in servers], probe_interval=0.2,
        monitor_interval=0.25, monitor_window=3.0,
    )
    deadline = time.monotonic() + 30
    while rtr.membership.snapshot()["n_healthy"] < 2:
        assert time.monotonic() < deadline, "both replicas healthy"
        time.sleep(0.05)
    runner = CliRunner()
    assert runner.invoke(cli, ["set-base-url", furl]).exit_code == 0
    assert runner.invoke(cli, ["set-backend", "fleet"]).exit_code == 0
    yield runner, furl
    rtr.stop()
    fsrv.shutdown()
    for srv, _, _ in servers:
        srv.shutdown()
    for e in engines:
        e.close(timeout=30)


def test_cli_fleet_status_renders_router_snapshot(port_fleet):
    runner, _ = port_fleet
    out = runner.invoke(cli, ["fleet", "status", "--json"])
    assert out.exit_code == 0, out.output
    assert json.loads(out.output)["n_replicas"] == 2
    out = runner.invoke(cli, ["fleet", "status"])
    assert out.exit_code == 0, out.output
    assert "verdict" in out.output and "probe-only routes" in out.output


def test_replay_record_and_run_over_a_port_router(port_fleet, tmp_path):
    """A routed chat is captured in the router's replay log; ``replay
    record`` writes it as JSONL the replay module reads back, and
    ``replay run`` sends it through the router again."""
    import urllib.request

    from sutro_tpu_torch.fleet import replay as replay_mod

    runner, furl = port_fleet
    req = urllib.request.Request(
        furl + "/v1/chat/completions", method="POST",
        data=json.dumps({
            "model": "tiny-dense", "temperature": 0, "max_tokens": 4,
            "session_id": "replay-capture-sess",
            "messages": [{"role": "user", "content": "record this turn"}],
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
    out_path = tmp_path / "captured.jsonl"
    out = runner.invoke(cli, ["replay", "record", "-o", str(out_path)])
    assert out.exit_code == 0, out.output
    loaded = replay_mod.load_jsonl(out_path)
    withbody = [r for r in loaded if r.get("body")]
    assert withbody and withbody[-1]["kind"] == "chat"
    assert withbody[-1].get("session_id") == "replay-capture-sess"
    # fleet status renders the route's observability lines
    out = runner.invoke(cli, ["fleet", "status"])
    assert out.exit_code == 0, out.output
    assert "probe-only routes" in out.output and "route latency" in out.output
    out = runner.invoke(cli, ["replay", "run", str(out_path), "--timeout", "120"])
    assert out.exit_code == 0, out.output
    assert "sent" in out.output
