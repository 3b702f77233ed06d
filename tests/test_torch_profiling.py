"""The port's device traces (``engine/profiling.py`` ``job_trace``,
``observability.profile_trace``) against the JAX package's.

- A CPU job on an engine with ``profile_dir`` writes
  ``{profile_dir}/{job_id}/trace.json`` with the job's ops, and its
  telemetry's ``profile_trace`` attr names that directory, as the JAX
  engine's names its own (both engines on one checkpoint).
- Nested traces (co-batched jobs) share one: the first starts it, the
  second joins, the last one out stops it, and both jobs' attrs name
  the first's directory, as the JAX package's refcount does (its
  ``jax.profiler`` replaced by a recorder); sequential traces restart.
- ``profile_dir=None`` starts no profiler; a failing stop logs and never
  raises into the job.
- ``SUTRO_PROFILE=1`` wraps a block in a trace; unset, nothing is
  written.
"""

import json
import os
import time

import pytest
import torch

from sutro_tpu import telemetry as jax_telemetry
from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine import profiling as jax_profiling
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch import observability, telemetry
from sutro_tpu_torch.engine import api, profiling
from sutro_tpu_torch.engine.config import EngineConfig
from tests.test_torch_api import ENGINE, _no_native_masks, wait
from tests.test_torch_weights_loader import write_hf_checkpoint


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-profiling")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 21, root / "weights" / "tiny-dense")
    cfg = dict(ENGINE, weights_dir=str(root / "weights"))
    mp.setattr(jax_cpp, "CppMasker", _no_native_masks)
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False,
                                               profile_dir=str(root / "jax-prof"), **cfg))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(profile_dir=str(root / "port-prof"), **cfg),
                           device="cpu")
    yield jeng, teng, root
    jeng.close(timeout=30)
    teng.close(timeout=30)
    mp.undo()


def test_a_cpu_job_writes_its_trace_and_names_it_as_the_jax_engine(engines):
    jeng, teng, root = engines
    payload = {"model": "tiny-dense", "inputs": ["trace this row", "and this"],
               "sampling_params": {"temperature": 0.0, "max_new_tokens": 6}}
    attrs = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        jid = eng.submit_batch_inference(dict(payload))
        assert wait(eng, jid) == "SUCCEEDED"
        attrs[name] = (jid, eng.job_telemetry(jid)["attrs"]["profile_trace"])
    jid, path = attrs["port"]
    assert path == os.path.join(str(root / "port-prof"), jid)
    jjid, jpath = attrs["jax"]
    assert jpath == os.path.join(str(root / "jax-prof"), jjid)
    # the stop (and its export) comes after the job's terminal status
    trace = os.path.join(path, profiling.TRACE_FILE)
    deadline = time.monotonic() + 60
    while not os.path.exists(trace):
        assert time.monotonic() < deadline, "no trace.json"
        time.sleep(0.02)
    ops = [e for e in _events(trace) if e.get("cat") == "cpu_op"]
    names = {e["name"] for e in ops}
    assert {"aten::mm", "aten::softmax"} & names or "aten::matmul" in names, sorted(names)[:20]
    # every op on one thread: the worker that drove the batcher
    assert len({e["tid"] for e in ops}) == 1
    # CPU only: the caller asked for the CPU
    assert not any(e.get("cat") == "kernel" for e in _events(trace))
    last = profiling.last_trace()
    assert last["file"] == trace and last["bytes"] == os.path.getsize(trace)
    assert last["export_s"] >= 0


def _recording_jax_profiler(monkeypatch):
    import jax

    calls = {"start": [], "stop": 0}

    def fake_start(path):
        if calls["start"] and calls["stop"] < len(calls["start"]):
            raise RuntimeError("Profiler is already started")
        calls["start"].append(path)

    def fake_stop():
        calls["stop"] += 1

    monkeypatch.setattr(jax.profiler, "start_trace", fake_start)
    monkeypatch.setattr(jax.profiler, "stop_trace", fake_stop)
    return calls


def _recording_port_profiler(monkeypatch):
    calls = {"start": [], "stop": 0}
    real_start, real_stop = profiling._start, profiling._stop

    def start(path, device):
        calls["start"].append(path)
        return real_start(path, device)

    def stop(prof, path):
        calls["stop"] += 1
        return real_stop(prof, path)

    monkeypatch.setattr(profiling, "_start", start)
    monkeypatch.setattr(profiling, "_stop", stop)
    return calls


@pytest.mark.skipif(not (telemetry.ENABLED and jax_telemetry.ENABLED),
                    reason="the profile_trace attr lives in telemetry")
def test_co_batched_jobs_share_one_trace_as_in_the_jax_package(tmp_path, monkeypatch):
    out = {}
    # job ids of this test alone: the telemetry stores are process-wide
    a, b = (f"job-{tmp_path.name}-{x}" for x in "ab")
    for name, mod, tel, calls in (
        ("jax", jax_profiling, jax_telemetry, _recording_jax_profiler(monkeypatch)),
        ("port", profiling, telemetry, _recording_port_profiler(monkeypatch)),
    ):
        pd = str(tmp_path / name)
        with mod.job_trace(pd, a):
            with mod.job_trace(pd, b):
                x = torch.randn(16, 16)
                (x @ x).sum()
            inner_stops = calls["stop"]
        out[name] = (
            [os.path.relpath(p, pd) for p in calls["start"]], inner_stops, calls["stop"],
            [os.path.relpath(tel.JOBS.peek(j).attrs["profile_trace"], pd) for j in (a, b)],
        )
    assert out["port"] == out["jax"] == ([a], 0, 1, [a, a])
    events = _events(tmp_path / "port" / a / profiling.TRACE_FILE)
    assert any(e.get("name") == "aten::mm" for e in events)
    assert not (tmp_path / "port" / b).exists()


def test_sequential_traces_restart_as_in_the_jax_package(tmp_path, monkeypatch):
    got = {}
    for name, mod, calls in (
        ("jax", jax_profiling, _recording_jax_profiler(monkeypatch)),
        ("port", profiling, _recording_port_profiler(monkeypatch)),
    ):
        for j in ("job-1", "job-2"):
            with mod.job_trace(str(tmp_path / name), j):
                torch.ones(4).sum()
        got[name] = ([os.path.basename(p) for p in calls["start"]], calls["stop"])
    assert got["port"] == got["jax"] == (["job-1", "job-2"], 2)
    for j in ("job-1", "job-2"):
        assert (tmp_path / "port" / j / profiling.TRACE_FILE).exists()


def test_no_profile_dir_starts_no_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(profiling, "_start", refuse)
    for pd in (None, ""):
        with profiling.job_trace(pd, "job-x"):
            torch.ones(2).sum()
    assert profiling._trace_state["count"] == 0


def test_a_failing_stop_logs_and_never_fails_the_job(tmp_path, monkeypatch, caplog):
    def broken(prof, path):
        prof.stop()
        raise RuntimeError("export failed")

    monkeypatch.setattr(profiling, "_stop", broken)
    with profiling.job_trace(str(tmp_path), "job-s"):
        torch.ones(2).sum()
    assert profiling._trace_state["count"] == 0 and profiling._trace_state["prof"] is None
    assert "device trace stop failed" in caplog.text
    # the next job starts a fresh trace
    monkeypatch.undo()
    with profiling.job_trace(str(tmp_path), "job-t"):
        torch.ones(2).sum()
    assert (tmp_path / "job-t" / profiling.TRACE_FILE).exists()


def test_sutro_profile_wraps_a_block(tmp_path, monkeypatch):
    monkeypatch.delenv("SUTRO_PROFILE", raising=False)
    with observability.profile_trace(str(tmp_path / "off")):
        torch.ones(2).sum()
    assert not (tmp_path / "off").exists()
    monkeypatch.setenv("SUTRO_PROFILE", "1")
    # the CPU's ops only, as on a machine without a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with observability.profile_trace(str(tmp_path / "on")):
        x = torch.randn(8, 8)
        (x @ x).sum()
    files = list((tmp_path / "on").iterdir())
    assert len(files) == 1 and files[0].name.startswith("trace-")
    assert any(e.get("name") == "aten::mm" for e in _events(files[0]))
    # the default directory is $SUTRO_HOME/profiles
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    with observability.profile_trace():
        torch.ones(2).sum()
    assert len(list((tmp_path / "home" / "profiles").iterdir())) == 1
