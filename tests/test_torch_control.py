"""The port's control plane (``engine/control.py``) against the JAX
package's.

- ``resolve_spec`` and ``ControlConfig.parse`` (fields, and the error of
  each malformed spec) equal the JAX package's;
- ``TokenBucket`` gives the same levels, answers and waits over a seeded
  sequence of takes, refills and puts at explicit clock readings;
- the ladder's aging, its soft-deadline veto and ``forget`` give the
  same decisions over seeded contexts and clock readings;
- the scheduler ladder end to end on tiny-dense, the same parameters in
  both packages: a priority-0 job attached once every slot of a
  priority-1 job decodes suspends P1 rows, ends first, and P1 loses no
  row; P1's greedy outputs equal a ladder-less run's and the JAX
  scheduler's with its ladder;
- ``admit_batch`` rejects an empty bucket (``QUOTA_EXCEEDED``), waits
  within its bound for a refill, and ``on_terminal`` refunds; the same
  through the port's ``LocalEngine``, where the over-bucket submit is a
  FAILED job with code ``QUOTA_EXCEEDED`` (a 429 over HTTP);
- the autotuner writes the same audit trail as the JAX one over the
  same synthetic ticks;
- the injected ``control.admit`` fault degrades the plane to
  pass-through; the gateway answers 429 when a tenant's bucket is
  empty.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.control as JC
import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
from sutro_tpu.engine import faults as jax_faults
from sutro_tpu.engine import softdeadline as jax_softdeadline
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine import api, faults, softdeadline
from sutro_tpu_torch.engine import control as C
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.server import start_server_thread

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4, max_model_len=128,
              param_dtype="float32", decode_multi_step=4)


@pytest.fixture(autouse=True)
def _no_deadline_no_faults(monkeypatch):
    monkeypatch.setattr(softdeadline, "_DEADLINE_AT", None)
    monkeypatch.setattr(jax_softdeadline, "_DEADLINE_AT", None)
    yield
    faults.clear()
    jax_faults.clear()


def _ecfg(**kw):
    return SimpleNamespace(**{"interactive_slots": 1, "decode_batch_size": 64, **kw})


# -- specs -----------------------------------------------------------------


SPECS = ["1", "on", "all", "rows=5", "rows=5,window=10,wait=0,sustain=3",
         "tokens=1e6, itokens=64 ,aging=7.5,cooldown=2.9,settle=4,slots_boost=2",
         "divisor=10,,", "rows", "bogus=1", "rows=x", " wait = 3 "]


@pytest.mark.parametrize("spec", SPECS)
def test_control_config_parse_equals_the_reference(spec):
    def parse(mod):
        try:
            return dataclasses.asdict(mod.ControlConfig.parse(spec))
        except ValueError as e:
            return ("error", str(e))

    assert parse(C) == parse(JC)


@pytest.mark.parametrize("env", [None, "", "0", "off", "rows=2", "1"])
@pytest.mark.parametrize("config", [None, "", "off", "none", "1", "rows=3"])
def test_resolve_spec_equals_the_reference(env, config, monkeypatch):
    if env is None:
        monkeypatch.delenv("SUTRO_CONTROL", raising=False)
    else:
        monkeypatch.setenv("SUTRO_CONTROL", env)
    assert C.resolve_spec(config) == JC.resolve_spec(config)


@pytest.mark.parametrize("seed", range(3))
def test_token_bucket_sequences_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    cap, window = float(rng.integers(5, 50)), float(rng.integers(1, 30))
    buckets = [mod.TokenBucket(cap, window) for mod in (C, JC)]
    for b in buckets:
        b._t = 0.0
    now, trail = 0.0, ([], [])
    for _ in range(200):
        now += float(rng.exponential(0.3))
        op, n = int(rng.integers(0, 3)), float(np.round(rng.random() * cap * 1.3, 3))
        for b, out in zip(buckets, trail):
            if op == 0:
                out.append(("take", b.try_take(n, now), b.level))
            elif op == 1:
                out.append(("until", b.time_until(n, now), b.level))
            else:
                b.put(n)
                out.append(("put", b.level))
    assert trail[0] == trail[1]


def test_ladder_aging_veto_and_forget_equal_the_reference(monkeypatch):
    rng = np.random.default_rng(7)
    planes = [mod.ControlPlane("aging=10", ecfg=_ecfg()) for mod in (C, JC)]
    ctxs = [SimpleNamespace(priority=int(rng.integers(-1, 3)), seq=i) for i in range(12)]
    decisions = ([], [])
    for step in range(150):
        now = 1000.0 + step * 0.7
        a, b = (ctxs[int(i)] for i in rng.integers(0, len(ctxs), 2))
        if step == 60:   # a deadline inside the guard: no preemption
            for mod, sd in ((C, softdeadline), (JC, jax_softdeadline)):
                monkeypatch.setattr(sd, "_DEADLINE_AT", time.monotonic() + mod.DEADLINE_GUARD_S / 2)
        if step == 90:
            monkeypatch.setattr(softdeadline, "_DEADLINE_AT", None)
            monkeypatch.setattr(jax_softdeadline, "_DEADLINE_AT", None)
        if step % 17 == 5:
            for p in planes:
                p.ladder.forget(a)
        for p, out in zip(planes, decisions):
            out.append((p.ladder.may_preempt(a, b, now), p.ladder.effective_priority(a, now),
                        sorted(p.ladder._first_seen)))
    assert decisions[0] == decisions[1]
    assert any(d[0] for d in decisions[0]) and not any(d[0] for d in decisions[0][60:90])


# -- the scheduler ladder end to end ---------------------------------------


@pytest.fixture(scope="module")
def runners():
    params = jax_transformer.init_params(MCFG, jax.random.PRNGKey(11), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    return (jax_runner.ModelRunner(MCFG, JaxEngineConfig(use_pallas=False, **ENGINE), params),
            t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE),
                                 params_from_numpy(MCFG, tree, "cpu", torch.float32),
                                 device="cpu"))


def _prompt(i, n):
    return np.random.default_rng(i).integers(3, 500, n).astype(np.int32)


def _ladder_run(sched, plane, runner):
    """P1 (10 rows, 30 tokens, no stop ids: the batch stays full) and, once
    every slot decodes, P0 (2 rows) attached: (P1 outputs, P0 outputs,
    job end order, P1's suspended rows)."""
    got1, got0, done, handed = {}, {}, [], []
    mk = lambda rows, n, off: [sched.GenRequest(  # noqa: E731
        row_id=i, prompt_ids=_prompt(off + i, 6 + i % 5), max_new_tokens=n, temperature=0.0)
        for i in range(rows)]
    b = sched.ContinuousBatcher(runner, stop_ids=())
    if plane is not None:
        b.ladder = plane.ladder
    ctx1 = sched.JobCtx(job_id="p1", pending=mk(10, 30, 0),
                        on_result=lambda r: got1.__setitem__(r.row_id, r.token_ids),
                        priority=1, seq=0)
    ctx0 = sched.JobCtx(job_id="p0", pending=mk(2, 4, 100),
                        on_result=lambda r: got0.__setitem__(r.row_id, r.token_ids),
                        priority=0, seq=1)

    def poll_new():
        if not handed and ctx1.stats["out"] >= 4 and all(s is not None for s in b.slots):
            handed.append(True)
            return ctx0
        return None

    assert b.run_multi([ctx1], on_job_done=lambda c, o: done.append((c.job_id, o)),
                       poll_new=poll_new) == "completed"
    return got1, got0, done, ctx1.stats.get("preempted", 0)


def test_scheduler_ladder_end_to_end_equals_the_reference(runners):
    jr, tr = runners
    plane = C.ControlPlane("1", ecfg=_ecfg())
    got1, got0, done, preempted = _ladder_run(t_sched, plane, tr)
    assert done == [("p0", "completed"), ("p1", "completed")]
    assert sorted(got1) == list(range(10)) and sorted(got0) == [0, 1]   # zero lost rows
    assert preempted >= 1 and plane.snapshot()["preemptions"] == preempted
    assert plane.ladder._first_seen == {}
    # P1's greedy rows are those of a run without the ladder (whose P0
    # waits for a free slot) and of the JAX scheduler with its ladder
    plain1, plain0, plain_done, none = _ladder_run(t_sched, None, tr)
    assert none == 0 and sorted(plain_done) == sorted(done)
    jax1, jax0, jax_done, jax_pre = _ladder_run(
        jax_sched, JC.ControlPlane("1", ecfg=_ecfg()), jr)
    assert got1 == plain1 == jax1 and got0 == plain0 == jax0
    assert (jax_done, jax_pre) == (done, preempted)


# -- admission --------------------------------------------------------------


def test_admit_batch_rejects_waits_and_refunds():
    p = C.ControlPlane("rows=4,tokens=100,wait=0.5,window=2", ecfg=_ecfg())
    assert p.admit_batch("acme", 1, 4, 50, job_id="j1") is None
    # empty: a refill of 1 row takes 0.5 s, within the wait: admitted
    t0 = time.monotonic()
    assert p.admit_batch("acme", 1, 1, 10, job_id="j2") is None
    assert 0.2 < time.monotonic() - t0 < 2.0
    # 4 rows take 2 s: beyond the wait, refused at once
    msg = p.admit_batch("acme", 1, 4, 10, job_id="j3")
    assert msg.startswith(C.QUOTA_EXCEEDED) and "'acme' row bucket" in msg
    assert p.admit_batch("other", 1, 4, 10) is None   # tenants are apart
    # a job that never ran gets its reserve back, a finished one its
    # token overage
    level = p.snapshot()["buckets"]["acme/p1"]["rows"]
    p.on_terminal(SimpleNamespace(job_id="j1", status="FAILED", input_tokens=0,
                                  output_tokens=0))
    assert p.snapshot()["buckets"]["acme/p1"]["rows"] == pytest.approx(min(4.0, level + 4),
                                                                       abs=0.5)
    assert p.snapshot()["rejections"] == 1


def test_the_engine_refuses_an_over_bucket_submit(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    eng = api.LocalEngine(EngineConfig(**ENGINE, control="rows=3,wait=0.2,window=600"),
                          device="cpu")
    srv, thread, url = start_server_thread(eng)
    body = {"model": "tiny-dense", "inputs": ["a", "b", "c"], "tenant": "acme",
            "sampling_params": {"temperature": 0.0, "max_new_tokens": 2}}
    try:
        ok = eng.submit_batch_inference(body)
        bad = eng.submit_batch_inference(body)
        rec = eng.get_job(bad)
        assert rec["status"] == "FAILED" and rec["failure_reason"]["code"] == "QUOTA_EXCEEDED"
        assert any(e["event"] == "admission_rejected" for e in rec["failure_log"])
        req = urllib.request.Request(f"{url}/batch-inference", method="POST",
                                     data=json.dumps(body).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        doc = json.loads(e.value.read())
        assert e.value.code == 429 and doc["error"]["code"] == "QUOTA_EXCEEDED"
        assert eng.get_job(doc["results"])["status"] == "FAILED"
        deadline = time.monotonic() + 60
        while eng.job_status(ok) != "SUCCEEDED":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert eng.control.snapshot()["rejections"] == 2
    finally:
        srv.shutdown()
        thread.join(timeout=30)
        assert eng.close(timeout=30)


# -- the autotuner ---------------------------------------------------------


def test_autotuner_audit_trail_equals_the_reference():
    rng = np.random.default_rng(5)
    planes = [mod.ControlPlane("sustain=2,cooldown=2,settle=3,slots_boost=3",
                               ecfg=_ecfg(kv_tier_host_pages=1024)) for mod in (C, JC)]
    names = ["interactive_starved", "decode_below_roofline", "host_bound_admit",
             "kv_pressure", "healthy"]
    for _ in range(200):
        verdict = names[int(rng.integers(0, len(names)))] if rng.random() < 0.6 else None
        firing = ["interactive_ttft_p99"] if rng.random() < 0.1 else []
        for p in planes:
            p.on_monitor_tick({}, [], {"j": {"verdict": verdict}} if verdict else {}, firing)
    trails = [[{k: v for k, v in a.items() if k != "unix"}
               for a in p.snapshot()["autotune"]["audit"]] for p in planes]
    assert trails[0] == trails[1] and len(trails[0]) >= 10
    assert planes[0].snapshot()["autotune"]["current"] == \
        planes[1].snapshot()["autotune"]["current"]


# -- degradation and the gateway ---------------------------------------------


def test_the_admit_fault_degrades_to_pass_through():
    p = C.ControlPlane("rows=1,tokens=1,wait=0,window=600", ecfg=_ecfg())
    assert p.admit_batch("t", 0, 1, 1.0) is None
    faults.configure("control.admit:error")
    assert p.admit_batch("t", 0, 50, 1e9) is None   # empty, but admitted
    assert not p.enabled and "control.admit" in p.degraded_reason
    faults.clear()
    assert p.admit_interactive("t") is None and not p.ladder.active()
    assert p.snapshot()["enabled"] is False


def test_the_gateway_answers_429_for_an_empty_bucket(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    eng = api.LocalEngine(EngineConfig(**ENGINE, interactive_slots=1,
                                       control="rows=1,itokens=8,window=600"), device="cpu")
    srv, thread, url = start_server_thread(eng)

    def chat(user):
        req = urllib.request.Request(
            f"{url}/v1/chat/completions", method="POST", data=json.dumps({
                "model": "tiny-dense", "user": user, "max_tokens": 2, "temperature": 0.0,
                "messages": [{"role": "user", "content": "hi"}]}).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        assert chat("acme")[0] == 200
        status, doc = chat("acme")
        assert status == 429 and "QUOTA_EXCEEDED" in doc["error"]["message"]
        assert chat("globex")[0] == 200   # another tenant's bucket
    finally:
        srv.shutdown()
        thread.join(timeout=30)
        assert eng.close(timeout=30)
