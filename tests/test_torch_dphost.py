"""The port's data-parallel engine ranks (``engine/dphost.py``) against
the JAX package's.

- An engine round: two port rank processes on the CPU (``SUTRO_DP_WORLD=2``,
  ``device="cpu"``) run a 24-row greedy ``tiny-dense`` job and a 24-row
  ``tiny-emb`` job from checkpoints written with the JAX package's
  ``init_params``. Rank 0's merged outputs must equal the JAX
  ``LocalEngine``'s single-host run of the same jobs token for token, in
  input order; the embeddings within ``EMB_ATOL``. Rank 0's telemetry
  document holds rank 1's section, the doctor gives a verdict over both
  processes, and the fleet view names both ranks.
- The channel scenarios of ``tests/test_dphost.py`` (stub shards, no
  engines), each run through both packages' dphost: the same outcome,
  the same merged row set.
- Cross-package rounds: the JAX package's worker with the port's
  coordinator and the reverse, fixed-world and elastic: the wire format
  is one.

The rank processes are this file run as a script (``_child``).
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
N_ROWS = 24
GEN_ROWS = [f"dp row {i} text" for i in range(N_ROWS)]
EMB_ROWS = [f"embed row {i}" for i in range(N_ROWS)]
GEN_SAMPLING = {"max_new_tokens": 6, "temperature": 0.0}
ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", activation_dtype="float32",
    prefix_store=False,
)
# f32 on both sides; a row's vector does not depend on its batch's
# composition (masked attention, pooled head), so the packages differ
# only by their op order
EMB_ATOL = 1e-5
EMB_RTOL = 1e-4
RANK_TIMEOUT_S = 300


def _child(weights_dir: str) -> None:
    """One port engine process: a dp rank when ``SUTRO_DP_WORLD`` is set.
    Runs the generation job, then the embedding job; rank 0 prints the
    merged results and the dp surfaces, one tagged JSON line each."""
    import torch

    from sutro_tpu_torch.engine.api import LocalEngine
    from sutro_tpu_torch.engine.config import EngineConfig

    torch.set_num_threads(1)
    rank = int(os.environ.get("SUTRO_DP_RANK", "0"))
    eng = LocalEngine(EngineConfig(weights_dir=weights_dir, **ENGINE), device="cpu")

    def emit(tag, obj):
        print(f"{tag} {json.dumps(obj)}", flush=True)

    def await_done(jid):
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while time.monotonic() < deadline:
            if eng.job_status(jid) in ("SUCCEEDED", "FAILED", "CANCELLED"):
                break
            time.sleep(0.05)
        status = eng.job_status(jid)
        if status != "SUCCEEDED":
            raise SystemExit(f"rank {rank}: job {jid} {status}: {eng.get_job(jid)}")

    jid = eng.submit_batch_inference(
        {"model": "tiny-dense", "inputs": GEN_ROWS, "sampling_params": GEN_SAMPLING}
    )
    await_done(jid)
    ejid = eng.submit_batch_inference({"model": "tiny-emb", "inputs": EMB_ROWS})
    await_done(ejid)
    if rank == 0:
        emit("RESULTS", eng.job_results(jid)["outputs"])
        emit("EMB", eng.job_results(ejid)["outputs"])
        if os.environ.get("SUTRO_DP_WORLD"):
            doc = eng.job_telemetry(jid, write=False)
            emit("TELEDOC", {
                "workers": [
                    {"rank": w.get("rank"), "round": w.get("round"),
                     "trace": w.get("trace"),
                     "stages": sorted({s["name"] for s in w.get("spans", [])}),
                     "counters": w.get("counters")}
                    for w in doc.get("workers", [])
                ],
                "stages": doc.get("stages"),
            })
            emit("DOCTOR", eng.diagnose_job(jid))
            emit("FLEET", eng.job_fleet(jid))
            emit("EFLEET", eng.job_fleet(ejid))
    eng.close(timeout=30)
    print(f"DP_OK rank={rank}", flush=True)


def _spawn(tmp_path, name, weights_dir, extra_env):
    env = dict(os.environ)
    home = tmp_path / name
    home.mkdir()
    env.update(
        SUTRO_HOME=str(home), SUTRO_MONITOR="0",
        PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
    )
    for k in [k for k in env if k.startswith("SUTRO_DP_")]:
        env.pop(k)
    env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, __file__, str(weights_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )


def _line(out: str, tag: str):
    for line in out.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise AssertionError(f"no {tag} line:\n{out}")


def _jax_single_host(tmp_path, weights_dir, monkeypatch):
    """The JAX ``LocalEngine``'s single-host run of both jobs."""
    from sutro_tpu.engine import api as jax_api
    from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "jax-home"))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    for k in [k for k in os.environ if k.startswith("SUTRO_DP_")]:
        monkeypatch.delenv(k)
    eng = jax_api.LocalEngine(
        JaxEngineConfig(use_pallas=False, weights_dir=str(weights_dir), **ENGINE)
    )
    try:
        out = {}
        for key, payload in (
            ("gen", {"model": "tiny-dense", "inputs": GEN_ROWS,
                     "sampling_params": GEN_SAMPLING}),
            ("emb", {"model": "tiny-emb", "inputs": EMB_ROWS}),
        ):
            jid = eng.submit_batch_inference(payload)
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while eng.job_status(jid) not in ("SUCCEEDED", "FAILED", "CANCELLED"):
                assert time.monotonic() < deadline, eng.job_status(jid)
                time.sleep(0.05)
            assert eng.job_status(jid) == "SUCCEEDED", eng.get_job(jid)
            out[key] = eng.job_results(jid)["outputs"]
        return out
    finally:
        eng.close(timeout=30)


def test_dp_ranks_match_jax_single_host(tmp_path, monkeypatch):
    from sutro_tpu.models.configs import MODEL_CONFIGS
    from tests.conftest import free_low_port
    from tests.test_torch_weights_loader import write_hf_checkpoint

    weights = tmp_path / "weights"
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 7, weights / "tiny-dense")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-emb"], 11, weights / "tiny-emb")
    coord = f"127.0.0.1:{free_low_port()}"
    procs = {
        f"rank{r}": _spawn(
            tmp_path, f"rank{r}", weights,
            {"SUTRO_DP_WORLD": "2", "SUTRO_DP_RANK": str(r), "SUTRO_DP_COORD": coord},
        )
        for r in (0, 1)
    }
    outs = {}
    try:
        ref = _jax_single_host(tmp_path, weights, monkeypatch)
        for name, p in procs.items():
            outs[name], _ = p.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    logs = "\n".join(
        f"--- {n} (rc={p.returncode}) ---\n{outs.get(n, '<no output>')}"
        for n, p in procs.items()
    )
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed\n{logs}"
    assert "DP_OK rank=1" in outs["rank1"], logs
    r0 = outs["rank0"]

    # the dp path changes where rows run, never what they produce: the
    # same strings in the same order as the JAX engine's single host
    assert _line(r0, "RESULTS") == ref["gen"]
    dp_emb = np.array(_line(r0, "EMB"))
    assert dp_emb.shape == np.array(ref["emb"]).shape == (N_ROWS, dp_emb.shape[1])
    np.testing.assert_allclose(dp_emb, np.array(ref["emb"]), rtol=EMB_RTOL, atol=EMB_ATOL)

    # rank 1's telemetry shard crossed the wire into rank 0's document
    teledoc = _line(r0, "TELEDOC")
    (w1,) = teledoc["workers"]
    assert w1["rank"] == 1 and w1["round"] == 1 and w1["trace"].endswith("/r1")
    assert w1["counters"].get("rows_ok") == N_ROWS // 2
    assert {"tokenize", "prefill", "decode_window", "dp_round"} <= set(w1["stages"])
    assert "dp_round" in teledoc["stages"]
    doctor = _line(r0, "DOCTOR")
    assert doctor["verdict"] != "insufficient_data"
    assert doctor["partial"] is False and doctor["world"] == 2
    assert set(doctor["processes"]) == {"rank0", "rank1"}
    assert doctor["processes"]["rank1"]["stages"]["decode_window"]["count"] > 0

    # the fleet view after the round: both ranks, every row done once
    for tag in ("FLEET", "EFLEET"):
        fleet = _line(r0, tag)
        assert fleet["elastic"] is True, fleet
        assert set(fleet["ranks"]) == {"0", "1"}, fleet
        assert fleet["rows"]["done"] == N_ROWS and fleet["rows"]["pending"] == 0
        assert fleet["counters"]["duplicate_results_dropped"] == 0


# ---------------------------------------------------------------------------
# channel-level scenarios (stub shards, no engines), through both packages
# ---------------------------------------------------------------------------

PACKAGES = ("sutro_tpu", "sutro_tpu_torch")


class Pkg:
    """One package's dp pieces, imported by name (the JAX package's
    ``scheduler`` imports JAX, so nothing here is imported before a
    test runs)."""

    def __init__(self, root: str):
        self.root = root
        self.dphost = importlib.import_module(f"{root}.engine.dphost")
        self.faults = importlib.import_module(f"{root}.engine.faults")
        self.telemetry = importlib.import_module(f"{root}.telemetry")
        sched = importlib.import_module(f"{root}.engine.scheduler")
        self.GenRequest, self.GenResult = sched.GenRequest, sched.GenResult

    def worlds(self, port, world=2):
        return [
            self.dphost.DPWorld(rank=r, world=world, host="127.0.0.1", port=port)
            for r in range(world)
        ]

    def reqs(self, n, prompt=(0,)):
        return [
            self.GenRequest(
                row_id=i, prompt_ids=np.array(prompt, np.int32), max_new_tokens=1
            )
            for i in range(n)
        ]

    def res(self, row_id, token_ids=(7,)):
        return self.GenResult(
            row_id=row_id, token_ids=list(token_ids), cumulative_logprob=-0.5,
            finish_reason="stop", input_tokens=1,
        )


def both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` through the JAX package's dphost and
    then the port's; their summaries must be equal. Returns the port's."""
    from tests.conftest import free_low_port

    got = {}
    for root in PACKAGES:
        got[root] = scenario(Pkg(root), free_low_port(), *args, **kw)
    assert got["sutro_tpu_torch"] == got["sutro_tpu"], got
    return got["sutro_tpu_torch"]


def _connect(port, timeout=120):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=15.0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _resume_filter_and_merge(P, port):
    cw, ww = P.worlds(port)
    reqs = P.reqs(8)
    worker_ran = []

    def coord_shard(shard, on_result, on_progress, should_cancel):
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    def worker_shard(shard, on_result, on_progress, should_cancel):
        worker_ran.extend(q.row_id for q in shard)
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    t = threading.Thread(
        target=P.dphost.run_dp_worker,
        args=(ww, worker_shard, P.dphost.shard_requests(reqs, 1, 2)),
    )
    t.start()
    merged = {}
    outcome = P.dphost.run_dp_coordinator(
        cw, coord_shard, P.dphost.shard_requests(reqs, 0, 2),
        on_result=lambda r: merged.__setitem__(r.row_id, r),
        done_rows={1, 3},  # worker rows already in the partial store
    )
    t.join(timeout=120)
    assert not t.is_alive()
    return {
        "outcome": outcome, "worker_ran": worker_ran, "merged": sorted(merged),
        "finish": merged[5].finish_reason,
    }


def test_channel_resume_filter_and_merge():
    """The coordinator ships its done-row set on hello; the worker
    filters its shard so already-merged rows are not regenerated."""
    got = both(_resume_filter_and_merge)
    assert got == {
        "outcome": "completed", "worker_ran": [5, 7],
        "merged": [0, 2, 4, 5, 6, 7], "finish": "stop",
    }


def _worker_failure(P, port):
    cw, ww = P.worlds(port)
    reqs = P.reqs(4)

    def coord_shard(shard, on_result, on_progress, should_cancel):
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    def worker_shard(shard, on_result, on_progress, should_cancel):
        raise RuntimeError("rank OOM")

    def worker_main():
        with pytest.raises(RuntimeError):  # the worker re-raises locally too
            P.dphost.run_dp_worker(ww, worker_shard, P.dphost.shard_requests(reqs, 1, 2))

    t = threading.Thread(target=worker_main)
    t.start()
    with pytest.raises(RuntimeError, match="rank OOM") as err:
        P.dphost.run_dp_coordinator(
            cw, coord_shard, P.dphost.shard_requests(reqs, 0, 2),
            on_result=lambda r: None,
        )
    t.join(timeout=120)
    assert not t.is_alive()
    return {"error": str(err.value)}


def test_channel_worker_failure_fails_job():
    """A worker error must surface on the coordinator instead of
    finalizing with silently-missing rows."""
    both(_worker_failure)


def _retry_replaces_connection(P, port):
    cw, ww = P.worlds(port)
    reqs = P.reqs(4)
    merged, outcome = {}, {}

    def coord_main():
        outcome["coord"] = P.dphost.run_dp_coordinator(
            cw,
            lambda shard, on_result, on_progress, should_cancel: (
                [on_result(P.res(q.row_id)) for q in shard], "completed",
            )[1],
            P.dphost.shard_requests(reqs, 0, 2),
            on_result=lambda r: merged.__setitem__(r.row_id, r),
        )

    ct = threading.Thread(target=coord_main)
    ct.start()
    # abandoned first connection: the handshake completes, then the
    # socket goes quiet (still open — the retry must supersede it)
    stale = _connect(port)
    P.dphost._send(stale, {"t": "hello", "rank": 1, "job": ""})
    first = next(P.dphost._recv_lines(stale), None)
    assert first and first.get("t") == "resume"

    def worker_shard(shard, on_result, on_progress, should_cancel):
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    outcome["worker"] = P.dphost.run_dp_worker(
        ww, worker_shard, P.dphost.shard_requests(reqs, 1, 2)
    )
    ct.join(timeout=120)
    assert not ct.is_alive()
    stale.close()
    return {"outcome": outcome, "merged": sorted(merged)}


def test_channel_worker_retry_replaces_connection():
    """A worker reconnecting with the same rank replaces its abandoned
    first connection, whose EOF does not fail the job."""
    got = both(_retry_replaces_connection)
    assert got == {
        "outcome": {"coord": "completed", "worker": "completed"},
        "merged": [0, 1, 2, 3],
    }


def _stalled_worker(P, port, monkeypatch):
    monkeypatch.setenv("SUTRO_DP_STALL_TIMEOUT", "1")
    cw, _ = P.worlds(port)
    reqs = P.reqs(4)

    def hung_worker():
        sock = _connect(port)
        P.dphost._send(sock, {"t": "hello", "rank": 1, "job": ""})
        next(P.dphost._recv_lines(sock), None)  # resume reply
        time.sleep(30)  # never send done (a hung rank)
        sock.close()

    threading.Thread(target=hung_worker, daemon=True).start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stalled"):
        P.dphost.run_dp_coordinator(
            cw,
            lambda shard, on_result, on_progress, should_cancel: "completed",
            P.dphost.shard_requests(reqs, 0, 2),
            on_result=lambda r: None,
        )
    # detected through the stall timeout (seconds), not the accept path
    return {"fast": time.monotonic() - t0 < 30}


def test_channel_stalled_worker_fails_resumably(monkeypatch):
    """An open connection that never sends done fails the job with a
    stall error after SUTRO_DP_STALL_TIMEOUT, not the accept timeout."""
    assert both(_stalled_worker, monkeypatch) == {"fast": True}


def _resume_round(P, port, monkeypatch):
    monkeypatch.setenv("SUTRO_DP_RESUME_GRACE", "10")
    cw, ww = P.worlds(port)
    reqs = P.reqs(4)
    worker_ran, outcome = [], {}

    def worker_shard(shard, on_result, on_progress, should_cancel):
        worker_ran.extend(q.row_id for q in shard)
        for q in shard:
            on_result(P.res(q.row_id))
        return "completed"

    def worker_main():
        outcome["v"] = P.dphost.run_dp_worker(
            ww, worker_shard, P.dphost.shard_requests(reqs, 1, 2)
        )

    t = threading.Thread(target=worker_main)
    t.start()
    served = P.dphost.serve_resume_round(cw, job_key="", done_rows={0, 1, 2, 3})
    t.join(timeout=120)
    assert not t.is_alive()
    return {"served": served, "worker": outcome["v"], "worker_ran": worker_ran}


def test_serve_resume_round_completes_requeued_workers(monkeypatch):
    """Resume of a fully-merged job: the coordinator serves a trivial
    round, so re-queued workers finish as completed no-ops."""
    got = both(_resume_round, monkeypatch)
    assert got == {"served": True, "worker": "completed", "worker_ran": []}


def _cancel_propagates(P, port):
    cw, ww = P.worlds(port)
    reqs = P.reqs(4)
    cancel_at = {"t": None}
    worker_outcome = {}

    def coord_shard(shard, on_result, on_progress, should_cancel):
        for q in shard:
            on_result(P.res(q.row_id))
        cancel_at["t"] = time.monotonic()
        return "completed"  # local shard done; cancel fires while waiting

    def worker_shard(shard, on_result, on_progress, should_cancel):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if should_cancel():
                return "cancelled"
            time.sleep(0.05)
        return "completed"  # would time the test out

    def worker_main():
        worker_outcome["v"] = P.dphost.run_dp_worker(
            ww, worker_shard, P.dphost.shard_requests(reqs, 1, 2)
        )

    t = threading.Thread(target=worker_main)
    t.start()
    outcome = P.dphost.run_dp_coordinator(
        cw, coord_shard, P.dphost.shard_requests(reqs, 0, 2),
        on_result=lambda r: None,
        should_cancel=lambda: cancel_at["t"] is not None,
    )
    t.join(timeout=180)
    assert not t.is_alive()
    return {"coord": outcome, "worker": worker_outcome["v"]}


def test_channel_cancel_propagates_to_worker():
    """Coordinator-side cancellation reaches a running worker shard
    through the channel; both sides settle on 'cancelled'."""
    assert both(_cancel_propagates) == {"coord": "cancelled", "worker": "cancelled"}


# ---------------------------------------------------------------------------
# cross-package rounds: one package's worker, the other's coordinator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elastic", [False, True], ids=["fixed", "elastic"])
@pytest.mark.parametrize(
    "coord_pkg,worker_pkg",
    [("sutro_tpu_torch", "sutro_tpu"), ("sutro_tpu", "sutro_tpu_torch")],
    ids=["port-coord", "jax-coord"],
)
def test_cross_package_round(coord_pkg, worker_pkg, elastic, monkeypatch):
    """A round between the two packages completes: the JAX package's
    worker with the port's coordinator and the reverse, a fixed-world
    round and an elastic one (assignment in the handshake, the worker
    parked idle, then ``nomore``). Each row merges once, its tokens and
    finish reason intact, with the worker's telemetry shard ingested."""
    from tests.conftest import free_low_port

    C, W = Pkg(coord_pkg), Pkg(worker_pkg)
    for P in (C, W):  # a refused handshake fails in bounded time
        monkeypatch.setattr(P.dphost, "_ACCEPT_TIMEOUT_S", 60.0)
    port = free_low_port()
    cw = C.dphost.DPWorld(rank=0, world=2, host="127.0.0.1", port=port)
    ww = W.dphost.DPWorld(rank=1, world=2, host="127.0.0.1", port=port)
    n = 32
    creqs, wreqs = C.reqs(n), W.reqs(n)
    worker_ran, merged, shards, out = [], {}, [], {}

    def shard_fn(P, ran=None):
        def fn(shard, on_result, on_progress, should_cancel):
            for q in shard:
                if ran is not None:
                    ran.append(q.row_id)
                on_result(P.res(q.row_id, token_ids=(q.row_id % 11, 7)))
            return "completed"
        return fn

    W.telemetry.set_enabled(True)
    C.telemetry.set_enabled(True)
    pool = wreqs if elastic else W.dphost.shard_requests(wreqs, 1, 2)

    def worker_main():
        out["worker"] = W.dphost.run_dp_worker(
            ww, shard_fn(W, worker_ran), pool, job_key="k", elastic=elastic,
            tele=W.telemetry.distributed.WorkerTelemetry("xjob", 1),
        )

    t = threading.Thread(target=worker_main)
    t.start()
    job_id = f"xjob-{coord_pkg}-{elastic}"
    kw = dict(requests=creqs, job_id=job_id) if elastic else {}
    outcome = C.dphost.run_dp_coordinator(
        cw, shard_fn(C), C.dphost.shard_requests(creqs, 0, 2),
        on_result=lambda r: merged.setdefault(r.row_id, []).append(
            (list(r.token_ids), r.finish_reason)
        ),
        job_key="k", tele_ctx=C.telemetry.distributed.trace_context(job_id, 1),
        on_worker_tele=lambda rank, shard: shards.append((rank, shard)),
        **kw,
    )
    t.join(timeout=120)
    assert not t.is_alive()
    assert outcome == "completed" and out["worker"] == "completed"
    assert merged == {i: [([i % 11, 7], "stop")] for i in range(n)}
    assert sorted(worker_ran) == [i for i in range(n) if i % 2 == 1]
    ((rank, shard),) = shards
    assert rank == 1 and shard["trace"] == f"{job_id}/r1"
    assert shard["v"] == C.telemetry.distributed.WIRE_VERSION
    if elastic:
        snap = C.dphost.fleet_view(job_id)
        assert snap["rows"]["done"] == n and snap["ranks"]["1"]["elastic"] is True


def test_cross_package_job_key_refused(monkeypatch):
    """The port's coordinator refuses a JAX worker whose job key differs
    (another job's rows must never merge into this one): the worker runs
    nothing, and the round fails once the accept window closes."""
    from tests.conftest import free_low_port

    C, W = Pkg("sutro_tpu_torch"), Pkg("sutro_tpu")
    for P in (C, W):
        monkeypatch.setattr(P.dphost, "_ACCEPT_TIMEOUT_S", 3.0)
    port = free_low_port()
    cw = C.dphost.DPWorld(rank=0, world=2, host="127.0.0.1", port=port)
    ww = W.dphost.DPWorld(rank=1, world=2, host="127.0.0.1", port=port)
    ran, out = [], {}

    def worker_main():
        try:
            out["worker"] = W.dphost.run_dp_worker(
                ww, lambda shard, on_result, on_progress, should_cancel: (
                    ran.extend(q.row_id for q in shard), "completed")[1],
                W.dphost.shard_requests(W.reqs(8), 1, 2), job_key="other",
            )
        except RuntimeError as e:
            out["worker"] = f"raised: {e}"

    t = threading.Thread(target=worker_main, daemon=True)
    t.start()
    with pytest.raises(RuntimeError):
        C.dphost.run_dp_coordinator(
            cw, lambda shard, on_result, on_progress, should_cancel: "completed",
            C.dphost.shard_requests(C.reqs(8), 0, 2), on_result=lambda r: None,
            job_key="mine",
        )
    t.join(timeout=60)
    assert not t.is_alive()
    assert ran == [] and out["worker"].startswith("raised:"), out



# ---------------------------------------------------------------------------
# chip_smoke.py's serve 10 at a tiny size
# ---------------------------------------------------------------------------


def test_smoke_serve10_runs_at_a_tiny_size(tmp_path, monkeypatch):
    """``chip_smoke.py``'s serve 10 end to end on the CPU at a tiny size:
    two tiny-dense / tiny-emb rank processes from bfloat16 checkpoints
    (rank 1's decode slowed by a ``runner.decode`` hang of 0.5 s, so that
    its kill lands mid-job), 8-row G, 16-row E, a 24-row K killed after 2
    of rank 1's rows: every check it makes on the card passes here with
    the plain versions, and the float32 single-host run equals the
    ranks' merged rows."""
    import torch

    import chip_smoke
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS as PORT_CONFIGS

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    mcfg = PORT_CONFIGS["tiny-dense"]
    geometry = dict(kv_page_size=8, max_pages_per_seq=64, decode_batch_size=4,
                    max_model_len=512, decode_multi_step=4, param_dtype="float32",
                    activation_dtype="float32")
    runner = ModelRunner(mcfg, EngineConfig(**{**geometry, "param_dtype": "bfloat16"}),
                         device="cpu")
    chip_smoke.write_checkpoint(torch, runner.params, mcfg, tmp_path / "ckpt" / mcfg.name)
    one_thread = {"OMP_NUM_THREADS": "1"}
    out = chip_smoke.serve_dp(
        torch, [], [], "cpu", tmp_path / "ckpt", model="tiny-dense", embed_model="tiny-emb",
        device="cpu", geometry=geometry, ref_geometry=geometry, n_gen=8, n_kill=24,
        n_emb=16, n_new=8, kill_after=2, system_chars=40, timeout=RANK_TIMEOUT_S,
        rank_env={0: one_thread,
                  1: {**one_thread, "SUTRO_FAULT_PLAN": "runner.decode:hang:delay=0.5"}})
    assert out["k"]["rank1_state"] == "lost" and out["k"]["counters"]["requeued_rows"] >= 1
    assert sum(out["k"]["rank_rows"]) == 24 and out["k"]["rank_rows"][1] >= 2
    assert out["g"]["fleet_ranks"] == ["0", "1"] and out["g"]["rank_rows"][1] > 0
    # the CPU's float32 arithmetic does not depend on the batch's rows
    sh = out["single_host"]
    assert sh["g_token_equal"] == 8 and sh["k_token_equal"] == 24
    assert sh["e_max_abs_diff"] < 1e-4 and sh["e_min_cosine"] > 0.9999
    summary = chip_smoke.dp_summary(out)
    assert summary["rows_lost"] == summary["rows_duplicated"] == 0


if __name__ == "__main__":
    _child(sys.argv[1])
