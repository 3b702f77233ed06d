"""The port's engine on a device mesh against the JAX single-device
engine (CPU ranks, gloo).

The same float32 parameters (JAX ``init_params`` -> numpy ->
``params_from_numpy``) go into the JAX engine (plain path) and into a
port ``ModelRunner`` whose mesh spans ``device=["cpu"] * W`` (it starts
its worker ranks itself), and the same requests through
``ContinuousBatcher``: greedy token ids and finish reasons must be
identical, on ``tiny-dense``, ``tiny-moe`` and ``tiny-oss``, under

- tp=2 with templated split decode (a shared 19-token prefix: suffix
  prefill over the pages and the prefix carry);
- (ep=2, tp=2), also with the shared prefix;
- sp=2 (ring prefill) and pp=2 (GPipe prefill, stage-by-stage decode);
- int8 KV pages at tp=2 (the per-token scales MAX-reduced over
  ``model``);
- dp=2 and (dp=2, ep=2): weights and pool replicated over ``data``, the
  MoE tokens split over it when the batch divides.

Every rank's sampled tokens must agree in every call. Also: a
``LocalEngine`` job at tp=2 (each rank loading its block of an HF
checkpoint) gives the single-device engine's outputs, the KV tier's
page copies round-trip through a tp=2 x pp=2 pool, and a killed worker
makes rank 0 raise ``RankFailure`` within its timeout instead of
hanging.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.parallel.ranks import RankFailure
from tests import mesh_ranks
from tests.test_torch_weights_loader import write_hf_checkpoint

torch.set_num_threads(1)   # every rank inherits it (parallel/ranks.py)

ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", decode_multi_step=4,
    prefill_chunk=16,
)
MESHES = {
    "tp2_split": (dict(tp=2, prefix_split=True), 19),
    "ep2_tp2": (dict(ep=2, tp=2, prefix_split=True), 19),
    "sp2": (dict(sp=2), 0),
    "pp2": (dict(pp=2), 0),
    "int8kv_tp2": (dict(tp=2, kv_quantize="int8"), 0),
    "dp2": (dict(dp=2), 0),
    "dp2_ep2": (dict(dp=2, ep=2, tp=1), 0),
}
_JAX = {}


@pytest.fixture(autouse=True)
def _mesh_timeout(monkeypatch):
    monkeypatch.setenv("SUTRO_MESH_TIMEOUT", "60")


def _params(model):
    cfg = MODEL_CONFIGS[model]
    params = jax_transformer.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    return params, params_from_numpy(cfg, tree, "cpu", torch.float32)


def _prompts(shared: int):
    rng = np.random.default_rng(0)
    head = rng.integers(3, 500, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(3, 500, n).astype(np.int32)])
            for n in (5, 9, 40, 13, 2, 27, 1)]


def _run(sched_mod, runner, shared):
    res = {}
    b = sched_mod.ContinuousBatcher(runner, stop_ids=[1])
    reqs = [sched_mod.GenRequest(row_id=i, prompt_ids=p, max_new_tokens=10 + i,
                                 temperature=0.0)
            for i, p in enumerate(_prompts(shared))]
    assert b.run(reqs, on_result=lambda r: res.__setitem__(r.row_id, r)) == "completed"
    return res


def _jax_results(model, jparams, shared, kv_quantize, prefix_split):
    key = (model, shared, kv_quantize, prefix_split)
    if key not in _JAX:
        jr = jax_runner.ModelRunner(
            MODEL_CONFIGS[model],
            JaxEngineConfig(use_pallas=False, kv_quantize=kv_quantize,
                            prefix_split=prefix_split, **ENGINE),
            jparams,
        )
        _JAX[key] = _run(jax_sched, jr, shared)
    return _JAX[key]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["tiny-dense", "tiny-moe", "tiny-oss"])
def test_greedy_on_a_mesh_matches_the_jax_engine(model, mesh):
    axes, shared = MESHES[mesh]
    jparams, tparams = _params(model)
    want = _jax_results(model, jparams, shared, axes.get("kv_quantize"),
                        axes.get("prefix_split", False))
    world = int(np.prod([axes.get(a, 1) for a in ("dp", "tp", "ep", "sp", "pp")]))
    runner = t_runner.ModelRunner(
        MODEL_CONFIGS[model], EngineConfig(**ENGINE, **axes), tparams,
        device=["cpu"] * world,
    )
    try:
        assert runner.mesh.size == world and runner.sp == axes.get("sp", 1)
        got = _run(t_sched, runner, shared)
        report = runner.mesh_report()
        resident = runner.on_ranks(mesh_ranks.resident_shapes)
    finally:
        runner.close()
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].token_ids == want[i].token_ids, (mesh, i)
        assert got[i].finish_reason == want[i].finish_reason, (mesh, i)
    assert len(report) == world
    assert all(r["token_checks"] > 0 and r["token_mismatches"] == 0 for r in report)
    assert all(r["collectives"] > 0 for r in report)
    cfg = MODEL_CONFIGS[model]
    tp, ep = axes.get("tp", 1), axes.get("ep", 1)
    for r in resident:   # data ranks hold the same blocks and the whole pool
        assert r["pool"][-1] == cfg.num_kv_heads // tp * cfg.head_dim
        if cfg.moe_experts:
            E, F = cfg.moe_experts, cfg.moe_intermediate_size
            assert r["we_gate"][1] * r["we_gate"][-1] * ep * tp == E * F, (mesh, r)


def test_data_ranks_hold_the_expert_blocks_and_the_whole_pool():
    """At (dp, ep, tp) = (2, 2, 2) each of the 8 ranks holds 1/(ep*tp) of
    every expert weight, the replicated rest whole, and the pool at
    ``KVH/tp*Dh``; the two data ranks of a block hold the same bits."""
    cfg = MODEL_CONFIGS["tiny-moe"]
    _, tparams = _params("tiny-moe")
    runner = t_runner.ModelRunner(
        cfg, EngineConfig(**ENGINE, dp=2, ep=2, tp=2), tparams, device=["cpu"] * 8,
    )
    try:
        got = runner.on_ranks(mesh_ranks.resident_shapes)
        sums = runner.on_ranks(mesh_ranks.resident_sums)
        coords = [runner.mesh.coords(r) for r in range(8)]
    finally:
        runner.close()
    L, E, H = cfg.num_layers, cfg.moe_experts, cfg.hidden_size
    F = cfg.moe_intermediate_size
    pages = 1 + ENGINE["decode_batch_size"] * ENGINE["max_pages_per_seq"]
    for r in got:
        assert r["we_gate"] == (L, E // 2, H, F // 2)
        assert r["we_down"] == (L, E // 2, F // 2, H)
        assert r["router"] == (L, H, E) and r["embed"] == (cfg.vocab_size, H)
        assert r["pool"] == (L, pages, ENGINE["kv_page_size"],
                             cfg.num_kv_heads // 2 * cfg.head_dim)
    for r, c in enumerate(coords):
        twin = [q for q, d in enumerate(coords)
                if d["data"] != c["data"] and (d["expert"], d["model"]) == (c["expert"], c["model"])]
        assert len(twin) == 1 and sums[twin[0]] == sums[r]
    assert len({s["we_gate"] for s in sums}) == 4


def test_per_chip_rates_count_the_mesh_ranks(tmp_path, monkeypatch):
    """A job on a tp=2 mesh reports ``tokens_per_second_per_chip`` as its
    total rate over the mesh's 2 ranks (the reference divides by
    ``jax.device_count()``, its mesh's devices)."""
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 8, tmp_path / "weights" / "tiny-dense")
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    cfg = dict(ENGINE, weights_dir=str(tmp_path / "weights"), prefix_store=False, tp=2)
    eng = api.LocalEngine(EngineConfig(**cfg), device=["cpu", "cpu"])
    try:
        jid = eng.submit_batch_inference(
            {"model": "tiny-dense", "inputs": ["hello", "a row", "x"],
             "sampling_params": {"temperature": 0.0, "max_new_tokens": 12}})
        deadline = time.monotonic() + 120
        while eng.job_status(jid) not in ("SUCCEEDED", "FAILED", "CANCELLED"):
            assert time.monotonic() < deadline, eng.job_status(jid)
            time.sleep(0.02)
        assert eng.job_status(jid) == "SUCCEEDED", eng.get_job(jid)
        m = dict(eng.metrics.job(jid).latest_tokens)
    finally:
        assert eng.close(timeout=30)
    assert m["total_tokens_processed_per_second"] > 0
    assert m["tokens_per_second_per_chip"] == pytest.approx(
        m["total_tokens_processed_per_second"] / 2)


def test_a_local_engine_job_at_tp2(tmp_path, monkeypatch):
    """A job through the job API on a tp=2 mesh, each rank reading its
    block of the checkpoint, gives the single-device engine's outputs."""
    write_hf_checkpoint(MODEL_CONFIGS["tiny-moe"], 8, tmp_path / "weights" / "tiny-moe")
    monkeypatch.setenv("SUTRO_MONITOR", "0")
    rows = ["hello there", "a much longer row of text for the engine", "x", "fourth row!"]
    payload = {"model": "tiny-moe", "inputs": rows,
               "sampling_params": {"temperature": 0.0, "max_new_tokens": 12}}
    cfg = dict(ENGINE, weights_dir=str(tmp_path / "weights"), prefix_store=False,
               activation_dtype="float32")
    outs = []
    for name, axes, device in (("one", {}, "cpu"), ("tp2", {"tp": 2}, ["cpu", "cpu"])):
        monkeypatch.setenv("SUTRO_HOME", str(tmp_path / name))
        eng = api.LocalEngine(EngineConfig(**cfg, **axes), device=device)
        try:
            jid = eng.submit_batch_inference(dict(payload))
            deadline = time.monotonic() + 120
            while eng.job_status(jid) not in ("SUCCEEDED", "FAILED", "CANCELLED"):
                assert time.monotonic() < deadline, eng.job_status(jid)
                time.sleep(0.02)
            assert eng.job_status(jid) == "SUCCEEDED", eng.get_job(jid)
            outs.append(eng.job_results(jid)["outputs"])
            if axes:
                runner = eng._runner_cache["tiny-moe"][0]
                assert runner.mesh.size == 2
                assert runner.params["layers"]["we_gate"].shape[-1] == (
                    MODEL_CONFIGS["tiny-moe"].moe_intermediate_size // 2)
        finally:
            assert eng.close(timeout=30)
    assert outs[0] == outs[1]


def test_tier_pages_round_trip_on_a_tp_pp_mesh():
    """``read_pages`` gathers every rank's block into full rows of every
    layer; ``write_pages`` scatters them back."""
    _, tparams = _params("tiny-dense")
    runner = t_runner.ModelRunner(
        MODEL_CONFIGS["tiny-dense"], EngineConfig(**ENGINE, tp=2, pp=2), tparams,
        device=["cpu"] * 4,
    )
    try:
        cfg = MODEL_CONFIGS["tiny-dense"]
        assert runner.cache.k_pages.shape[0] == cfg.num_layers // 2
        runner.prefill(_prompts(0)[2][:20], np.array([1, 2, 3] + [0] * 13, np.int32))
        got = runner.read_pages([1, 2, 3])
        assert got["k"].shape == (cfg.num_layers, 3, 8, cfg.num_kv_heads * cfg.head_dim)
        runner.write_pages([5, 6, 7], got)
        again = runner.read_pages([5, 6, 7])
        np.testing.assert_array_equal(again["k"], got["k"])
        np.testing.assert_array_equal(again["v"], got["v"])
        assert np.abs(got["k"]).sum() > 0
    finally:
        runner.close()


def test_refusals_faults_and_alike_errors_leave_the_mesh_up():
    """On a pp=2 mesh: a suffix prefill and a verify (refused under pp)
    and an injected fault raise on rank 0 before the call is sent; an
    error every rank's body raises alike (a window handle no rank holds,
    an ``on_ranks`` body) is re-raised. None of them takes the mesh down:
    the same prefill gives the same logits afterwards and a window
    decodes and commits. Ranks that raise different errors are a rank
    failure."""
    from sutro_tpu_torch.engine import faults

    _, tparams = _params("tiny-dense")
    runner = t_runner.ModelRunner(
        MODEL_CONFIGS["tiny-dense"], EngineConfig(**ENGINE, pp=2), tparams,
        device=["cpu", "cpu"],
    )
    try:
        table = np.array([1, 2, 3] + [0] * 13, np.int32)
        prompt = _prompts(0)[2][:20]
        want = runner.prefill(prompt, table)
        with pytest.raises(ValueError, match="suffix"):
            runner.prefill(prompt[5:], table, start=5)
        with pytest.raises(NotImplementedError, match="under pp"):
            runner.verify_greedy(np.ones(1, np.int32), np.ones((1, 2), np.int32),
                                 np.array([2], np.int32), np.array([20], np.int32), table[None])
        args = (np.ones(1, np.int32), np.array([20], np.int32), table[None], 0,
                np.zeros(1, np.float32), np.ones(1, np.float32), 2)
        faults.install(faults.parse_plan("runner.decode:error:times=1"))
        try:
            with pytest.raises(faults.InjectedFault):
                runner.decode_multi(*args)
        finally:
            faults.clear()
        with pytest.raises(KeyError):
            runner.commit_window(t_runner.WindowHandle(12345), np.zeros(1, np.int32))
        with pytest.raises(ValueError, match="alike"):
            runner.on_ranks(mesh_ranks.raise_alike)
        assert runner._pool.ranks.broken is None
        np.testing.assert_array_equal(runner.prefill(prompt, table), want)
        toks, _, handle = runner.decode_window(*args)
        assert isinstance(handle, t_runner.WindowHandle) and toks.shape == (2, 1)
        runner.commit_window(handle, np.array([2], np.int32))
        assert all(r["token_mismatches"] == 0 for r in runner.mesh_report())
        t0 = time.monotonic()
        with pytest.raises(RankFailure, match="refuses"):
            runner.on_ranks(mesh_ranks.raise_naming_the_rank)
        assert time.monotonic() - t0 < 30
        with pytest.raises(RankFailure, match="down"):
            runner.prefill(prompt, table)
    finally:
        runner.close()


def test_a_killed_worker_makes_rank0_raise():
    _, tparams = _params("tiny-dense")
    runner = t_runner.ModelRunner(
        MODEL_CONFIGS["tiny-dense"], EngineConfig(**ENGINE, tp=2), tparams,
        device=["cpu", "cpu"],
    )
    try:
        table = np.array([1, 2] + [0] * 14, np.int32)
        runner.prefill(_prompts(0)[0], table)
        runner._pool.ranks.procs[0].kill()
        t0 = time.monotonic()
        with pytest.raises(RankFailure, match="rank 1"):
            runner.prefill(_prompts(0)[0], table)
        assert time.monotonic() - t0 < 30
        with pytest.raises(RankFailure, match="down"):
            runner.decode_step(np.ones(1, np.int32), np.array([5], np.int32), table[None],
                               0, np.zeros(1), np.ones(1))
    finally:
        runner.close()


def test_smoke_serve11_runs_at_a_tiny_size(monkeypatch, tmp_path):
    """``chip_smoke.serve_mesh`` end to end on ``tiny-moe`` over two CPU
    ranks: its reference from a single-device runner
    (``mesh_reference``), its checks (the decode step over the pages the
    mesh wrote among them), the job API on the mesh and the ep, sp, pp
    and dp_ep phases (four ranks, an odd batch)."""
    import chip_smoke

    monkeypatch.setenv("SUTRO_MONITOR", "0")
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    mcfg = MODEL_CONFIGS["tiny-moe"]
    geometry = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
                    max_model_len=128, decode_multi_step=4, prefix_split=True,
                    param_dtype="float32")
    single = t_runner.ModelRunner(mcfg, EngineConfig(**geometry), device="cpu")
    rng = np.random.default_rng(0)
    template = rng.integers(3, 500, 24).astype(np.int32)
    prompts = [np.concatenate([template, rng.integers(3, 500, n).astype(np.int32)])
               for n in rng.integers(4, 30, 8)]
    ref = chip_smoke.mesh_reference(torch, single, prompts, n_rows=8, n_new=8)
    del single
    out = chip_smoke.serve_mesh(
        torch, [], "cpu", ref, model="tiny-moe", devices=["cpu", "cpu"], geometry=geometry,
        n_rows=8, n_new=8, job_rows=4, phase_layers=2, sp_tokens=64)
    assert out["backend"] == "gloo" and out["logits_rel_l2"] < chip_smoke.REL_L2
    # one decode step over the pages the mesh wrote: split, full table, plain
    for by_rank in out["decode_rel_l2"]:
        assert set(by_rank) == {"split", "full_table", "plain"}
        assert all(v < chip_smoke.REL_L2 for v in by_rank.values()), by_rank
    # the CPU's float32 arithmetic: the mesh's rows are the single device's
    assert out["token_equal_to_serve2"] == "8/8"
    assert out["job"]["status"] == "SUCCEEDED" and out["checksummed_leaves"] > 0
    assert all(c > 0 for c in out["window"]["collectives"])
    for name, ph in out["phases"].items():
        assert ph["logits_rel_l2"] < chip_smoke.REL_L2 and ph["token_mismatches"] == 0, name
    assert out["phases"]["sp"]["tokens"] == 64
    dp_ep = out["phases"]["dp_ep"]
    assert len(dp_ep["launches_by_rank"]) == 4 and dp_ep["odd_rows"] == 3
    assert all(c > 0 for c in dp_ep["window_collectives"])
    summary = chip_smoke.mesh_summary(out)
    assert set(summary["phases_rel_l2"]) == {"ep", "sp", "pp", "dp_ep"}
    assert summary["dp_ep_odd_rel_l2"] < chip_smoke.REL_L2


TORCHRUN_SCRIPT = '''
import numpy as np, torch
from sutro_tpu_torch.parallel.mesh import init_distributed
from sutro_tpu_torch.parallel.ranks import torchrun_worker
if __name__ == "__main__":
    torch.set_num_threads(1)
    rank, world = init_distributed()
    if rank > 0:
        torchrun_worker()
    else:
        from sutro_tpu_torch.engine.config import EngineConfig
        from sutro_tpu_torch.engine.runner import ModelRunner
        from sutro_tpu_torch.models.configs import MODEL_CONFIGS
        r = ModelRunner(MODEL_CONFIGS["tiny-dense"], EngineConfig(kv_page_size=8,
            max_pages_per_seq=4, decode_batch_size=1, max_model_len=32,
            param_dtype="float32", tp=world), device=["cpu"] * world)
        table = np.array([[1, 2, 0, 0]], np.int32)
        r.prefill(np.arange(3, 12, dtype=np.int32), table[0])
        r.decode_step(np.array([5], np.int32), np.array([9], np.int32), table, 0,
                      np.zeros(1, np.float32), np.ones(1, np.float32))
        rep = r.mesh_report()
        print("TORCHRUN_OK", r.mesh.size, len(r._pool.ranks.procs), rep[1]["token_checks"])
        r.close()
'''


def test_a_torchrun_launch_runs_a_mesh(tmp_path):
    """Under ``torchrun`` rank 0's runner spawns nothing: rank 1 is the
    launch's second process (``parallel.ranks.torchrun_worker``)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "launch.py"
    script.write_text(TORCHRUN_SCRIPT)
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root), "SUTRO_MESH_TIMEOUT": "60"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(script)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TORCHRUN_OK 2 0 1" in out.stdout
