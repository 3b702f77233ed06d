"""The port's stage graphs (``engine/stagegraph.py``) against the JAX
package's.

- ``parse_graph`` refuses every bad graph of the JAX package's tests with
  the same ``InvalidGraph`` reason and message;
- ``estimate_stage_rows``, ``graph_cost_bounds`` and
  ``initial_stages_state`` equal the JAX functions on valid graphs;
- ``run_host_stage_kind``'s filter and pair stages give the JAX rows,
  its ELO stage the same players and ratings within 1e-9; the
  pandas-free fit ``templates.evals.elo_fit``, run with pandas blocked,
  gives the JAX ``Rank.elo`` within 1e-9 on seeded rankings (ties, one
  player, none);
- on tiny-dense and tiny-oss (both engines on the same checkpoints),
  a gen -> score -> rank chain and a map -> filter -> pair ->
  map(schema) -> elo graph give token-identical per-stage outputs and
  sinks at temperature 0, the same per-stage rollup and the same
  dry-run price;
- on the port alone (the JAX engine fails a quarantined row under
  pandas 3): a row quarantined in the first stage propagates as an
  error placeholder, logged in the parent's failure_log;
- a graph whose later stages are lost resumes from the per-stage partial
  stores to the same sink;
- an invalid graph is HTTP 400 ``INVALID_GRAPH`` from both servers
  with the same body, and a typed ``InvalidGraph`` from ``run_graph``,
  locally and remotely; a valid one runs through ``so.run_graph``;
- the ``stage_progress`` frame round-trips as the JAX package's does;
- ``chip_smoke.serve_graphs`` (serve 8) passes every check on the CPU
  at a tiny size.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import sutro_tpu.engine.stageframes as jax_frames
import sutro_tpu.engine.stagegraph as jsg
from sutro_tpu import server as jax_server
from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.templates.evals import Rank as JaxRank
from sutro_tpu_torch import server
from sutro_tpu_torch.engine import api, faults, stageframes
from sutro_tpu_torch.engine import stagegraph as sg
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.sdk import Sutro
from tests.test_torch_weights_loader import write_hf_checkpoint

ROOT = Path(__file__).resolve().parent.parent
ENGINE = dict(kv_page_size=8, max_pages_per_seq=32, decode_batch_size=4, max_model_len=256,
              param_dtype="float32", activation_dtype="float32", max_new_tokens=16)
ELO_TOL = 1e-9
RANKING = {"type": "object",
           "properties": {"ranking": {"type": "array", "items": {"enum": ["A", "B"]},
                                      "minItems": 2, "maxItems": 2}},
           "required": ["ranking"]}


# ---------------------------------------------------------------------------
# parse, price, host stages
# ---------------------------------------------------------------------------

BAD = {
    "not_a_list": "not a list",
    "empty": [],
    "too_many_stages": [{"name": f"s{i}", "kind": "map", "after": [f"s{i - 1}"] if i else []}
                        for i in range(17)],
    "not_a_dict": ["nope"],
    "path_escape": [{"name": "../escape", "kind": "map"}],
    "no_name": [{"kind": "map"}],
    "duplicate_name": [{"name": "a", "kind": "map"}, {"name": "a", "kind": "map",
                                                       "after": ["a"]}],
    "bad_kind": [{"name": "a", "kind": "reduce"}],
    "bad_after": [{"name": "a", "kind": "map", "after": 7}],
    "two_parents": [{"name": "a", "kind": "map"}, {"name": "b", "kind": "map"},
                    {"name": "c", "kind": "map", "after": ["a", "b"]}],
    "filter_without_parent": [{"name": "f", "kind": "filter"}],
    "elo_without_parent": [{"name": "e", "kind": "elo"}],
    "bad_template": [{"name": "a", "kind": "map", "prompt_template": "no placeholder"}],
    "bad_predicate": [{"name": "a", "kind": "map"}, {"name": "f", "kind": "filter",
                                                     "after": ["a"],
                                                     "predicate": {"type": "regex"}}],
    "dangling_edge": [{"name": "a", "kind": "map", "after": ["ghost"]}],
    "self_loop": [{"name": "a", "kind": "map", "after": ["a"]}],
    "cycle": [{"name": "a", "kind": "map", "after": ["b"]},
              {"name": "b", "kind": "map", "after": ["a"]}],
    "two_sinks": [{"name": "a", "kind": "map"}, {"name": "b", "kind": "map"}],
    "unknown_model": [{"name": "a", "kind": "map", "model": "no-such-model"}],
}


def _refusal(mod, stages, resolve):
    with pytest.raises(mod.InvalidGraph) as e:
        mod.parse_graph(stages, default_model="tiny-dense", resolve=resolve)
    return e.value.reason, str(e.value), e.value.code, e.value.status


@pytest.mark.parametrize("name", sorted(BAD))
def test_parse_graph_refuses_with_the_reference_reason(name):
    assert _refusal(sg, BAD[name], api.resolve_model) == _refusal(
        jsg, BAD[name], jax_api.resolve_model)


GRAPHS = {
    "chain": [{"name": "gen", "kind": "map", "system_prompt": "Be terse.",
               "sampling_params": {"max_new_tokens": 12}},
              {"name": "score", "kind": "map", "after": ["gen"],
               "prompt_template": "score: {input}", "sampling_params": {"max_new_tokens": 5}},
              {"name": "rank", "kind": "map", "after": "score",
               "prompt_template": "rank: {input}"}],
    "elo": [{"name": "gen", "kind": "map"},
            {"name": "keep", "kind": "filter", "after": ["gen"],
             "predicate": {"type": "min_length", "value": 3}},
            {"name": "pairs", "kind": "pair", "after": ["keep"], "max_pairs": 5},
            {"name": "judge", "kind": "map", "after": ["pairs"], "output_schema": RANKING,
             "prompt_template": "better? {input}", "system_prompt": "You judge.",
             "sampling_params": {"max_new_tokens": 32}},
            {"name": "elo", "kind": "elo", "after": ["judge"]}],
    "fan_out_host": [{"name": "m", "kind": "map", "model": "tiny-oss"},
                     {"name": "f", "kind": "filter", "after": ["m"],
                      "predicate": {"type": "contains", "value": "a"}},
                     {"name": "p", "kind": "pair", "after": ["f"]}],
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("n", [0, 1, 7, 40])
def test_pricing_and_initial_state_equal_the_reference(graph, n):
    ours = sg.parse_graph(GRAPHS[graph], "tiny-dense", api.resolve_model)
    theirs = jsg.parse_graph(GRAPHS[graph], "tiny-dense", jax_api.resolve_model)
    assert ours.to_payload() == theirs.to_payload()
    assert [s.name for s in ours.topo()] == [s.name for s in theirs.topo()]
    assert sg.estimate_stage_rows(ours, n) == jsg.estimate_stage_rows(theirs, n)
    assert sg.graph_cost_bounds(ours, n, 16) == jsg.graph_cost_bounds(theirs, n, 16)
    assert sg.initial_stages_state(ours, n) == jsg.initial_stages_state(theirs, n)
    assert sg.stage_job_id("job-1", "gen") == jsg.stage_job_id("job-1", "gen")


def _outputs(rng, n):
    words = ["alpha", "b", "", "aaa", "zz top", "{\"ranking\": [\"A\", \"B\"]}",
             "[\"B\", \"A\"]", "not json", "[[\"A\", \"B\"]]", "{\"ranking\": []}"]
    return [(int(i), words[int(rng.integers(0, len(words)))]) for i in sorted(
        rng.choice(100, n, replace=False))]


@pytest.mark.parametrize("seed", range(4))
def test_host_stage_kinds_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    ordered = _outputs(rng, int(rng.integers(0, 30)))
    for d in ({"name": "f", "kind": "filter", "after": ["a"]},
              {"name": "f", "kind": "filter", "after": ["a"],
               "predicate": {"type": "contains", "value": "a"}},
              {"name": "f", "kind": "filter", "after": ["a"],
               "predicate": {"type": "min_length", "value": 3}},
              {"name": "p", "kind": "pair", "after": ["a"], "max_pairs": int(seed * 7)},
              {"name": "p", "kind": "pair", "after": ["a"]}):
        assert sg.run_host_stage_kind(sg.StageSpec(d), ordered) == \
            jsg.run_host_stage_kind(jsg.StageSpec(d), ordered)
    spec = {"name": "e", "kind": "elo", "after": ["a"]}
    got = [json.loads(r) for r in sg.run_host_stage_kind(sg.StageSpec(spec), ordered)]
    want = [json.loads(r) for r in jsg.run_host_stage_kind(jsg.StageSpec(spec), ordered)]
    assert [r["player"] for r in got] == [r["player"] for r in want]
    assert np.allclose([r["elo"] for r in got], [r["elo"] for r in want], rtol=0, atol=ELO_TOL)


def _rankings(seed):
    rng = np.random.default_rng(seed)
    if seed == 0:
        return []
    if seed == 1:
        return [["solo"], ["solo"]]
    players = [f"p{i}" for i in range(int(rng.integers(2, 7)))]
    out = []
    for _ in range(int(rng.integers(1, 25))):
        order = list(rng.permutation(players))
        if rng.random() < 0.3 and len(order) > 2:   # a tie group
            order = [order[0], list(order[1:3]), *order[3:]]
        out.append(json.dumps(order) if rng.random() < 0.2 else order)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_elo_fit_without_pandas_equals_the_reference_rank_elo(seed):
    rankings = _rankings(seed)
    code = (
        "import json, sys\n"
        "sys.modules['pandas'] = None\n"
        "from sutro_tpu_torch.templates.evals import elo_fit\n"
        f"print(json.dumps(elo_fit(json.loads({json.dumps(json.dumps(rankings))}))))\n"
        "assert sys.modules['pandas'] is None\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=120)
    assert out.returncode == 0, out.stderr
    players, elo, strength = json.loads(out.stdout)
    df = JaxRank.elo(rankings)
    assert players == df["player"].tolist()
    assert np.allclose(elo, df["elo"].tolist(), rtol=0, atol=ELO_TOL)
    assert np.allclose(strength, df["strength"].tolist(), rtol=0, atol=ELO_TOL)


def test_stage_progress_frame_round_trip():
    roll = {"gen": {"status": "running", "kind": "map", "rows_done": 3, "rows_total": 8,
                    "quarantined": 1}}
    for mod in (stageframes, jax_frames):
        frame = mod.stage_progress_frame(roll)
        assert mod.parse_stage_progress(json.loads(json.dumps(frame))) == roll
    assert stageframes.stage_progress_frame(roll) == jax_frames.stage_progress_frame(roll)
    for doc in ({"update_type": "progress"}, {"t": "x", "update_type": "stages"}, [],
                {"update_type": "stages", "result": 5}, {"update_type": "stages"}):
        assert stageframes.parse_stage_progress(doc) == jax_frames.parse_stage_progress(doc)
    for entry in (roll["gen"], {"rows_done": "x", "extra": 1}, None, {"rows_total": -4}):
        assert stageframes.rollup_counts(entry) == jax_frames.rollup_counts(entry)


# ---------------------------------------------------------------------------
# both engines on the same checkpoints
# ---------------------------------------------------------------------------


def _no_native_masks(*a, **k):
    raise OSError("the JAX side's native mask core is not used here")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-stagegraph")
    for seed, name in enumerate(("tiny-dense", "tiny-oss")):
        write_hf_checkpoint(MODEL_CONFIGS[name], 30 + seed, root / "weights" / name)
    cfg = dict(ENGINE, weights_dir=str(root / "weights"))
    mp.setattr(jax_cpp, "CppMasker", _no_native_masks)
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setenv("SUTRO_STAGE_FEED_EVERY", "1")
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **cfg))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    yield jeng, teng
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def wait(eng, jid, timeout=180):
    deadline = time.monotonic() + timeout
    while eng.job_status(jid) not in ("SUCCEEDED", "FAILED", "CANCELLED"):
        assert time.monotonic() < deadline, eng.job_status(jid)
        time.sleep(0.01)
    return eng.job_status(jid)


def _payload(model, stages, n=6, **kw):
    return {"model": model, "inputs": [f"input row {i} for {model}" for i in range(n)],
            "stages": stages, "sampling_params": {"temperature": 0.0}, **kw}


def _run(eng, payload):
    jid = eng.submit_batch_inference(payload)
    assert wait(eng, jid) == "SUCCEEDED", eng.get_job(jid)
    rec = eng.get_job(jid)
    rec = rec if isinstance(rec, dict) else rec.to_dict()
    stages = {s["name"]: eng.job_results(f"{jid}/stages/{s['name']}")["outputs"]
              for s in payload["stages"]}
    return jid, eng.job_results(jid)["outputs"], stages, rec


@pytest.mark.parametrize("model", ["tiny-dense", "tiny-oss"])
@pytest.mark.parametrize("graph", ["chain", "elo"])
def test_graphs_are_token_identical_to_the_jax_engine(engines, model, graph):
    stages = [{**s, "model": model} if s.get("model") else s for s in GRAPHS[graph]]
    (_, jsink, jstages, jrec), (tjid, tsink, tstages, trec) = (
        _run(e, _payload(model, stages)) for e in engines)
    assert tstages == jstages and tsink == jsink
    assert trec["stages_state"] == jrec["stages_state"]
    assert all(v["status"] == "succeeded" for v in trec["stages_state"].values())
    for k in ("input_tokens", "output_tokens", "num_rows"):
        assert trec[k] == jrec[k], k
    if graph == "chain":
        # streaming admission: score's first row before gen's last
        from sutro_tpu_torch import telemetry

        spans = telemetry.job(tjid).attrs["stages"]
        assert spans["score"]["first_result_s"] < spans["gen"]["done_s"]
    else:
        assert tstages["pairs"] and all(json.loads(o)["ranking"] for o in tstages["judge"])


def test_dry_run_prices_the_whole_graph_as_the_reference(engines):
    recs = []
    for eng in engines:
        jid = eng.submit_batch_inference(_payload("tiny-dense", GRAPHS["elo"], dry_run=True))
        assert wait(eng, jid) == "SUCCEEDED"
        rec = eng.get_job(jid)
        recs.append(rec if isinstance(rec, dict) else rec.to_dict())
    assert recs[0]["cost_estimate"] == recs[1]["cost_estimate"] > 0
    assert recs[0]["input_tokens"] == recs[1]["input_tokens"]


def test_a_quarantined_row_propagates_per_stage(engines):
    eng = engines[1]
    stages = GRAPHS["chain"][:2]
    ref = _run(eng, _payload("tiny-dense", stages, n=8))[1]
    faults.configure("row.decode:error:rows=3,job=stages/gen")
    try:
        jid = eng.submit_batch_inference(_payload("tiny-dense", stages, n=8))
        assert wait(eng, jid) == "SUCCEEDED"
    finally:
        faults.clear()
    res = eng.job_results(jid)
    assert res["outputs"][3] is None and res["errors"][3]
    assert [o for i, o in enumerate(res["outputs"]) if i != 3] == [
        o for i, o in enumerate(ref) if i != 3]
    state = eng.get_job(jid)["stages_state"]
    assert state["gen"]["quarantined"] == 1 and state["score"]["quarantined"] == 1
    skips = [(e["stage"], e["source_stage"], e["row_id"])
             for e in eng.get_job(jid)["failure_log"] if e["event"] == "stage_row_skipped"]
    assert skips == [("score", "gen", 3)]


def test_a_graph_resumes_from_its_stage_partials(engines):
    """gen and half of score survive (their records and partial
    chunks); the rest of the graph and the parent's results are lost.
    ``resume_job`` finishes it to the same sink without running gen."""
    import shutil

    from sutro_tpu_torch.interfaces import JobStatus

    eng = engines[1]
    stages = GRAPHS["chain"]
    jid, sink, outs, _ = _run(eng, _payload("tiny-dense", stages, n=8))
    root = eng.jobs._dir(jid)
    gen_chunks = sorted((root / "stages" / "gen" / "partial").iterdir())
    for chunk in (root / "stages" / "score" / "partial").iterdir():
        kept = [r for r in eng.jobs._parse_chunk(chunk) if r["row_id"] % 2 == 0]
        chunk.write_text(eng.jobs._chunk_text(kept))
    shutil.rmtree(root / "stages" / "rank")
    for p in ("partial", "results.jsonl"):
        shutil.rmtree(root / p, ignore_errors=True) if p == "partial" else (root / p).unlink()
    eng.jobs.update(f"{jid}/stages/score", status=JobStatus.RUNNING.value)
    eng.jobs.update(jid, status=JobStatus.FAILED.value)
    eng.resume_job(jid)
    assert wait(eng, jid) == "SUCCEEDED", eng.get_job(jid)
    assert eng.job_results(jid)["outputs"] == sink
    assert eng.job_results(f"{jid}/stages/score")["outputs"] == outs["score"]
    assert sorted((root / "stages" / "gen" / "partial").iterdir()) == gen_chunks


# ---------------------------------------------------------------------------
# the servers and the SDK
# ---------------------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(f"{url}/batch-inference", method="POST",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("name", ["dangling_edge", "cycle", "bad_template", "two_sinks"])
def test_an_invalid_graph_is_the_same_400_from_both_servers(engines, name):
    jeng, teng = engines
    jsrv, _, jurl = jax_server.start_server_thread(jeng)
    tsrv, tthread, turl = server.start_server_thread(teng)
    try:
        before = len(teng.list_jobs())
        body = {"model": "tiny-dense", "inputs": ["x"], "stages": BAD[name]}
        got, want = _post(turl, body), _post(jurl, body)
        assert got == want and got[0] == 400 and got[1]["error"]["code"] == "INVALID_GRAPH"
        assert len(teng.list_jobs()) == before   # no record was made
        with pytest.raises(sg.InvalidGraph) as e:
            Sutro(backend="remote", base_url=turl).run_graph(["x"], stages=BAD[name],
                                                              model="tiny-dense")
        assert e.value.reason == want[1]["error"]["reason"]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
        tthread.join(timeout=30)


def test_run_graph_through_the_sdk(engines, capsys):
    teng = engines[1]
    so = Sutro()
    so._engine = teng
    with pytest.raises(sg.InvalidGraph) as e:
        so.run_graph(["x"], stages=BAD["cycle"], model="tiny-dense", stay_attached=False)
    assert e.value.reason == "cycle"
    jid = so.run_graph(["one", "two", "three"], stages=GRAPHS["chain"], model="tiny-dense",
                       stay_attached=False, sampling_params={"temperature": 0.0},
                       tenant="acme")
    assert so.await_job_completion(jid, obtain_results=False) == jid
    updates = list(teng.stream_job_progress(jid))
    assert updates[-1]["result"] == 3
    assert teng.get_job(jid)["tenant"] == "acme"


def test_smoke_serve8_runs_at_a_tiny_size(tmp_path, monkeypatch):
    """``chip_smoke.py``'s serve 8 end to end on the CPU at a tiny size
    (tiny-oss with random weights, 24 gen rows, 16 + 4 ladder rows):
    every check it makes on the card passes here with the plain
    versions."""
    import torch

    import chip_smoke

    monkeypatch.setenv("SUTRO_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SUTRO_STAGE_FEED_EVERY", "2")
    monkeypatch.delenv("SUTRO_MONITOR", raising=False)
    monkeypatch.delenv("SUTRO_CONTROL", raising=False)
    geometry = dict(kv_page_size=8, max_pages_per_seq=64, decode_batch_size=8,
                    max_model_len=512, decode_multi_step=4, param_dtype="float32",
                    activation_dtype="float32", prefix_split=True, max_batch_tokens=8 * 512)
    out = chip_smoke.serve_graphs(
        torch, [], [], "cpu", model="tiny-oss", device="cpu", geometry=geometry, n_gen=24,
        gen_chars=(8, 40), gen_system_chars=40, crit_system_chars=80, gen_new=12,
        crit_new=12, max_pairs=6, p1_rows=16, p1_new=24, p0_rows=4, p0_new=4,
        monitor_interval=0.1)
    assert out["ladder"]["rows_suspended"] >= 1 and out["prefix_saved_tokens"] > 0
    assert out["monitor"]["smoke_rule_states"] == ["ok", "pending", "firing", "ok"]
    assert out["prefill_rel_l2"] < chip_smoke.REL_L2
