"""The eval templates and the function calls of the port's façade
against the JAX package's.

- ``tests/test_evals.py``'s cases (the Bradley–Terry/Elo fit, its tie
  groups and tie break, JSON rankings, the empty table, ``rank``'s input
  checks and its permutation schema) run on both packages' ``Rank``.
- On engines of both packages over one ``tiny-dense`` checkpoint at
  temperature 0: ``rank`` (with its Elo table), ``score``,
  ``infer_per_model``, ``run_function`` (a dict, a string and a pydantic
  input) and ``batch_run_function`` (a DataFrame and a list of dicts)
  give the JAX façade's results.
"""

import json

import pandas as pd
import pytest
from pydantic import BaseModel

import sutro_tpu as jso
import sutro_tpu_torch as so
from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import compile_schema as jax_compile_schema
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.templates import evals as jax_evals
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.constrain import compile_schema
from sutro_tpu_torch.templates import evals
from tests.test_torch_api import ENGINE, _no_native_masks
from tests.test_torch_weights_loader import write_hf_checkpoint

PACKAGES = pytest.mark.parametrize("ev,compile_", [
    (jax_evals, jax_compile_schema), (evals, compile_schema)], ids=["jax", "port"])


@PACKAGES
def test_elo_orders_clear_winner(ev, compile_):
    df = ev.Rank.elo([["a", "b", "c"]] * 10 + [["a", "c", "b"]] * 3)
    assert list(df["player"]) == ["a", "b", "c"]
    assert df["elo"].iloc[0] > df["elo"].iloc[1] > df["elo"].iloc[2]


@PACKAGES
def test_elo_symmetric_is_flat(ev, compile_):
    df = ev.Rank.elo([["a", "b"], ["b", "a"]] * 5)
    assert abs(df["elo"].iloc[0] - df["elo"].iloc[1]) < 1.0


@PACKAGES
def test_elo_tie_groups(ev, compile_):
    df = ev.Rank.elo([["a", ["b", "c"]]] * 6)
    assert df["player"].iloc[0] == "a"
    b = df[df["player"] == "b"]["elo"].iloc[0]
    c = df[df["player"] == "c"]["elo"].iloc[0]
    assert abs(b - c) < 1.0


@PACKAGES
def test_elo_tie_break_is_deterministic_alphabetical(ev, compile_):
    rankings = [["z", "y"], ["y", "z"]] * 3
    assert list(ev.Rank.elo(rankings)["player"]) == ["y", "z"]
    assert list(ev.Rank.elo([["w", ["c", "b", "d"]]] * 4)["player"]) == ["w", "b", "c", "d"]
    pd.testing.assert_frame_equal(ev.Rank.elo(rankings), ev.Rank.elo(rankings))


@PACKAGES
def test_elo_json_string_rankings(ev, compile_):
    assert ev.Rank.elo(['["a","b"]', '["a","b"]', "not-json"])["player"].iloc[0] == "a"


@PACKAGES
def test_elo_empty(ev, compile_):
    assert len(ev.Rank.elo([])) == 0


@PACKAGES
def test_rank_validates_options(ev, compile_):
    class Dummy(ev.Rank):
        pass

    d = Dummy()
    with pytest.raises(ValueError, match="DataFrame"):
        d.rank(["not-a-df"], options=["a"], criteria="c")
    with pytest.raises(ValueError, match="not in DataFrame"):
        d.rank(pd.DataFrame({"a": ["1"]}), options=["a", "missing"], criteria="c")


@PACKAGES
def test_rank_schema_is_true_permutation(ev, compile_):
    schema = {"type": "object", "properties": {"ranking": ev._ranking_schema(["a", "b", "c"])},
              "required": ["ranking"]}
    nfa = compile_(schema)

    def accepts(text):
        states = nfa.initial()
        for byte in text.encode():
            states = nfa.step(states, byte)
            if not states:
                return False
        return nfa.is_accepting(states)

    enc = lambda r: json.dumps({"ranking": r}, separators=(",", ":"))  # noqa: E731
    assert accepts(enc(["b", "a", "c"])) and accepts(enc(["c", "b", "a"]))
    assert not accepts(enc(["a", "a", "b"])) and not accepts(enc(["a", "b"]))


def test_elo_tables_are_equal():
    rankings = [["a", "b", "c"], ["b", ["a", "c"]], '["c","a","b"]'] * 4 + [["d", "a"]]
    pd.testing.assert_frame_equal(evals.Rank.elo(rankings), jax_evals.Rank.elo(rankings))


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    """(JAX client, port client) over engines of their own package at
    temperature 0 (``run_function`` takes the engine's sampling)."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-evals")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 9, root / "weights" / "tiny-dense")
    cfg = dict(ENGINE, weights_dir=str(root / "weights"), temperature=0.0)
    mp.setattr(jax_cpp, "CppMasker", _no_native_masks)
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **cfg))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    mp.setattr(jso._instance, "_engine", jeng)
    mp.setattr(so._instance, "_engine", teng)
    yield jso._instance, so._instance
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


GREEDY = {"temperature": 0.0, "max_new_tokens": 8}
DF = pd.DataFrame({"left": ["a cat", "two dogs"], "right": ["one bird", "a fish"],
                   "mid": ["some text", "more"]})


def test_rank_and_elo_equal_the_jax_facade(clients):
    got = [c.rank(DF, options=["left", "right", "mid"], criteria="which is shortest",
                  model="tiny-dense", compute_elo=True, sampling_params=GREEDY)
           for c in clients]
    (want_df, want_elo), (got_df, got_elo) = got
    pd.testing.assert_frame_equal(got_df, want_df)
    pd.testing.assert_frame_equal(got_elo, want_elo)
    assert list(got_df.columns[:3]) == ["left", "right", "mid"] and "ranking" in got_df


def test_score_equals_the_jax_facade(clients):
    got = [c.score(["short", "a longer answer"], criteria="brevity", model="tiny-dense",
                   min_score=1, max_score=3, sampling_params=GREEDY) for c in clients]
    pd.testing.assert_frame_equal(got[1], got[0])
    assert "score" in got[1].columns


def test_infer_per_model_equals_the_jax_facade(clients):
    out = []
    for c in clients:
        ids = c.infer_per_model(["x", "y"], models=["tiny-dense", "tiny-dense"],
                                names=["a", "b"], sampling_params=GREEDY)
        out.append([c.await_job_completion(j)["inference_result"].tolist() for j in ids]
                   + [[c.engine.get_job(j)["name"] for j in ids]])
        with pytest.raises(ValueError, match="names"):
            c.infer_per_model(["x"], models=["tiny-dense"], names=["a", "b"])
    assert out[1] == out[0]
    assert out[1][-1] == ["a", "b"]


class _Question(BaseModel):
    q: str
    n: int


@pytest.mark.parametrize("data", [{"q": "why", "n": 2}, "plain text", _Question(q="a", n=1)],
                         ids=["dict", "str", "pydantic"])
def test_run_function_equals_the_jax_facade(clients, data):
    got = [c.run_function("tiny-dense", data) for c in clients]
    assert got[1]["response"] == got[0]["response"]
    assert got[1]["confidence"] == pytest.approx(got[0]["confidence"], rel=1e-3)
    assert got[1]["predictions"] == got[0]["predictions"] == []
    assert clients[1].engine.job_status(got[1]["run_id"]) == "SUCCEEDED"


def test_batch_run_function_equals_the_jax_facade(clients):
    frame = pd.DataFrame({"q": ["a", "b"], "n": [1, 2]})
    out = []
    for c in clients:
        ids = [c.batch_run_function("tiny-dense", frame, stay_attached=False,
                                    sampling_params=GREEDY),
               c.batch_run_function("tiny-dense", [{"q": "c"}, "raw"], stay_attached=False,
                                    sampling_params=GREEDY)]
        out.append([c.engine.job_results(j, include_inputs=True) for j in
                    [i for i in ids if c.await_job_completion(i, obtain_results=False)]])
    assert out[1] == out[0]
    assert out[1][0]["inputs"] == ['{"q": "a", "n": 1}', '{"q": "b", "n": 2}']
