"""The port's ``Sutro`` façade against the JAX package's.

Both façades drive an engine of their own package on one tiny config
with ``weights_dir`` at the same tiny-dense checkpoint (the port's on
the CPU). The milestone: ``so.classify([...], classes=...,
model="tiny-dense")`` at temperature 0 returns the JAX package's
DataFrame. Also: ``classify``'s schema dict and system prompt equal the
JAX template's (pydantic's ``model_json_schema()``) for list and dict
classes; ``infer`` on a DataFrame with ``column`` (one name, or names
and separators) and ``with_original_df``; the results cache round
trip; the job-lifecycle methods; the helpers of ``common``; and what
was once refused (stage graphs, the control plane, data-parallel
engines, the fleet view and the live monitor) answering as the JAX
package's does.
"""

import json

import pandas as pd
import pytest

import sutro_tpu as jso
import sutro_tpu_torch as so
from sutro_tpu import common as jax_common
from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.templates.classification import ClassificationTemplates as JaxTemplates
from sutro_tpu_torch import common
from sutro_tpu_torch.engine import api
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.sdk import Sutro
from sutro_tpu_torch.templates.classification import _prompt_and_schema
from tests.test_torch_api import ENGINE, _no_native_masks
from tests.test_torch_weights_loader import write_hf_checkpoint

TEXTS = ["I love this product", "worst purchase ever", "it is fine I guess"]
LABELS = ["positive", "negative", "neutral"]


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    """(JAX client, port client), each over its own engine, both behind
    the module façades ``jso`` / ``so`` too; ``SUTRO_HOME`` is a
    temporary directory for the whole module (the results cache lives
    there)."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("torch-sdk")
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 5, root / "weights" / "tiny-dense")
    cfg = dict(ENGINE, weights_dir=str(root / "weights"))
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


def test_classify_returns_the_jax_dataframe(clients):
    want = jso.classify(TEXTS, classes=LABELS, model="tiny-dense")
    got = so.classify(TEXTS, classes=LABELS, model="tiny-dense")
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["inference_result", "classification"]
    assert set(got["classification"]) <= set(LABELS)


def test_classify_dict_classes_with_scratchpad(clients):
    classes = {"spam": "unsolicited ads", "ham": "anything else"}
    kw = dict(classes=classes, model="tiny-dense", keep_scratchpad=True,
              context="Emails from a shared inbox.")
    want = jso.classify(TEXTS[:2], **kw)
    got = so.classify(TEXTS[:2], **kw)
    pd.testing.assert_frame_equal(got, want)
    assert "scratchpad" in got.columns


class _Capture(JaxTemplates):
    """The JAX template with ``infer`` caught: what it would submit."""

    def infer(self, data, **kw):
        self.kw = kw
        return None


@pytest.mark.parametrize("classes", [
    LABELS, {"a": "first", "b": "second"}, ["x", "x", "y"], ["only"],
])
@pytest.mark.parametrize("context", [None, "Some context."])
def test_classify_schema_and_prompt_equal_pydantic(classes, context):
    cap = _Capture()
    cap.classify(["row"], classes=classes, context=context)
    prompt, schema = _prompt_and_schema(classes, context)
    assert schema == cap.kw["output_schema"].model_json_schema()
    assert prompt == cap.kw["system_prompt"]
    assert list(schema["properties"]) == ["scratchpad", "classification"]


def test_infer_on_a_dataframe_with_column(clients):
    df = pd.DataFrame({"title": ["One", "Two", "Three"], "body": ["a b", "c d", "e f"]})
    out = []
    for c in clients:
        a = c.infer(df, model="tiny-dense", column="title", stay_attached=False,
                    sampling_params={"temperature": 0.0, "max_new_tokens": 6})
        b = c.infer(df, model="tiny-dense", column=["title", ": ", "body"],
                    stay_attached=False,
                    sampling_params={"temperature": 0.0, "max_new_tokens": 6})
        out.append([c.await_job_completion(a, with_original_df=df),
                    c.await_job_completion(b), c.engine.job_results(b, include_inputs=True)])
    for want, got in zip(*out):
        if isinstance(want, pd.DataFrame):
            pd.testing.assert_frame_equal(got, want)
        else:
            assert got == want
    assert out[1][2]["inputs"] == ["One: a b", "Two: c d", "Three: e f"]
    assert list(out[1][0].columns) == ["title", "body", "inference_result"]


def test_results_cache_round_trip(clients):
    _, c = clients
    jid = c.infer(TEXTS, model="tiny-dense", stay_attached=False,
                  sampling_params={"temperature": 0.0, "max_new_tokens": 5})
    first = c.await_job_completion(jid, output_column="out")
    cache = c._cache_dir() / f"{jid}.json"
    assert json.loads(cache.read_text()) == {"outputs": first["out"].tolist()}
    # a second read comes from the cache: the engine is not asked
    engine, c._engine = c._engine, None
    try:
        again = c.get_job_results(jid, output_column="out")
    finally:
        c._engine = engine
    pd.testing.assert_frame_equal(again, first)
    # more columns than cached: a miss, fetched and cached anew
    wide = c.get_job_results(jid, include_inputs=True, include_cumulative_logprobs=True)
    assert list(wide.columns) == ["inputs", "inference_result", "cumulative_logprobs"]
    assert wide["inputs"].tolist() == TEXTS
    names = [e["file"] for e in c.show_job_results_cache()]
    assert f"{jid}.json" in names
    assert c.clear_job_results_cache() == len(names)
    assert c.show_job_results_cache() == []


def test_job_lifecycle_methods(clients, capsys):
    rows = [f"row {i}" for i in range(6)]
    got = []
    for cl in clients:
        jid = cl.infer(rows, model="tiny-dense", stay_attached=True,
                       sampling_params={"temperature": 0.0, "max_new_tokens": 6})
        status = cl.get_job_status(jid, with_failure_log=True)
        job = next(j for j in cl.list_jobs() if j["job_id"] == jid)
        got.append([status["status"], status["failure_log"], job["num_rows"],
                    cl.get_job_failure_log(jid), cl.resume_job(jid)["resumed"],
                    cl.cancel_job(jid), cl.await_job_completion(jid)["inference_result"].tolist(),
                    cl.get_quotas(), cl.try_authentication()])
        cl.attach(jid)
    assert got[0] == got[1]
    assert got[1][0] == "SUCCEEDED"
    assert "Job already succeeded" in capsys.readouterr().out
    est = [cl.infer(rows, model="tiny-dense", dry_run=True) for cl in clients]
    assert est[0] == est[1] > 0


def test_common_helpers_match():
    df = pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})
    cases = [(["p", 3], None), (df, "a"), (df, ["a", "-", "b"]), (df["b"], None),
             ("dataset-abc", None), ("https://x/y.parquet", None)]
    for data, column in cases:
        assert common.prepare_input_data(data, column) == jax_common.prepare_input_data(
            data, column)
    for state in (None, "success", "fail", "error", "callout"):
        assert common.to_colored_text("t", state) == jax_common.to_colored_text("t", state)
    assert common.MODEL_CATALOG == jax_common.MODEL_CATALOG
    for n in (0, 1023, 1024, 5e9, 3e15):
        assert common.human_bytes(n) == jax_common.human_bytes(n)

    from pydantic import BaseModel

    class Out(BaseModel):
        x: int

    assert common.normalize_output_schema(Out) == jax_common.normalize_output_schema(Out)
    assert common.normalize_output_schema({"type": "object"}) == {"type": "object"}
    with pytest.raises(ValueError):
        common.prepare_input_data(df)
    with pytest.raises(ValueError):
        common.normalize_output_schema(42)


def test_what_is_not_ported_is_refused(clients, monkeypatch):
    """The remote backend, the serving tier, stage graphs, the control
    plane, the live monitor, data-parallel engines and the fleet view
    (all ported since) answer as the JAX package's do: an engine builds
    with ``SUTRO_DP_WORLD=2`` set, and a job that ran no dp round has
    the JAX package's fleet view."""
    from sutro_tpu.engine.stagegraph import InvalidGraph as JaxInvalidGraph
    from sutro_tpu_torch.engine.stagegraph import InvalidGraph

    jc, c = clients
    for backend in ("remote", "fleet"):
        assert Sutro(backend=backend).backend == "remote"
    with pytest.raises(ValueError):
        Sutro(backend="tcp")
    # stage graphs: the same typed refusal of a bad graph, and a good
    # one runs to its sink
    with pytest.raises(InvalidGraph) as got:
        so.run_graph(TEXTS, stages=[])
    with pytest.raises(JaxInvalidGraph) as want:
        jso.run_graph(TEXTS, stages=[])
    assert (got.value.reason, str(got.value)) == (want.value.reason, str(want.value))
    jid = c.engine.submit_batch_inference({"model": "tiny-dense", "inputs": TEXTS,
                                           "stages": [{"name": "a"}],
                                           "sampling_params": {"max_new_tokens": 2}})
    assert c.await_job_completion(jid, obtain_results=False) == jid
    assert len(c.engine.job_results(jid)["outputs"]) == len(TEXTS)
    # the control plane: built when asked for
    eng = api.LocalEngine(EngineConfig(control="rows=2"), device="cpu")
    try:
        assert eng.control is not None and eng.control.cfg.rows == 2.0
    finally:
        assert eng.close(timeout=30)
    monkeypatch.setenv("SUTRO_DP_WORLD", "2")
    assert api.LocalEngine(EngineConfig(), device="cpu").close(timeout=30)
    monkeypatch.delenv("SUTRO_DP_WORLD")
    for client in (c, jc):
        with pytest.raises(KeyError):
            client.get_job_fleet("job-x")
    jjid = jc.engine.submit_batch_inference({"model": "tiny-dense", "inputs": TEXTS,
                                             "dry_run": True})
    assert c.get_job_fleet(jid) == {"job_id": jid, "elastic": False}
    assert jc.get_job_fleet(jjid) == {"job_id": jjid, "elastic": False}
    # the monitor is off in this module (SUTRO_MONITOR=0): both engines
    # refuse the same way
    for client in (c, jc):
        with pytest.raises(KeyError, match="disabled"):
            client.get_monitor()
    eng = api.LocalEngine(EngineConfig(interactive_slots=1), device="cpu")
    try:
        assert eng.gateway is not None
        assert eng.fleet_state()["load"]["interactive_slots"] == 1
    finally:
        assert eng.close(timeout=30)


def test_smoke_classify_prompt_shares_whole_pages():
    """``chip_smoke.py``'s serve 5 runs the carry kernels only if its
    classify prompts (Qwen3's chat frame around the classify system
    prompt, byte tokenizer) share a whole 64-token page on qwen3-8b;
    ``shared_head`` finds that head as the scheduler does: page-aligned,
    at most one token short of the shortest prompt."""
    import chip_smoke

    assert chip_smoke.facade_prefix_pages() == 5
    a = list(range(200))
    assert len(chip_smoke.shared_head([a, a[:150] + [7] * 60], 64)) == 128
    assert len(chip_smoke.shared_head([a[:129], a], 64)) == 128
    assert len(chip_smoke.shared_head([a[:128], a], 64)) == 64
    assert len(chip_smoke.shared_head([a, [9] + a[1:]], 64)) == 0


def test_smoke_online_prompt_shares_whole_pages():
    """``chip_smoke.py``'s kernel phase holds the carry kernels at serve
    7's shape: the pages that job B's rows (Qwen3's chat frame around
    the system prompt S, byte tokenizer, 16-500 characters each) share
    on qwen3-8b. ``online_prefix_pages`` must count what those rows
    share, as serve 7 finds it before its split-decode check."""
    import numpy as np

    import chip_smoke
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS["qwen3-8b"]
    rng = np.random.default_rng(7)
    system = chip_smoke.online_system_prompt(rng, 1000)
    rows = ["".join(rng.choice(chip_smoke.ALPHABET, int(n)))
            for n in rng.integers(16, 501, 32)]
    prompts = encode_chat_batch(ByteTokenizer(vocab_size=mcfg.vocab_size), rows, system,
                                mcfg.chat_template)
    assert chip_smoke.online_prefix_pages() == 15
    assert len(chip_smoke.shared_head(prompts, 64)) == 15 * 64
