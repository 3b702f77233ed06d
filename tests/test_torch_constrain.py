"""Constrained decoding in the PyTorch port against the JAX package.

- ``engine/constrain``: along a seeded walk through each schema (those
  of ``tests/test_constrain.py`` and serve 4's two of ``chip_smoke.py``),
  the port's budget-filtered masks, ``token_allowed``,
  ``plan_fastforward`` plans and ``constraint_room`` equal the JAX
  package's; the native and Python mask cores agree, also at Qwen3's
  151,936-entry vocabulary, where only the byte ids may ever be allowed.
- The runner's speculative and verify methods on ``tiny-dense``, under
  the same pages: ``verify_greedy`` and ``verify_candidates`` give the
  JAX runner's tokens exactly and its logprobs within 1e-5;
  ``decode_window`` at temperature 0, with and without ``allowed0``,
  likewise; after ``commit_window`` with mixed accepted counts (and
  after the verify forwards), ``read_pages`` equals the JAX runner's.
- The engine: greedy schema-constrained rows through
  ``ContinuousBatcher`` are token-identical to the JAX engine on
  ``tiny-dense`` (with a prompt at the context limit, truncated by the
  same ``constraint_room``), ``tiny-moe``, with ``prefix_split``, with
  int8 pages, and with ``spec_ngram_draft=4`` beside repetitive
  unconstrained greedy rows; sampled constrained rows are all valid.
- ``chip_smoke.py``'s classify schema and system prompt (the port's
  classify template builds them) equal what the reference classify
  template builds.

float32 parameters carried across with ``params_from_numpy``; the JAX
side runs its plain path (``use_pallas=False``) and its Python mask
core (its native core takes ~30 s to load serve 4's classify schema;
the port's two cores are held against each other instead).
"""

import json
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
from sutro_tpu.common import normalize_output_schema
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.engine.constrain import fsm as jax_fsm
from sutro_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from sutro_tpu.models import transformer as jt
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.constrain import fsm as t_fsm
from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
from sutro_tpu_torch.engine.weights import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

sys.path.remove(str(ROOT))
CLASSIFY_SYSTEM_PROMPT, CLASSIFY_SCHEMA = chip_smoke.classify_job()

LOGP_TOL = 1e-5
V = 512  # the tiny models' vocabulary: ids 267.. carry no bytes
ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=32, decode_batch_size=4,
    max_model_len=256, param_dtype="float32", decode_multi_step=4,
    prefill_chunk=16,
)

SCHEMAS = {
    "integer": {"type": "object", "properties": {"x": {"type": "integer"}},
                "required": ["x"]},
    "string": {"type": "object", "properties": {"s": {"type": "string"}},
               "required": ["s"]},
    "bool_array": {"type": "object",
                   "properties": {"t": {"type": "array", "items": {"type": "boolean"}}},
                   "required": ["t"]},
    "number_enum_optional": {"type": "object",
                             "properties": {"a": {"type": "number"},
                                            "b": {"enum": ["x", "y"]}},
                             "required": ["b"]},
    "nested_anyof": {"type": "object",
                     "properties": {
                         "sub": {"type": "object", "properties": {"x": {"type": "integer"}},
                                 "required": ["x"]},
                         "opt": {"anyOf": [{"type": "integer"}, {"type": "null"}]}},
                     "required": ["sub"]},
    "string_length": {"type": "object",
                      "properties": {"s": {"type": "string", "minLength": 2, "maxLength": 4}},
                      "required": ["s"]},
    "pattern": {"type": "object",
                "properties": {"id": {"type": "string", "pattern": r"^[A-Z]{2}\d{2}$"}},
                "required": ["id"]},
    "integer_bounds": {"type": "object",
                       "properties": {"n": {"type": "integer", "minimum": -7, "maximum": 130}},
                       "required": ["n"]},
    "recursive_allof_map": {
        "$defs": {"N": {"type": "object",
                        "properties": {
                            "v": {"allOf": [{"type": "integer", "minimum": 0},
                                            {"maximum": 20}]},
                            "kids": {"type": "array", "items": {"$ref": "#/$defs/N"}},
                            "tags": {"type": "object",
                                     "additionalProperties": {"type": "boolean"},
                                     "maxProperties": 2}},
                        "required": ["v"]}},
        "$ref": "#/$defs/N"},
    "classify": CLASSIFY_SCHEMA,
    "extract": chip_smoke.EXTRACT_SCHEMA,
}


@pytest.fixture(autouse=True)
def jax_python_masks(monkeypatch):
    """The JAX package's masks from its Python core (see above)."""

    def unavailable(*a, **k):
        raise OSError("the JAX side's native mask core is not used here")

    monkeypatch.setattr(jax_cpp, "CppMasker", unavailable)


def _walk(schema, vocab, seed, steps=48, budget=40):
    """The JAX and the port FSMs of ``schema`` driven by the same seeded
    token choices (random allowed tokens under a shrinking budget):
    masks, single-token checks and fast-forward plans compared at every
    step. Returns the port FSM and the states it visited."""
    jf = jax_fsm.schema_constraint_factory(schema, JaxByteTokenizer(vocab_size=vocab))
    tf = t_fsm.schema_constraint_factory(schema, ByteTokenizer(vocab_size=vocab))
    assert t_fsm.constraint_room(tf()) == jax_fsm.constraint_room(jf())
    j, t = jf(), tf()
    rng = np.random.default_rng(seed)
    never = np.setdiff1d(tf.table.empty_ids, tf.table.stop_ids)
    states = []
    for step in range(steps):
        remaining = max(budget - step, 1)
        states.append(t.states)
        tm = t.allowed_tokens(remaining=remaining)
        np.testing.assert_array_equal(tm, j.allowed_tokens(remaining=remaining))
        assert not tm[never].any(), "an id with no bytes was allowed"
        tp, jp = t.plan_fastforward(remaining, 16, 32), j.plan_fastforward(remaining, 16, 32)
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert tp[0] == jp[0]
            assert len(tp[1]) == len(jp[1])
            for a, b in zip(tp[1], jp[1]):
                np.testing.assert_array_equal(a, b)
        if t.is_complete():
            break
        tok = int(rng.choice(np.flatnonzero(tm)))
        probe = int(rng.integers(0, vocab))
        assert t.token_allowed(probe, remaining) == j.token_allowed(probe, remaining)
        t.advance(tok)
        j.advance(tok)
        assert t.is_complete() == j.is_complete()
    return tf, states


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_masks_plans_and_room_match_jax(name):
    _walk(SCHEMAS[name], V, zlib.crc32(name.encode()))


@pytest.mark.parametrize("name", ["number_enum_optional", "recursive_allof_map", "classify",
                                  "extract"])
def test_native_and_python_mask_cores_agree(name):
    tf, states = _walk(SCHEMAS[name], V, zlib.crc32(name.encode()) + 1)
    if tf.masks.core != "native":
        pytest.skip("the native mask core did not build (no C++ toolchain)")
    for st in states:
        m_py, d_py = tf.masks._compute(st)
        m_cc, d_cc = tf.masks._cpp.mask(st)
        np.testing.assert_array_equal(m_py, m_cc)
        np.testing.assert_array_equal(d_py, d_cc)


def test_qwen3_vocabulary_masks():
    """At Qwen3's 151,936 ids the byte tokenizer gives bytes to 256 of
    them: every other id (the specials but the stop id) is never
    allowed, and both mask cores agree at each state of a short walk."""
    vocab = MODEL_CONFIGS["qwen3-30b-a3b"].vocab_size
    tf = t_fsm.schema_constraint_factory(CLASSIFY_SCHEMA,
                                         ByteTokenizer(vocab_size=vocab))
    fsm = tf()
    rng = np.random.default_rng(0)
    for _ in range(6):
        m, d = tf.masks.mask_and_dist(fsm.states)
        assert m.shape == (vocab,) and not m[256:].any()
        if tf.masks.core == "native":
            m_py, d_py = tf.masks._compute(fsm.states)
            np.testing.assert_array_equal(m, m_py)
            np.testing.assert_array_equal(d, d_py)
        fsm.advance(int(rng.choice(np.flatnonzero(m))))


def test_chip_smoke_classify_schema_is_the_templates():
    from sutro_tpu.templates.classification import ClassificationTemplates

    class Capture(ClassificationTemplates):
        def __init__(self):
            self.seen = {}

        def infer(self, data, **kw):
            self.seen.update(kw)
            return None  # no job: classify returns before awaiting one

    c = Capture()
    assert c.classify(["some text"], list(chip_smoke.CLASSIFY_LABELS)) is None
    assert normalize_output_schema(c.seen["output_schema"]) == CLASSIFY_SCHEMA
    assert c.seen["system_prompt"] == CLASSIFY_SYSTEM_PROMPT


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def _params(name, seed=3):
    cfg = MODEL_CONFIGS[name]
    p = jt.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
    return p, params_from_numpy(cfg, tree, "cpu", torch.float32)


@pytest.fixture(scope="module")
def dense_params():
    return _params("tiny-dense")


MCFG = MODEL_CONFIGS["tiny-dense"]
PROMPT_LENS = (11, 5, 20, 0)  # the last slot is a padding row


def _prefilled(dense_params):
    """Both runners with the same rows prefilled into the same pages;
    returns (jax runner, port runner, last tokens, past, table)."""
    jparams, tparams = dense_params
    jr = jax_runner.ModelRunner(MCFG, JaxEngineConfig(use_pallas=False, **ENGINE), jparams)
    tr = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE), tparams, device="cpu")
    rng = np.random.default_rng(7)
    B, MP = ENGINE["decode_batch_size"], ENGINE["max_pages_per_seq"]
    table = np.zeros((B, MP), np.int32)
    last = np.zeros((B,), np.int32)
    past = np.zeros((B,), np.int32)
    for b, n in enumerate(PROMPT_LENS):
        if not n:
            continue
        table[b, :5] = 1 + 5 * b + np.arange(5)
        prompt = rng.integers(3, 256, n).astype(np.int32)
        want, got = jr.prefill(prompt, table[b]), tr.prefill(prompt, table[b])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        last[b], past[b] = int(np.argmax(want)), n
    return jr, tr, last, past, table


def _same_pages(jr, tr):
    ids = list(range(1, 1 + 5 * len(PROMPT_LENS)))
    want, got = jr.read_pages(ids), tr.read_pages(ids)
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], np.asarray(want[key], np.float32),
                                   atol=1e-5, rtol=1e-5)


def _drafts(rng, K=3):
    B = len(PROMPT_LENS)
    return rng.integers(3, 256, (B, K)).astype(np.int32), np.array([3, 0, 2, 0], np.int32)


def test_verify_greedy_matches_jax(dense_params):
    jr, tr, last, past, table = _prefilled(dense_params)
    drafts, dlen = _drafts(np.random.default_rng(1))
    want = jr.verify_greedy(last, drafts, dlen, past, table)
    got = tr.verify_greedy(last, drafts, dlen, past, table)
    live = np.array(PROMPT_LENS) > 0
    np.testing.assert_array_equal(got[0][live], want[0][live])
    np.testing.assert_allclose(got[1][live], want[1][live], atol=LOGP_TOL, rtol=LOGP_TOL)
    _same_pages(jr, tr)


def test_verify_candidates_matches_jax(dense_params):
    jr, tr, last, past, table = _prefilled(dense_params)
    rng = np.random.default_rng(2)
    drafts, dlen = _drafts(rng)
    B, C, M = len(PROMPT_LENS), 4, 6
    cand = rng.integers(0, V, (B, C, M)).astype(np.int32)
    cand_n = rng.integers(0, M + 1, (B, C)).astype(np.int32)
    cand_n[0, 0] = 1   # a singleton: the forced token itself
    want = jr.verify_candidates(last, drafts, dlen, cand, cand_n, past, table)
    got = tr.verify_candidates(last, drafts, dlen, cand, cand_n, past, table)
    live = np.array(PROMPT_LENS) > 0
    for g, w, exact in zip(got, want, (True, False, True, False)):
        if exact:
            np.testing.assert_array_equal(g[live], w[live])
        else:
            np.testing.assert_allclose(g[live], w[live], atol=LOGP_TOL, rtol=LOGP_TOL)
    assert got[0][0, 0] == cand[0, 0, 0]
    _same_pages(jr, tr)


@pytest.mark.parametrize("masked", [False, True])
def test_decode_window_and_commit_match_jax(dense_params, masked):
    jr, tr, last, past, table = _prefilled(dense_params)
    B, steps = len(PROMPT_LENS), 4
    allowed0 = None
    if masked:
        allowed0 = np.random.default_rng(3).random((B, V)) < 0.05
        allowed0[:, 7] = True
    temp, top_p = np.zeros((B,), np.float32), np.ones((B,), np.float32)
    jt_, jl, jh = jr.decode_window(last, past, table, jax.random.PRNGKey(0), temp, top_p,
                                   steps, allowed0=allowed0)
    tt, tl, th = tr.decode_window(last, past, table, 0, temp, top_p, steps,
                                  allowed0=allowed0)
    live = np.array(PROMPT_LENS) > 0
    np.testing.assert_array_equal(tt[:, live], np.asarray(jt_)[:, live])
    np.testing.assert_allclose(tl[:, live], np.asarray(jl)[:, live], atol=LOGP_TOL,
                               rtol=LOGP_TOL)
    if masked:
        assert allowed0[np.arange(B), tt[0]].all()
    accepted = np.array([0, 2, steps, 0], np.int32)
    jr.commit_window(jh, accepted)
    tr.commit_window(th, accepted)
    _same_pages(jr, tr)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _rows(sched_mod, factories, n_rows=6, shared=0, repetitive=0, at_limit=False,
          **sampling):
    """Constrained rows alternating between the factories' schemas;
    ``repetitive`` more unconstrained greedy rows whose prompts repeat a
    short phrase (n-gram drafts find matches); with ``at_limit`` the
    first row's prompt fills the whole context."""
    rng = np.random.default_rng(0)
    head = rng.integers(3, 250, shared).astype(np.int32)
    lens = [5, 9, 30, 13, 2, 27][:n_rows]
    if at_limit:
        lens[0] = ENGINE["max_model_len"]
    reqs = []
    for i, n in enumerate(lens):
        prompt = np.concatenate([head, rng.integers(3, 250, n).astype(np.int32)])
        reqs.append(sched_mod.GenRequest(
            row_id=i, prompt_ids=prompt, max_new_tokens=72,
            constraint_factory=factories[i % len(factories)], **sampling))
    for i in range(repetitive):
        phrase = rng.integers(3, 250, 4).astype(np.int32)
        reqs.append(sched_mod.GenRequest(
            row_id=100 + i, prompt_ids=np.tile(phrase, 6), max_new_tokens=112,
            temperature=0.0))
    return reqs


def _serve(sched_mod, runner, reqs, stop_ids):
    res = {}
    b = sched_mod.ContinuousBatcher(runner, stop_ids=stop_ids)
    assert b.run(reqs, on_result=lambda r: res.__setitem__(r.row_id, r)) == "completed"
    return res, b


def _factories(fsm_mod, tok):
    return [fsm_mod.schema_constraint_factory(CLASSIFY_SCHEMA, tok),
            fsm_mod.schema_constraint_factory(chip_smoke.EXTRACT_SCHEMA, tok)]


# (model, engine fields, rows): two waves of rows on tiny-dense, one
# wave of 4 elsewhere
ENGINE_CASES = {
    "dense_context_limit": ("tiny-dense", {}, dict(at_limit=True)),
    "moe": ("tiny-moe", {}, dict(n_rows=4)),
    "prefix_split": ("tiny-dense", dict(prefix_split=True), dict(shared=19, n_rows=4)),
    "int8_pages": ("tiny-dense", dict(kv_quantize="int8"), dict(n_rows=4)),
    "spec_ngram": ("tiny-dense", dict(spec_ngram_draft=4), dict(n_rows=3, repetitive=3)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_greedy_constrained_rows_match_jax_engine(dense_params, case):
    model, extra, shape = ENGINE_CASES[case]
    mcfg = MODEL_CONFIGS[model]
    jparams, tparams = dense_params if model == "tiny-dense" else _params(model, seed=5)
    ecfg = dict(ENGINE, **extra)
    jtok, ttok = JaxByteTokenizer(vocab_size=V), ByteTokenizer(vocab_size=V)
    jr = jax_runner.ModelRunner(mcfg, JaxEngineConfig(use_pallas=False, **ecfg), jparams)
    tr = t_runner.ModelRunner(mcfg, EngineConfig(**ecfg), tparams, device="cpu")
    tfac = _factories(t_fsm, ttok)
    calls = {}
    for name in ("decode_window", "verify_candidates", "verify_greedy"):
        def counted(*a, _fn=getattr(tr, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            calls[_name + "_with_groups"] = calls.get(_name + "_with_groups", 0) + bool(
                k.get("pfx"))
            return _fn(*a, **k)
        setattr(tr, name, counted)
    want, jb = _serve(jax_sched, jr, _rows(jax_sched, _factories(jax_fsm, jtok),
                                           temperature=0.0, **shape), jtok.stop_ids())
    got, tb = _serve(t_sched, tr, _rows(t_sched, tfac, temperature=0.0, **shape),
                     ttok.stop_ids())
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].token_ids == want[i].token_ids, i
        assert got[i].finish_reason == want[i].finish_reason, i
        assert got[i].input_tokens == want[i].input_tokens, i
        assert got[i].cumulative_logprob == pytest.approx(
            want[i].cumulative_logprob, abs=1e-4, rel=1e-4)
        if i < 100:
            schema = (CLASSIFY_SCHEMA, chip_smoke.EXTRACT_SCHEMA)[i % 2]
            assert chip_smoke.schema_errors(schema, ttok.decode(got[i].token_ids)) == [], i
    assert (tb.ff_forced, tb.spec_drafted, tb.spec_accepted) == (
        jb.ff_forced, jb.spec_drafted, jb.spec_accepted)
    assert tb.ff_forced > 0
    assert calls["decode_window"] > 0 and calls["verify_candidates"] > 0, calls
    if case == "prefix_split":
        assert calls["decode_window_with_groups"] > 0, calls
    if case == "dense_context_limit":
        room = t_fsm.constraint_room(tfac[0]())
        assert got[0].input_tokens == ENGINE["max_model_len"] - room
    if case == "spec_ngram":
        assert tb.spec_accepted > 0 and calls["verify_greedy"] > 0


def test_sampled_constrained_rows_are_valid(dense_params):
    _, tparams = dense_params
    tok = ByteTokenizer(vocab_size=V)
    tr = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE), tparams, device="cpu")
    reqs = _rows(t_sched, _factories(t_fsm, tok), temperature=0.7, top_p=0.9)
    got, _ = _serve(t_sched, tr, reqs, tok.stop_ids())
    assert len(got) == len(reqs)
    for i, r in got.items():
        assert r.finish_reason == "schema_complete", (i, r.finish_reason)
        schema = (CLASSIFY_SCHEMA, chip_smoke.EXTRACT_SCHEMA)[i % 2]
        assert chip_smoke.schema_errors(schema, tok.decode(r.token_ids)) == [], i
    json.loads(tok.decode(got[0].token_ids))
