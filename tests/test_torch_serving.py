"""The port's serving tier (``serving/``) against the JAX package's.

- ``parse_request`` and the chunk and response builders agree with the
  JAX module on hypothesis-drawn bodies, the bad-request shapes too
  (the same ``ServingRequest`` or the same error message).
- Through both engines' gateways (``Sutro.chat`` on the local backend;
  both engines on the same tiny-dense checkpoint, each with its own
  ``SUTRO_HOME``): the same chat bodies give the same content, finish
  reason and usage; a stream's deltas equal the collected content; a
  constrained ``response_format`` stream equals the batch path's row; a
  disconnect frees the slot; a batch job running beside interactive
  requests gives the JAX engine's rows; the ``serving.admit`` fault is a
  503; a drain refuses new requests and lets the live ones finish.
"""

import json
import threading
import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sutro_tpu.engine import api as jax_api
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.constrain import cpp as jax_cpp
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.sdk import Sutro as JaxSutro
from sutro_tpu.serving import openai as jax_oai
from sutro_tpu_torch.engine import api, faults
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.sdk import Sutro
from sutro_tpu_torch.serving import openai as oai
from sutro_tpu_torch.serving.gateway import GatewayRejected
from tests.test_torch_api import ENGINE, _no_native_masks, wait
from tests.test_torch_weights_loader import write_hf_checkpoint

SERVING = dict(ENGINE, prefix_store=True, interactive_slots=2)


def engine_pair(tmp_path_factory, name: str, **extra):
    """Start (JAX engine, port engine) on the same tiny-dense
    checkpoint, each with its own ``SUTRO_HOME``; returns them with the
    ``MonkeyPatch`` that the caller undoes after closing both."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp(name)
    write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 9, root / "weights" / "tiny-dense")
    cfg = dict(SERVING, weights_dir=str(root / "weights"), **extra)
    mp.setattr(jax_cpp, "CppMasker", _no_native_masks)
    mp.setenv("SUTRO_MONITOR", "0")
    mp.setenv("SUTRO_HOME", str(root / "jax-home"))
    jeng = jax_api.LocalEngine(JaxEngineConfig(use_pallas=False, **cfg))
    mp.setenv("SUTRO_HOME", str(root / "port-home"))
    teng = api.LocalEngine(EngineConfig(**cfg), device="cpu")
    return jeng, teng, mp


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, teng, mp = engine_pair(tmp_path_factory, "torch-serving")
    yield jeng, teng
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def clients(engines):
    """(JAX client, port client) on the local backend over the engines."""
    jc, tc = JaxSutro(api_key="k"), Sutro(api_key="k")
    jc._engine, tc._engine = engines
    return jc, tc


def _body(prompt, **kw):
    return {"model": "tiny-dense", "messages": [{"role": "user", "content": prompt}],
            "temperature": 0.0, "max_tokens": 6, **kw}


# ---------------------------------------------------------------------
# request parsing and the builders
# ---------------------------------------------------------------------

_text = st.text(max_size=12)
_content = st.one_of(_text, st.lists(st.fixed_dictionaries(
    {"type": st.sampled_from(["text", "image"]), "text": _text}), max_size=2), st.integers())
_message = st.fixed_dictionaries(
    {"role": st.sampled_from(["user", "assistant", "system", "tool"]), "content": _content})
_schema = st.sampled_from([
    None, {"type": "text"}, {"type": "json_object"}, {"type": "xml"}, "json",
    {"type": "json_schema", "json_schema": {"name": "o", "schema": {
        "type": "object", "properties": {"a": {"type": "integer"}}, "required": ["a"]}}},
    {"type": "json_schema", "json_schema": {"schema": 3}},
])
_body_st = st.fixed_dictionaries({}, optional={
    "model": st.sampled_from(["tiny-dense", "", 3]),
    "messages": st.one_of(st.lists(_message, max_size=3), _text),
    "prompt": st.one_of(_text, st.lists(_text, max_size=2), st.integers()),
    "n": st.sampled_from([1, 2, None]),
    "max_tokens": st.one_of(st.integers(-2, 50), st.sampled_from(["7", "x"])),
    "max_completion_tokens": st.integers(1, 9),
    "temperature": st.one_of(st.floats(0, 2), st.sampled_from(["hot"])),
    "top_p": st.floats(0, 1), "top_k": st.integers(0, 50),
    "stop": st.one_of(_text, st.lists(_text, max_size=2), st.integers()),
    "seed": st.integers(0, 99), "stream": st.booleans(),
    "user": st.one_of(_text, st.integers()),
    "session_id": st.one_of(_text, st.integers()),
    "response_format": _schema,
})


def _parsed(mod, body, chat):
    try:
        return ("ok", vars(mod.parse_request(body, chat=chat)))
    except mod.BadServingRequest as e:
        return ("bad", str(e))


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(body=_body_st, chat=st.booleans())
def test_parse_request_matches_jax(body, chat):
    assert _parsed(oai, body, chat) == _parsed(jax_oai, body, chat)


@pytest.mark.parametrize("body", [[], "x", {"model": "m", "messages": []},
                                  {"model": "m", "messages": [{"role": "system", "content": "s"}]},
                                  {"model": "m", "prompt": ["a", "b"]}])
def test_bad_requests_match_jax(body):
    for chat in (True, False):
        got = _parsed(oai, body, chat)
        assert got[0] == "bad" and got == _parsed(jax_oai, body, chat)


@given(content=st.one_of(st.none(), _text), role=st.sampled_from([None, "assistant"]),
       finish=st.sampled_from([None, "stop", "length", "schema_complete", "cancelled"]),
       text=_text, p=st.integers(0, 99), c=st.integers(0, 99))
def test_builders_match_jax(content, role, finish, text, p, c):
    args = ("ivr-1", 1700000000, "tiny-dense")
    assert oai.chat_chunk(*args, content=content, role=role, finish_reason=finish) == \
        jax_oai.chat_chunk(*args, content=content, role=role, finish_reason=finish)
    assert oai.completion_chunk(*args, content=content, finish_reason=finish) == \
        jax_oai.completion_chunk(*args, content=content, finish_reason=finish)
    usage = oai.usage_dict(p, c)
    assert usage == jax_oai.usage_dict(p, c)
    for a, b in ((oai.chat_response, jax_oai.chat_response),
                 (oai.completion_response, jax_oai.completion_response)):
        assert a(*args, text, finish or "stop", usage) == b(*args, text, finish or "stop", usage)
    obj = oai.chat_chunk(*args, content=content)
    assert oai.sse_frame(obj) == jax_oai.sse_frame(obj)
    assert oai.sse_frame(None) == jax_oai.sse_frame(None) and oai.SSE_DONE == jax_oai.SSE_DONE


# ---------------------------------------------------------------------
# through both engines' gateways
# ---------------------------------------------------------------------


def _strip(resp):
    """A response without its per-engine id and time."""
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


@pytest.mark.parametrize("kw", [
    dict(system_prompt="Answer briefly."),
    dict(max_tokens=3, temperature=0.0),
    dict(stop=["a"], max_tokens=8),
    dict(messages=[{"role": "system", "content": "sys"}, {"role": "user", "content": "q1"},
                   {"role": "assistant", "content": "a1"}, {"role": "user", "content": "q2"}]),
])
def test_chat_bodies_give_the_jax_reply(engines, kw):
    jc, tc = clients(engines)
    kw = {"temperature": 0.0, "max_tokens": 6, **kw}
    messages = kw.pop("messages", "hello there, how are you")
    got, want = (c.chat(messages, model="tiny-dense", **kw) for c in (tc, jc))
    assert _strip(got) == _strip(want)
    assert got["choices"][0]["finish_reason"] in ("stop", "length")
    assert got["usage"]["completion_tokens"] >= 1


def test_stream_equals_collect(engines):
    jc, tc = clients(engines)
    chunks = list(tc.chat("stream me", model="tiny-dense", stream=True,
                          temperature=0.0, max_tokens=6))
    out = tc.chat("stream me", model="tiny-dense", temperature=0.0, max_tokens=6)
    deltas = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert deltas == out["choices"][0]["message"]["content"]
    finals = [c for c in chunks if c["choices"][0]["finish_reason"]]
    assert len(finals) == 1 and finals[0] is chunks[-1]
    jchunks = list(jc.chat("stream me", model="tiny-dense", stream=True,
                           temperature=0.0, max_tokens=6))
    assert [_strip(c) for c in chunks] == [_strip(c) for c in jchunks]


def test_a_stop_string_ends_the_stream_where_it_ends_the_reply(engines):
    """A stop string cuts the streamed deltas where it cuts the collected
    reply: text that may begin a stop string is held back until it does
    not. The stop strings come from the reply without one (printable
    ASCII: one byte token a character): a character new at its place;
    the first two-character run (held back a token); one that never
    completes (held back, then sent whole); and a list of two. The JAX
    package streams a stop string's text; its collected reply cuts it."""
    _, tc = clients(engines)
    kw = dict(model="tiny-dense", temperature=0.0, max_tokens=12)
    full = tc.chat("a b c", **kw)["choices"][0]["message"]["content"]
    ascii_ = lambda t: all(" " <= x <= "~" for x in t)  # noqa: E731
    at = next(i for i, x in enumerate(full) if i and ascii_(x) and x not in full[:i])
    two = next(full[i : i + 2] for i in range(len(full) - 1) if ascii_(full[i : i + 2]))
    cases = (([full[at]], full[:at]), ([two], full[: full.find(two)]),
             ([full[at] + "\x01"], full), (["\x01", full[at]], full[:at]))
    for stop, want in cases:
        out = tc.chat("a b c", stop=stop, **kw)["choices"][0]
        chunks = list(tc.chat("a b c", stop=stop, stream=True, **kw))
        deltas = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        assert (out["message"]["content"], deltas) == (want, want), stop
        finish = "stop" if want != full else "length"
        assert out["finish_reason"] == chunks[-1]["choices"][0]["finish_reason"] == finish


def test_constrained_stream_equals_the_batch_path(engines):
    _, teng = engines
    _, tc = clients(engines)
    schema = {"type": "object", "properties": {"a": {"type": "integer"}}, "required": ["a"]}
    chunks = list(tc.chat("give a number", model="tiny-dense", stream=True, max_tokens=24,
                          temperature=0.0, response_format={
                              "type": "json_schema", "json_schema": {"name": "o", "schema": schema}}))
    streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert isinstance(json.loads(streamed)["a"], int)
    jid = teng.submit_batch_inference({
        "model": "tiny-dense", "inputs": ["give a number"], "output_schema": schema,
        "sampling_params": {"temperature": 0.0, "max_new_tokens": 24}})
    assert wait(teng, jid) == "SUCCEEDED"
    assert teng.job_results(jid)["outputs"][0] == streamed


def test_a_disconnect_frees_the_slot(engines):
    _, teng = engines
    gw = teng.gateway
    ir = gw.submit(oai.parse_request(_body("bye", stream=True, max_tokens=64), chat=True))
    for ev in ir.channel.events():
        if ev is not None:
            break
    ir.channel.cancel()
    deadline = time.monotonic() + 60
    while gw.active_count() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert gw.active_count() == 0
    out = clients(engines)[1].chat("after", model="tiny-dense", temperature=0.0, max_tokens=4)
    assert out["choices"][0]["finish_reason"] in ("stop", "length")


def test_a_batch_job_beside_interactive_rows_gives_the_jax_rows(engines):
    payload = {"model": "tiny-dense", "inputs": [f"row {i} of the batch" for i in range(8)],
               "sampling_params": {"temperature": 0.0, "max_new_tokens": 10}}
    rows = []
    for eng, c in zip(engines, clients(engines)):
        jid = eng.submit_batch_inference(payload)
        replies = [None] * 4

        def hit(i, c=c, replies=replies):
            replies[i] = c.chat(f"q{i}", model="tiny-dense", temperature=0.0, max_tokens=4)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert wait(eng, jid) == "SUCCEEDED"
        assert all(r["usage"]["completion_tokens"] >= 1 for r in replies)
        rows.append((eng.job_results(jid)["outputs"],
                     [r["choices"][0]["message"]["content"] for r in replies]))
    assert rows[0] == rows[1]


def test_admit_fault_is_a_503(engines):
    _, teng = engines
    faults.configure("serving.admit:error:times=1")
    try:
        with pytest.raises(GatewayRejected) as e:
            teng.gateway.submit(oai.parse_request(_body("x"), chat=True))
        assert e.value.status == 503
    finally:
        faults.clear()
    out = clients(engines)[1].chat("x", model="tiny-dense", temperature=0.0, max_tokens=2)
    assert out["object"] == "chat.completion"


def test_drain_refuses_new_requests_and_finishes_live_ones(engines):
    _, teng = engines
    gw = teng.gateway
    ir = gw.submit(oai.parse_request(_body("live", max_tokens=8), chat=True))
    gw.begin_drain()
    try:
        with pytest.raises(GatewayRejected) as e:
            gw.submit(oai.parse_request(_body("late"), chat=True))
        assert e.value.status == 503
        assert teng.fleet_state()["draining"]
        assert oai.collect(ir, chat=True)["choices"][0]["finish_reason"] in ("stop", "length")
        assert gw.wait_idle(60)
    finally:
        gw.draining = False
    assert gw.active_count() == 0


def test_local_chat_needs_interactive_slots(tmp_path, monkeypatch):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path))
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    try:
        c = Sutro(api_key="k")
        c._engine = eng
        with pytest.raises(RuntimeError, match="interactive_slots"):
            c.chat("hi", model="tiny-dense")
    finally:
        assert eng.close(timeout=30)
