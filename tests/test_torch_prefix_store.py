"""The port's radix prefix store (``engine/prefixstore.py``) against the
JAX package's.

- The same scripted sequence of ``lookup_pin`` / ``extend`` /
  ``release`` / ``evict`` / ``demote`` / ``promote`` / ``peek`` /
  ``close`` on both stores gives the same page ids, hits, evictions and
  counters (seeded random scripts).
- Through ``ContinuousBatcher`` on ``tiny-dense`` (both packages' runners
  on the same parameters): a second job with the same shell prefills
  only its tail, with outputs token-identical to the JAX batcher with
  its store on and to the port without a store; co-batched jobs share
  the store's pages; a resume after a yield on a fresh batcher; the
  ``prefixstore.lookup`` fault degrades to a miss; ``close`` returns
  every page; and the engine's ``SUTRO_PREFIX_STORE`` kill switch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.runner as jax_runner
from sutro_tpu.engine import faults as jax_faults
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.prefixstore import PrefixStore as JaxPrefixStore
from sutro_tpu.engine.scheduler import ContinuousBatcher as JaxBatcher
from sutro_tpu.engine.scheduler import GenRequest as JaxGenRequest
from sutro_tpu.engine.scheduler import JobCtx as JaxJobCtx
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine import api, faults
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.prefixstore import PrefixStore
from sutro_tpu_torch.engine.scheduler import ContinuousBatcher, GenRequest, JobCtx
from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
from sutro_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_api import wait

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
              max_model_len=128, param_dtype="float32", activation_dtype="float32")
PREFIX = "You are a terse classifier. Decide the sentiment of this: "
TAILS = ["great!", "bad movie", "meh", "totally awesome ride"]


@pytest.fixture(scope="module")
def runners():
    """(JAX runner, port runner) of tiny-dense on the same parameters."""
    params = jax_transformer.init_params(MCFG, jax.random.PRNGKey(11), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    jr = jax_runner.ModelRunner(MCFG, JaxEngineConfig(use_pallas=False, **ENGINE),
                                params=params)
    tr = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE),
                              params_from_numpy(MCFG, tree, "cpu", torch.float32),
                              device="cpu")
    return jr, tr


TOK = ByteTokenizer(vocab_size=MCFG.vocab_size)


def _reqs(make=GenRequest, tails=TAILS, **kw):
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("temperature", 0.0)
    return [make(row_id=i, prompt_ids=np.array(TOK.encode(PREFIX + t), np.int32), **kw)
            for i, t in enumerate(tails)]


def _port(runner, store=None):
    return ContinuousBatcher(runner, stop_ids=TOK.stop_ids(), prefix_store=store)


def _jax(runner, store=None):
    return JaxBatcher(runner, stop_ids=TOK.stop_ids(), prefix_store=store)


def _run(b, reqs, **kw):
    res = {}
    out = b.run(reqs, on_result=lambda r: res.__setitem__(r.row_id, r), **kw)
    return out, {i: list(r.token_ids) for i, r in res.items()}


# ---------------------------------------------------------------------
# the tree, scripted on both stores
# ---------------------------------------------------------------------


def _script(store, seed: int) -> list:
    """A seeded sequence of store calls; every answer is logged."""
    rng = np.random.default_rng(seed)
    PS = store.page_size
    heads = [rng.integers(1, 50, 6 * PS).astype(np.int32) for _ in range(3)]
    log, handles, next_page = [], [], [1]

    def seq():
        h = heads[int(rng.integers(len(heads)))]
        n = int(rng.integers(PS, len(h) + 1))
        return h[:n]

    for _ in range(60):
        op = int(rng.integers(7))
        if op in (0, 1):   # lookup, then extend the rest of the page run
            toks = seq()
            h = store.lookup_pin(toks)
            log.append(("lookup", h.pages, h.tokens))
            tail = toks[h.tokens:(len(toks) // PS) * PS]
            n = len(tail) // PS
            pages = list(range(next_page[0], next_page[0] + n))
            ok = store.extend(h, tail, pages)
            if ok:
                next_page[0] += n
            log.append(("extend", ok, h.pages, h.tokens))
            handles.append(h)
        elif op == 2 and handles:
            store.release(handles.pop(int(rng.integers(len(handles)))))
            log.append(("release",))
        elif op == 3:
            log.append(("evict", store.evict(int(rng.integers(1, 4)))))
        elif op == 4:
            log.append(("peek", store.peek(seq())))
        elif op == 5:
            pairs = store.demote(int(rng.integers(1, 3)))
            log.append(("demote", [(len(k), p) for k, p in pairs]))
            for key, page in pairs[:1]:  # re-graft one demoted leaf
                toks = np.frombuffer(key, np.int32)
                h = store.lookup_pin(toks[:-PS])
                ok = (h.tokens == len(toks) - PS
                      and store.promote(h, toks[h.tokens:], [page]))
                log.append(("promote", ok, h.pages))
                store.release(h)
        else:
            log.append(("owned", sorted(store.owned_pages()), store.n_pages))
        log.append(("counters", store.hits, store.misses, store.evictions,
                    store.tokens_saved, store.demotions, store.promotions))
    for h in handles:
        store.release(h)
    log.append(("evict_all", sorted(store.evict(10_000))))
    store.close()
    log.append(("closed", store.lookup_pin(heads[0]).tokens, store.peek(heads[0]),
                store.owned_pages(), store.extend(store.empty_handle(), heads[0][:8], [99])))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scripted_sequence_matches_jax(seed):
    assert _script(PrefixStore(8), seed) == _script(JaxPrefixStore(8), seed)


def test_extend_checks_its_page_count():
    for cls in (PrefixStore, JaxPrefixStore):
        s = cls(4)
        with pytest.raises(ValueError):
            s.extend(s.empty_handle(), np.arange(8, dtype=np.int32), [1])
        with pytest.raises(ValueError):
            cls(0)


# ---------------------------------------------------------------------
# through the batcher
# ---------------------------------------------------------------------


def test_second_job_prefills_its_tail_only_token_identical(runners):
    jr, tr = runners
    store = PrefixStore(8)
    b1 = _port(tr, store)
    pristine = b1.free_page_count
    _, r1 = _run(b1, _reqs())
    paid1 = b1.prefill_tokens
    assert store.n_pages > 0 and b1.free_page_count == pristine - store.n_pages
    b2 = _port(tr, store)
    assert b2.free_page_count == pristine - store.n_pages
    _, r2 = _run(b2, _reqs())
    assert b2.prefill_tokens <= paid1 / 2, (paid1, b2.prefill_tokens)
    assert store.hits >= 1 and store.tokens_saved > 0
    # the JAX batcher with its own store, twice; the port without one
    jstore = JaxPrefixStore(8)
    _, j1 = _run(_jax(jr, jstore), _reqs(JaxGenRequest))
    jb2 = _jax(jr, jstore)
    _, j2 = _run(jb2, _reqs(JaxGenRequest))
    _, r_off = _run(_port(tr), _reqs())
    assert r1 == r2 == j1 == j2 == r_off
    assert (store.hits, store.tokens_saved, store.n_pages) == (
        jstore.hits, jstore.tokens_saved, jstore.n_pages)
    assert b2.prefill_tokens == jb2.prefill_tokens


def _cobatch(runner, store, jax_side=False):
    make, ctx, batcher = ((JaxGenRequest, JaxJobCtx, _jax) if jax_side
                          else (GenRequest, JobCtx, _port))
    b = batcher(runner, store)
    got = {"A": {}, "B": {}}
    st = b.run_multi(
        [ctx(job_id="A", pending=_reqs(make),
             on_result=lambda r: got["A"].__setitem__(r.row_id, list(r.token_ids)),
             priority=1, seq=0),
         ctx(job_id="B", pending=_reqs(make, tails=["x", "yy", "zzz"]),
             on_result=lambda r: got["B"].__setitem__(r.row_id, list(r.token_ids)),
             priority=1, seq=1)],
        on_job_done=lambda c, o: None,
    )
    assert st == "completed"
    return got, b


def test_cobatched_jobs_share_the_stores_pages(runners):
    jr, tr = runners
    store = PrefixStore(8)
    on, b_on = _cobatch(tr, store)
    off, b_off = _cobatch(tr, None)
    jon, jb = _cobatch(jr, JaxPrefixStore(8), jax_side=True)
    assert on == off == jon
    assert b_on.prefill_tokens < b_off.prefill_tokens
    assert b_on.prefill_tokens == jb.prefill_tokens
    assert store.hits >= 1
    assert store.evict(10_000), "both jobs done: every page is unpinned"


def test_resume_after_a_yield_on_a_fresh_batcher(runners):
    jr, tr = runners
    store = PrefixStore(8)
    b1 = _port(tr, store)
    pristine = b1.free_page_count
    out, _ = _run(b1, _reqs(), should_yield=lambda: True)
    assert out == "yielded"
    assert b1.free_page_count == pristine - store.n_pages
    out, r2 = _run(_port(tr, store), _reqs())
    assert out == "completed" and set(r2) == set(range(len(TAILS)))
    _, j = _run(_jax(jr, JaxPrefixStore(8)), _reqs(JaxGenRequest))
    assert r2 == j


def test_lookup_fault_degrades_to_a_miss(runners):
    _, tr = runners
    store = PrefixStore(8)
    _, warm = _run(_port(tr, store), _reqs())
    faults.configure("prefixstore.lookup:error")
    try:
        b = _port(tr, store)
        out, faulted = _run(b, _reqs())
        assert out == "completed"
        assert b.prefill_tokens > 0   # the shell was prefilled again
        assert store.misses == 1 and store.hits == 0
    finally:
        faults.clear()
    assert faulted == warm
    assert jax_faults.ACTIVE is None


def test_close_returns_every_page(runners):
    _, tr = runners
    store = PrefixStore(8)
    b1 = _port(tr, store)
    pristine = b1.free_page_count
    _run(b1, _reqs())
    assert store.n_pages > 0
    store.close()
    b2 = _port(tr, store)
    assert b2.free_page_count == pristine
    out, res = _run(b2, _reqs())
    assert out == "completed" and len(res) == len(TAILS)
    assert b2.free_page_count == pristine
    # a store of another page size is detached: nothing reserved
    b3 = _port(tr, PrefixStore(16))
    assert b3.free_page_count == pristine


def test_engine_kill_switch(monkeypatch, tmp_path):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path))
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    try:
        for off in ("0", "off", "false"):
            monkeypatch.setenv("SUTRO_PREFIX_STORE", off)
            assert eng._prefix_store_for("tiny-dense") is None
        monkeypatch.delenv("SUTRO_PREFIX_STORE")
        store = eng._prefix_store_for("tiny-dense")
        assert store is not None and eng._prefix_store_for("tiny-dense") is store
        assert eng.prefix_warm_tokens("no-such-key", [1, 2, 3]) == 0
        eng2 = api.LocalEngine(EngineConfig(prefix_store=False, **ENGINE), device="cpu")
        assert eng2._prefix_store_for("tiny-dense") is None
        monkeypatch.setenv("SUTRO_PREFIX_STORE", "1")
        assert eng2._prefix_store_for("tiny-dense") is not None
        assert eng2.close(timeout=30)
    finally:
        assert eng.close(timeout=30)
    assert store.lookup_pin(np.arange(16, dtype=np.int32)).tokens == 0  # closed


def test_engine_jobs_share_the_store(monkeypatch, tmp_path):
    """A second job with the same system prompt hits the engine's store,
    and its outputs equal the first's."""
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path))
    eng = api.LocalEngine(EngineConfig(max_new_tokens=8, **ENGINE), device="cpu")
    try:
        outs = []
        for _ in range(2):
            jid = eng.submit_batch_inference({
                "model": "tiny-dense", "inputs": TAILS, "system_prompt": PREFIX * 2,
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 6}})
            assert wait(eng, jid) == "SUCCEEDED", eng.get_job(jid)
            outs.append(eng.job_results(jid)["outputs"])
        store = eng._prefix_stores["tiny-dense"]
        assert store.hits >= 1 and store.tokens_saved >= 8
        assert outs[0] == outs[1]
    finally:
        assert eng.close(timeout=30)
