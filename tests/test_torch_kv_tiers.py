"""The port's KV tiers (``engine/kvtier.py``) against the JAX package's.

- The same payload demoted in both packages gives byte-equal int8
  values and scales, and the same dequantized values (float32 and
  bfloat16-valued pools; an int8 payload passes through).
- The same scripted sequence on both pools (host LRU over a page
  budget, spills to a disk tier, pinned rows, promotes, discards) gives
  the same answers, op census and tier sizes; torn demote, promote and
  disk-write faults behave alike, and a torn file on disk is
  quarantined.
- A batch row suspended for an interactive request hibernates through
  the tier and resumes token-identical to the JAX batcher with tiers
  on (float32 and int8 pools, on the same parameters); a chat
  session's third turn after ``checkpoint_idle`` promotes its history
  and replies as the JAX engine does; with tiers off the engine holds
  no pool and the tier runs no operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.kvtier as jax_kvtier
import sutro_tpu.engine.runner as jax_runner
from sutro_tpu.engine import faults as jax_faults
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.scheduler import ContinuousBatcher as JaxBatcher
from sutro_tpu.engine.scheduler import GenRequest as JaxGenRequest
from sutro_tpu.engine.scheduler import JobCtx as JaxJobCtx
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.serving import openai as jax_oai
from sutro_tpu_torch.engine import api, faults, kvtier
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.scheduler import ContinuousBatcher, GenRequest, JobCtx
from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.serving import openai as oai
from tests.test_torch_serving import engine_pair

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
              max_model_len=128, param_dtype="float32", activation_dtype="float32",
              interactive_slots=2)
PREFIX = "You are a terse classifier. Decide the sentiment of this: "
TAILS = ["great!", "bad movie", "meh", "totally awesome ride"]
TOK = ByteTokenizer(vocab_size=MCFG.vocab_size)


def _payload(n_pages=1, seed=0, L=2, PS=8, KD=4, bf16=False):
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal((L, n_pages, PS, KD)).astype(np.float32) for k in "kv"}
    if bf16:   # values a bfloat16 pool holds, as read_pages hands them over
        out = {k: torch.from_numpy(v).bfloat16().float().numpy() for k, v in out.items()}
    return out


def _equal(a, b):
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_payload_is_byte_equal_to_jax(seed, bf16):
    raw = _payload(n_pages=3, seed=seed, bf16=bf16)
    raw["k"][0, 0, 0] = 0.0   # an all-zero token hits the scale floor
    q, jq = kvtier.quantize_payload(raw), jax_kvtier.quantize_payload(raw)
    assert _equal(q, jq) and q["k"].dtype == np.int8 and q["ks"].dtype == np.float32
    assert _equal(kvtier.dequantize_payload(q, np.float32),
                  jax_kvtier.dequantize_payload(jq, np.float32))
    # the int8 round trip: within half a quantization step a token
    deq = kvtier.dequantize_payload(q, np.float32)
    for k in "kv":
        step = q[k + "s"][..., None]
        assert np.all(np.abs(deq[k] - raw[k]) <= step / 2 + 1e-7)
    assert kvtier.quantize_payload(q) is q   # int8 passes through
    assert t_runner.dequantize_payload is kvtier.dequantize_payload


def _script(mod, fault_mod, root, seed: int) -> list:
    """A seeded sequence of pool calls over a 3-page host budget and a
    disk tier; every answer is logged."""
    rng = np.random.default_rng(seed)
    pool = mod.KVTierPool(8, host_pages=3, disk_dir=root / "disk")
    log = []
    keys = [mod.KVTierPool.prefix_key(np.arange(8 * (i + 1), dtype=np.int32))
            for i in range(6)]
    try:
        for step in range(40):
            op = int(rng.integers(6))
            key = keys[int(rng.integers(len(keys)))]
            if op == 0:
                pool.put_page(key, _payload(seed=step))
            elif op == 1:
                pool.put_row(b"row-" + key, _payload(n_pages=2, seed=step))
            elif op == 2:
                got = pool.get_page(key)
                log.append(("get", None if got is None else {
                    k: v.tobytes() for k, v in got.items()}))
            elif op == 3:
                got = pool.take_row(b"row-" + key)
                log.append(("take", None if got is None else got["k"].tobytes()))
            elif op == 4:
                pool.discard([key])
            else:
                pool.request_demote(np.arange(int(rng.integers(1, 30)), dtype=np.int32))
                log.append(("demote_req", [a.tolist() for a in pool.pop_demote_requests()]))
            assert pool.drain(10)
            log.append((op, pool.pages("host"), pool.pages("disk"), pool.op_census()))
        log.append(("budget", pool.set_host_budget(1), pool.pages("host"), pool.pages("disk")))
        assert pool.drain(10)
        log.append(("files", sorted(p.name for p in (root / "disk").glob("*.npz"))))
    finally:
        pool.close(timeout=5)
    # the disk tier outlives the pool
    pool2 = mod.KVTierPool(8, disk_dir=root / "disk")
    try:
        log.append(("reopened", pool2.pages("disk"),
                    [pool2.get_page(k) is not None for k in keys]))
    finally:
        pool2.close(timeout=5)
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_tier_decisions_match_jax(seed, tmp_path):
    got = _script(kvtier, faults, tmp_path / "port", seed)
    want = _script(jax_kvtier, jax_faults, tmp_path / "jax", seed)
    assert got == want


def _torn(mod, fault_mod, root, site: str) -> tuple:
    pool = mod.KVTierPool(8, host_pages=1, disk_dir=root)
    raw_a, raw_b = _payload(seed=50), _payload(seed=51)
    try:
        if site == "kvtier.demote":
            fault_mod.configure("kvtier.demote:error")
            pool.put_page(b"a", raw_a)
            assert pool.drain(10)
            with pytest.raises(Exception):
                pool.put_row(b"r", raw_b)   # the caller keeps its pages
            out = (pool.get_page(b"a"), pool.take_row(b"r"))
        elif site == "kvtier.promote":
            pool.put_page(b"a", raw_a)
            assert pool.drain(10)
            fault_mod.configure("kvtier.promote:error:times=1")
            first = pool.get_page(b"a")          # retried once: lands
            fault_mod.configure("kvtier.promote:error")
            second = pool.get_page(b"a")         # torn twice: a miss
            fault_mod.clear()
            out = (first, second, pool.get_page(b"a"))
        else:
            fault_mod.configure("kvtier.disk_write:torn")
            pool.put_page(b"a", raw_a)
            assert pool.drain(10)
            pool.put_page(b"b", raw_b)   # forces the torn spill of a
            assert pool.drain(10)
            out = (pool.pages("disk"), pool.get_page(b"a"), pool.get_page(b"b"))
    finally:
        fault_mod.clear()
        census = pool.op_census()
        pool.close(timeout=5)
    # a later pool quarantines whatever torn bundle the run left
    pool2 = mod.KVTierPool(8, disk_dir=root)
    corrupt = sorted(p.name for p in (root / ".corrupt").glob("*.npz"))
    pool2.close(timeout=5)
    norm = [None if o is None else o if isinstance(o, int) else
            {k: v.tobytes() for k, v in o.items()} for o in out]
    return norm, census, corrupt


@pytest.mark.parametrize("site", ["kvtier.demote", "kvtier.promote", "kvtier.disk_write"])
def test_torn_migrations_match_jax(site, tmp_path):
    got = _torn(kvtier, faults, tmp_path / "port", site)
    assert got == _torn(jax_kvtier, jax_faults, tmp_path / "jax", site)
    if site == "kvtier.disk_write":
        assert got[2], "the torn bundle is quarantined"
    if site == "kvtier.demote":
        assert got[0] == [None, None] and got[1]["dropped"] == 1


def test_a_torn_file_on_disk_is_quarantined(tmp_path):
    pool = kvtier.KVTierPool(8, host_pages=1, disk_dir=tmp_path)
    pool.put_page(b"a", _payload(seed=1))
    pool.put_page(b"b", _payload(seed=2))
    assert pool.drain(10)
    pool.close(timeout=5)
    bundle = pool._disk_path(b"a")
    bundle.write_bytes(bundle.read_bytes()[:40])
    pool2 = kvtier.KVTierPool(8, disk_dir=tmp_path)
    try:
        assert pool2.get_page(b"a") is None and pool2.get_page(b"b") is not None
        assert [p.name for p in (tmp_path / ".corrupt").iterdir()] == [bundle.name]
    finally:
        pool2.close(timeout=5)


# ---------------------------------------------------------------------
# hibernation through the batcher
# ---------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "int8"])
def runners(request):
    """(JAX runner, port runner) of tiny-dense on the same parameters,
    over a float32 or an int8 KV pool."""
    kw = dict(ENGINE, kv_quantize="int8") if request.param == "int8" else ENGINE
    params = jax_transformer.init_params(MCFG, jax.random.PRNGKey(12), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    jr = jax_runner.ModelRunner(MCFG, JaxEngineConfig(use_pallas=False, **kw), params=params)
    tr = t_runner.ModelRunner(MCFG, EngineConfig(**kw),
                              params_from_numpy(MCFG, tree, "cpu", torch.float32),
                              device="cpu")
    return jr, tr


def _preempt(runner, tier, jax_side: bool):
    """A 4-row batch job fills every slot; an interactive request
    arrives mid-flight and suspends a row inside the
    ``interactive_slots`` budget. Returns (batch rows, chat row, batch
    ctx, batcher)."""
    make, ctx, batcher = ((JaxGenRequest, JaxJobCtx, JaxBatcher) if jax_side
                          else (GenRequest, JobCtx, ContinuousBatcher))
    b = batcher(runner, stop_ids=TOK.stop_ids(), kv_tier=tier)
    got, igot, done = {}, {}, []
    reqs = [make(row_id=i, prompt_ids=np.array(TOK.encode(PREFIX + t), np.int32),
                 max_new_tokens=24, temperature=0.0) for i, t in enumerate(TAILS)]
    bctx = ctx(job_id="batch", pending=reqs, priority=1, seq=0,
               on_result=lambda r: got.__setitem__(r.row_id, list(r.token_ids)))
    ictx = ctx(job_id="chat", priority=-1, seq=1, interactive=True,
               pending=[make(row_id=100, prompt_ids=np.array(TOK.encode("quick probe"), np.int32),
                             max_new_tokens=4, temperature=0.0)],
               on_result=lambda r: igot.__setitem__(r.row_id, list(r.token_ids)))
    handed = []

    def poll_new():
        if not handed and bctx.stats.get("out", 0) > 8:
            handed.append(True)
            return ictx
        return None

    assert b.run_multi([bctx], on_job_done=lambda c, o: done.append((c.job_id, o)),
                       poll_new=poll_new) == "completed"
    assert handed and dict(done) == {"batch": "completed", "chat": "completed"}
    return got, igot, bctx, b


def test_a_suspended_row_resumes_token_identical_to_jax(runners):
    jr, tr = runners
    pool = kvtier.KVTierPool(8, host_pages=256)
    jpool = jax_kvtier.KVTierPool(8, host_pages=256)
    try:
        got, igot, bctx, b = _preempt(tr, pool, jax_side=False)
        jgot, jigot, jbctx, jb = _preempt(jr, jpool, jax_side=True)
        assert (got, igot) == (jgot, jigot)
        assert bctx.stats.get("resumes_upload", 0) >= 1
        assert bctx.stats.get("resumes_upload") == jbctx.stats.get("resumes_upload")
        assert (b.tier_demotes, b.tier_promotes) == (jb.tier_demotes, jb.tier_promotes)
        assert b.tier_demotes > 0 and pool.op_census() == jpool.op_census()
        assert pool.pages("host") == 0 and b._hibernated == {}
    finally:
        pool.close(timeout=5)
        jpool.close(timeout=5)


# ---------------------------------------------------------------------
# a chat session through both engines' gateways
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, teng, mp = engine_pair(tmp_path_factory, "torch-kv-tiers", kv_tiers=True,
                                 kv_tier_disk=False)
    yield jeng, teng
    jeng.close(timeout=30)
    assert teng.close(timeout=30)
    mp.undo()


def _turn(eng, mod, prompt, session):
    body = {"model": "tiny-dense", "temperature": 0.0, "max_tokens": 6, "session_id": session,
            "messages": [{"role": "system", "content": PREFIX}, {"role": "user", "content": prompt}]}
    out = mod.collect(eng.gateway.submit(mod.parse_request(body, chat=True)), chat=True)
    return out["choices"][0]["message"]["content"], out["usage"]


def test_a_hibernated_chat_session_replies_as_jax(engines):
    replies = []
    for eng, mod in zip(engines, (jax_oai, oai)):
        r = [_turn(eng, mod, "first question", "s1"), _turn(eng, mod, "second one", "s1")]
        assert eng.gateway.checkpoint_idle(0.0) >= 1
        r.append(_turn(eng, mod, "and a third", "s1"))
        replies.append(r)
    assert replies[0] == replies[1]
    (_, u1), (_, u2), (_, u3) = replies[1]
    assert u2["prompt_tokens"] > u1["total_tokens"] and u3["prompt_tokens"] > u2["total_tokens"]
    tier = engines[1]._kv_tiers["tiny-dense"]
    assert tier.drain(10)
    census = tier.op_census()
    assert census["promotes"] >= 1, census
    assert engines[1]._prefix_stores["tiny-dense"].hits >= 2


def test_with_tiers_off_no_tier_runs(monkeypatch, tmp_path):
    monkeypatch.setenv("SUTRO_HOME", str(tmp_path))
    ops = []
    for name in ("put_page", "put_row", "get_page", "take_row", "request_demote"):
        real = getattr(kvtier.KVTierPool, name)
        monkeypatch.setattr(kvtier.KVTierPool, name,
                            lambda self, *a, _r=real, _n=name, **k: (ops.append(_n), _r(self, *a, **k))[1])
    eng = api.LocalEngine(EngineConfig(**ENGINE), device="cpu")
    try:
        assert eng._kv_tier_for("tiny-dense") is None
        for turn in ("one", "two"):
            _turn(eng, oai, turn, "s-off")
        assert eng.gateway.checkpoint_idle(0.0) == 0
        _turn(eng, oai, "three", "s-off")
        assert eng._kv_tiers == {} and ops == []
        monkeypatch.setenv("SUTRO_KV_TIERS", "1")
        assert eng._kv_tier_for("tiny-dense") is not None
        monkeypatch.setenv("SUTRO_KV_TIERS", "off")
        assert eng._kv_tier_for("tiny-dense") is None
    finally:
        assert eng.close(timeout=30)
