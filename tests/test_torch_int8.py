"""The PyTorch port's int8 path against the JAX package.

Same numpy-seeded inputs through both sides:

- weight quantization (``quantize_weight``, ``quantize_params``, and
  ``params_from_numpy`` of the reference's quantized tree) and the KV
  cache's per-token ``_quantize_tokens``: bit-identical int8 values and
  scales (the same float32 formulas, rounding half to even);
- ``write_kv`` then ``gather_kv_layer`` on an int8 pool: identical
  pages, scales and dequantized views (page 0 aside: the port drops
  tokens bound for the garbage page, the reference writes them there);
- ``paged_decode_attention`` over int8 pages (on the CPU its plain
  version) against the reference kernel in interpret mode with
  ``k_scale``/``v_scale``, as tests/test_kv_int8.py runs it: windows 0
  and 5, with and without a window buffer and a sink, and with the
  carry option from the reference's ``prefix_attention_carry(k_scale=)``;
  the port's int8 prefix carry against that function; the T > 1 gather
  path against the reference's ``chunk_attention``; float32, 2e-5
  (summation order only);
- the engine on ``tiny-dense`` in float32 with ``kv_quantize="int8"``,
  then with ``quantize="int8"`` too (fused windows of 4 and single
  steps, a prompt longer than ``prefill_chunk``, a 19-token shared head
  with ``prefix_split``): greedy token ids and finish reasons identical,
  cumulative logprobs within 1e-4; ``tiny-moe`` with int8 weights:
  identical greedy ids.

Also: the runner's own int8 init, its refusals of unknown modes, its
``device_info`` over int8 leaves and its page payloads. The
``cuda``-marked test holds the int8 kernel against its plain version on
the card (bfloat16 output rounding: atol = rtol = 2e-2) and skips
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.kvcache as jkv
import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
import sutro_tpu.ops.quant as jq
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jt
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.ops.attention import chunk_attention as jax_chunk_attention
from sutro_tpu.ops.pallas_paged import paged_decode_attention as jax_paged_decode
from sutro_tpu.ops.pallas_paged import prefix_attention_carry as jax_carry
from sutro_tpu_torch.engine import kvcache as tkv
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.models import transformer as tt
from sutro_tpu_torch.ops import attention
from sutro_tpu_torch.ops import paged_decode as pd
from sutro_tpu_torch.ops import prefix_carry as pc
from sutro_tpu_torch.ops import quant

TOL = 2e-5
LOGP_TOL = 1e-4
CUDA_TOL = 2e-2
B, NH, KVH, Dh, PS, MP, NP = 4, 4, 2, 16, 8, 6, 40
G = NH // KVH
KD = KVH * Dh
N_PFX = 3   # rows 0..2 share pages [1, 2, 3]


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)  # a writable copy


def _per_head(acc_bd):
    """The reference's block-diagonal [B, NH, KVH*Dh] acc -> [B, NH, Dh]."""
    a = np.asarray(acc_bd).reshape(B, NH, KVH, Dh)
    return a[:, np.arange(NH), np.arange(NH) // G]


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 20000), (3, 24, 40), (2, 4, 16, 8)])
def test_quantize_weight_matches_jax(shape):
    """A 2-D leaf wider than one column block (lm_head), a stacked layer
    leaf and a stacked expert leaf; a zero column takes the 1e-8 floor."""
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0
    want = jq.quantize_weight(w)
    got = quant.quantize_weight(_t(w))
    assert got["qw"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["qw"].numpy(), want["qw"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    # materialize: the reference's f32 product, rounded once
    deq = np.asarray(jq.materialize({k: jnp.asarray(v) for k, v in want.items()},
                                    jnp.float32))
    np.testing.assert_array_equal(quant.materialize(got, torch.float32).numpy(), deq)
    bf = quant.materialize(got, torch.bfloat16)
    assert torch.equal(bf, (got["qw"].float() * got["scale"]).to(torch.bfloat16))


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_quantize_params_matches_jax(name):
    """``quantize_params`` on both sides, and the reference's quantized
    tree through ``params_from_numpy``; ``params_bytes`` agrees."""
    cfg = MODEL_CONFIGS[name]
    p = jt.init_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
    want = jq.quantize_params(tree)
    got = quant.quantize_params(params_from_numpy(cfg, tree, "cpu", torch.float32))
    loaded = params_from_numpy(cfg, want, "cpu", torch.float32)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_want:
        keys = [k.key for k in path]
        g, ld = got, loaded
        for k in keys:
            g, ld = g[k], ld[k]
        np.testing.assert_array_equal(g.numpy(), leaf, err_msg=str(keys))
        np.testing.assert_array_equal(ld.numpy(), leaf, err_msg=str(keys))
        assert g.dtype == ld.dtype
    assert quant.params_bytes(got) == jq.params_bytes(want)
    for n, leaf in got["layers"].items():
        assert quant.is_quantized(leaf) == (n in quant.QUANT_LEAVES), n


def test_params_from_numpy_rejects_bad_quantized_leaf():
    cfg = MODEL_CONFIGS["tiny-dense"]
    tree = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32), jt.init_params(cfg, jax.random.PRNGKey(2))
    )
    q = jq.quantize_params(tree)
    q["layers"]["wq"]["scale"] = q["layers"]["wq"]["scale"][..., :-1]
    with pytest.raises(ValueError, match="wq.scale"):
        params_from_numpy(cfg, q, "cpu", torch.float32)
    q = jq.quantize_params(tree)
    q["layers"]["attn_norm"] = {"qw": q["layers"]["wq"]["qw"], "scale": q["layers"]["wq"]["scale"]}
    with pytest.raises(ValueError, match="attn_norm"):
        params_from_numpy(cfg, q, "cpu", torch.float32)


def test_quantize_tokens_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, KD)).astype(np.float32)
    x[0, 1, 2] = 0.0   # an all-zero token: the 1e-8 floor
    wq, ws = jkv._quantize_tokens(jnp.asarray(x))
    gq, gs = tkv._quantize_tokens(_t(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ---------------------------------------------------------------------------
# the int8 pool
# ---------------------------------------------------------------------------

MCFG = MODEL_CONFIGS["tiny-dense"]
ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", activation_dtype="float32",
    prefill_chunk=16,
)


@pytest.mark.parametrize("fused", [False, True])
def test_write_gather_int8_matches_jax(fused):
    """Two writes (a prefill chunk with a padded tail, then a window of 4
    decode tokens with an inactive row whose table is all page 0), then
    each layer's gather with dequantization."""
    L, KVHm, Dhm = MCFG.num_layers, MCFG.num_kv_heads, MCFG.head_dim
    KDm = KVHm * Dhm
    ecfg = dict(ENGINE, kv_quantize="int8")
    jc = jkv.alloc_cache(MCFG, JaxEngineConfig(use_pallas=False, **ecfg), 20)
    tc = tkv.alloc_cache(MCFG, EngineConfig(**ecfg), 20, torch.float32, "cpu")
    assert tc.quantized and tc.k_pages.dtype == torch.int8
    rng = np.random.default_rng(4)
    table = np.zeros((3, 16), np.int32)
    table[0, :3] = [1, 2, 3]
    table[1, :3] = [7, 5, 9]
    # row 2 inactive: its table is all page 0
    for Tc, start, valid in ((11, [0, 0, 0], [11, 6, 0]), (4, [11, 6, 0], [4, 4, 4])):
        shape = (L, 3, Tc, KDm) if fused else (L, 3, Tc, KVHm, Dhm)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        args = (table, np.array(start, np.int32), np.array(valid, np.int32))
        jc = jkv.write_kv(jc, jnp.asarray(k), jnp.asarray(v), *(jnp.asarray(a) for a in args))
        tkv.write_kv(tc, _t(k), _t(v), *(_t(a, torch.int32) for a in args))
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        np.testing.assert_array_equal(
            getattr(tc, name).numpy()[:, 1:], np.asarray(getattr(jc, name))[:, 1:], name)
    assert not tc.k_pages[:, 0].any() and not tc.k_scale[:, 0].any()  # page 0 untouched
    live = table[:2]
    for layer in range(L):
        want = jkv.gather_kv_layer(
            jc.k_pages[layer], jc.v_pages[layer], jnp.asarray(live), KVHm,
            k_scale_l=jc.k_scale[layer], v_scale_l=jc.v_scale[layer],
            out_dtype=jnp.float32)
        got = tkv.gather_kv_layer(
            tc.k_pages[layer], tc.v_pages[layer], _t(live, torch.int32), KVHm,
            tc.k_scale[layer], tc.v_scale[layer], out_dtype=torch.float32)
        ok = np.repeat(live > 0, 8, axis=1)        # tokens on pages >= 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[ok], np.asarray(w)[ok])


def test_unknown_kv_mode_raises():
    with pytest.raises(ValueError, match="kv_quantize"):
        tkv.alloc_cache(MCFG, EngineConfig(**ENGINE, kv_quantize="fp8"), 4,
                        torch.float32, "cpu")


# ---------------------------------------------------------------------------
# the paged-decode int8 option
# ---------------------------------------------------------------------------


def _case(rng):
    """int8 pools with per-token scales (quantized by the reference's
    own ``_quantize_tokens``); rows 0..2 share pages [1, 2, 3] at their
    table head, row 3 is outside the group."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    kq, ks = (np.asarray(a) for a in jkv._quantize_tokens(jnp.asarray(f(NP, PS, KD))))
    vq, vs = (np.asarray(a) for a in jkv._quantize_tokens(jnp.asarray(f(NP, PS, KD))))
    table = np.zeros((B, MP), np.int32)
    nxt = 4
    for b in range(B):
        n_own = MP - N_PFX if b < 3 else MP
        if b < 3:
            table[b, :N_PFX] = [1, 2, 3]
        table[b, MP - n_own:] = np.arange(nxt, nxt + n_own)
        nxt += n_own
    return dict(
        q=f(B, NH, Dh), k_cur=f(B, KVH, Dh), v_cur=f(B, KVH, Dh),
        k_pages=kq, v_pages=vq, k_scale=ks, v_scale=vs, table=table,
        past=np.array([N_PFX * PS + 5, N_PFX * PS + 11, N_PFX * PS + 2, 17], np.int32),
        pfx_len=np.array([N_PFX * PS] * 3 + [0], np.int32),
        pfx_cnt=np.array([N_PFX] * 3 + [0], np.int32),
        win_k=f(B, 4, KD), win_v=f(B, 4, KD), sink=f(NH),
    )


def _jax_args(c):
    return [jnp.asarray(c[k]) for k in
            ("q", "k_pages", "v_pages", "table", "past", "k_cur", "v_cur")]


def _port_args(c):
    return [_t(c["q"]), _t(c["k_pages"], torch.int8), _t(c["v_pages"], torch.int8),
            _t(c["table"], torch.int32), _t(c["past"], torch.int32), _t(c["k_cur"]),
            _t(c["v_cur"])]


def _win(c, W, win_len):
    if not W:
        return {}, {}
    return (dict(win_k=jnp.asarray(c["win_k"]), win_v=jnp.asarray(c["win_v"]),
                 win_len=jnp.asarray(win_len, jnp.int32)),
            dict(win_k=_t(c["win_k"]), win_v=_t(c["win_v"]), win_len=win_len))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("W,win_len", [(0, 0), (4, 3)])
@pytest.mark.parametrize("sink", [False, True])
def test_paged_decode_int8_matches_jax(window, W, win_len, sink):
    c = _case(np.random.default_rng(21))
    jwin, twin = _win(c, W, win_len)
    want = jax_paged_decode(
        *_jax_args(c), jnp.asarray(window, jnp.int32),
        jnp.asarray(c["sink"]) if sink else None, interpret=True, cross_row=False,
        k_scale=jnp.asarray(c["k_scale"]), v_scale=jnp.asarray(c["v_scale"]), **jwin,
    )
    got = pd.paged_decode_attention(
        *_port_args(c), window, _t(c["sink"]) if sink else None,
        k_scale=_t(c["k_scale"]), v_scale=_t(c["v_scale"]), **twin,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 7, 2])
def test_int8_prefix_carry_matches_jax(window):
    """The reference's XLA carry with scales; window=2 masks the whole
    prefix for every row."""
    c = _case(np.random.default_rng(23))
    q_pos = c["past"] + 1
    m_ref, l_ref, a_ref = jax_carry(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pages"]), jnp.asarray(c["v_pages"]),
        jnp.asarray([1, 2, 3], jnp.int32), jnp.asarray(c["pfx_len"]), jnp.asarray(q_pos),
        jnp.asarray(window, jnp.int32),
        k_scale=jnp.asarray(c["k_scale"]), v_scale=jnp.asarray(c["v_scale"]),
    )
    args = _port_args(c)
    m, l, a = pc.prefix_attention_carry(
        args[0], args[1], args[2], _t([1, 2, 3], torch.int32),
        _t(c["pfx_len"], torch.int32), _t(q_pos, torch.int32), window,
        _t(c["k_scale"]), _t(c["v_scale"]),
    )
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(a.numpy(), _per_head(a_ref), atol=TOL, rtol=TOL)
    live = np.asarray(l_ref) > 0
    np.testing.assert_allclose(m.numpy()[live], np.asarray(m_ref)[live], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("W,win_len", [(0, 0), (4, 3)])
def test_paged_decode_int8_with_carry_matches_jax(window, W, win_len):
    """The carry option over int8 pages, with a sink, started from the
    reference's int8 carry; and the port's carry + decode equals its
    decode over the full table."""
    c = _case(np.random.default_rng(29))
    q_pos = c["past"] + win_len
    jwin, twin = _win(c, W, win_len)
    jargs = _jax_args(c)
    jw = jnp.asarray(window, jnp.int32)
    jscale = dict(k_scale=jnp.asarray(c["k_scale"]), v_scale=jnp.asarray(c["v_scale"]))
    m0, l0, acc0 = jax_carry(jargs[0], jargs[1], jargs[2], jnp.asarray([1, 2, 3], jnp.int32),
                             jnp.asarray(c["pfx_len"]), jnp.asarray(q_pos), jw, **jscale)
    want = jax_paged_decode(
        *jargs, jw, jnp.asarray(c["sink"]), interpret=True, cross_row=False,
        pfx_cnt=jnp.asarray(c["pfx_cnt"]), m0=m0, l0=l0, acc0=acc0, **jscale, **jwin,
    )
    targs = _port_args(c)
    tscale = dict(k_scale=_t(c["k_scale"]), v_scale=_t(c["v_scale"]))
    carry = dict(pfx_cnt=_t(c["pfx_cnt"], torch.int32), m0=_t(m0),
                 l0=_t(l0), acc0=_t(_per_head(acc0)))
    got = pd.paged_decode_attention(*targs, window, _t(c["sink"]), **carry, **tscale, **twin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    groups = ((_t([1, 2, 3], torch.int32), _t(c["pfx_len"], torch.int32)),)
    kw = dict(positions=_t(q_pos[:, None], torch.int32), valid_len=torch.ones(B, dtype=torch.int32),
              past_k_pages=targs[1], past_v_pages=targs[2], past_k_scale=tscale["k_scale"],
              past_v_scale=tscale["v_scale"], page_table=targs[3], past_len=targs[4],
              window=window, sink=_t(c["sink"]), **twin)
    q, k, v = targs[0][:, None], targs[5][:, None], targs[6][:, None]
    split = attention.chunk_attention(q, k, v, pfx_groups=groups, **kw)
    full = attention.chunk_attention(q, k, v, **kw)
    np.testing.assert_allclose(split.numpy(), full.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(full.numpy()[:, 0], np.asarray(want), atol=TOL, rtol=TOL)


def test_chunk_attention_over_int8_past_matches_jax():
    """T > 1 over an int8 paged past: gather, dequantize, dense attention."""
    c = _case(np.random.default_rng(31))
    rng = np.random.default_rng(32)
    T = 5
    q = rng.standard_normal((B, T, NH, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    pos = c["past"][:, None] + np.arange(T)[None]
    valid = np.array([5, 3, 5, 1], np.int32)
    want = jax_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), positions=jnp.asarray(pos),
        valid_len=jnp.asarray(valid), past_k_pages=jnp.asarray(c["k_pages"]),
        past_v_pages=jnp.asarray(c["v_pages"]), past_k_scale=jnp.asarray(c["k_scale"]),
        past_v_scale=jnp.asarray(c["v_scale"]), page_table=jnp.asarray(c["table"]),
        past_len=jnp.asarray(c["past"]), window=jnp.asarray(0, jnp.int32), use_pallas=False,
    )
    args = _port_args(c)
    got = attention.chunk_attention(
        _t(q), _t(k), _t(v), positions=_t(pos, torch.int32), valid_len=_t(valid, torch.int32),
        past_k_pages=args[1], past_v_pages=args[2], past_k_scale=_t(c["k_scale"]),
        past_v_scale=_t(c["v_scale"]), page_table=args[3], past_len=args[4],
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_params():
    params = jt.init_params(MCFG, jax.random.PRNGKey(3), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    return params, params_from_numpy(MCFG, tree, "cpu", torch.float32)


def _prompts(shared: int = 0):
    """Several lengths, one longer than ``prefill_chunk``; with
    ``shared`` > 0 every row starts with the same ``shared`` tokens."""
    rng = np.random.default_rng(0)
    head = rng.integers(3, 500, shared).astype(np.int32)
    return [
        np.concatenate([head, rng.integers(3, 500, n).astype(np.int32)])
        for n in (5, 9, 40, 13, 2, 27, 1)
    ]


def _run(sched_mod, runner, requests):
    res = {}
    b = sched_mod.ContinuousBatcher(runner, stop_ids=[1])
    assert b.run(requests, on_result=lambda r: res.__setitem__(r.row_id, r)) == "completed"
    return res


def _requests(sched_mod, shared=0):
    return [
        sched_mod.GenRequest(row_id=i, prompt_ids=p, max_new_tokens=10 + i, temperature=0.0)
        for i, p in enumerate(_prompts(shared))
    ]


def _assert_same(got, want, logp=True):
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].token_ids == want[i].token_ids, i
        assert got[i].finish_reason == want[i].finish_reason, i
        if logp:
            assert got[i].cumulative_logprob == pytest.approx(
                want[i].cumulative_logprob, abs=LOGP_TOL, rel=LOGP_TOL)


@pytest.mark.parametrize("weights", [None, "int8"])
@pytest.mark.parametrize("multi_step,shared,split", [(4, 0, False), (1, 0, False),
                                                     (4, 19, True)])
def test_int8_engine_matches_jax_engine(shared_params, weights, multi_step, shared, split):
    jparams, tparams = shared_params
    ecfg = dict(ENGINE, kv_quantize="int8", quantize=weights, decode_multi_step=multi_step,
                prefix_split=split)
    jr = jax_runner.ModelRunner(MCFG, JaxEngineConfig(use_pallas=False, **ecfg), jparams)
    tr = t_runner.ModelRunner(MCFG, EngineConfig(**ecfg), tparams, device="cpu")
    assert tr.cache.quantized
    assert quant.is_quantized(tr.params["layers"]["wq"]) == (weights == "int8")
    want = _run(jax_sched, jr, _requests(jax_sched, shared))
    got = _run(t_sched, tr, _requests(t_sched, shared))
    _assert_same(got, want)


def test_int8_weights_moe_engine_matches_jax():
    cfg = MODEL_CONFIGS["tiny-moe"]
    p = jt.init_params(cfg, jax.random.PRNGKey(5), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
    ecfg = dict(ENGINE, quantize="int8", decode_multi_step=4)
    jr = jax_runner.ModelRunner(cfg, JaxEngineConfig(use_pallas=False, **ecfg), p)
    tr = t_runner.ModelRunner(cfg, EngineConfig(**ecfg),
                              params_from_numpy(cfg, tree, "cpu", torch.float32), device="cpu")
    assert quant.is_quantized(tr.params["layers"]["we_gate"])
    _assert_same(_run(t_sched, tr, _requests(t_sched)), _run(jax_sched, jr, _requests(jax_sched)),
                 logp=False)


def test_runner_int8_init_quantizes_slice_by_slice():
    """``params=None``: every QUANT_LEAVES leaf comes back int8 with its
    scales and no other leaf does, equal to quantizing the unquantized
    init drawn from the same seed."""
    ecfg = EngineConfig(**ENGINE, quantize="int8")
    runner = t_runner.ModelRunner(MCFG, ecfg, device="cpu")
    gen = torch.Generator().manual_seed(ecfg.seed)
    want = quant.quantize_params(tt.init_params(MCFG, gen, torch.float32, "cpu"))
    flat = {**{f"layers.{n}": x for n, x in runner.params["layers"].items()},
            **{n: x for n, x in runner.params.items() if n != "layers"}}
    for name, leaf in flat.items():
        ref = want["layers"][name[7:]] if name.startswith("layers.") else want[name]
        short = name.split(".")[-1]
        assert quant.is_quantized(leaf) == (short in quant.QUANT_LEAVES), name
        if quant.is_quantized(leaf):
            assert leaf["qw"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
            assert torch.equal(leaf["qw"], ref["qw"]) and torch.equal(leaf["scale"], ref["scale"])
        else:
            assert torch.equal(leaf, ref), name


@pytest.mark.parametrize("field", ["quantize", "kv_quantize"])
def test_unknown_mode_raises(shared_params, field):
    _, tparams = shared_params
    with pytest.raises(ValueError, match=field):
        t_runner.ModelRunner(MCFG, EngineConfig(**{**ENGINE, field: "int4"}), tparams,
                             device="cpu")


def test_device_info_counts_int8_leaves(shared_params):
    _, tparams = shared_params
    runner = t_runner.ModelRunner(
        MCFG, EngineConfig(**ENGINE, quantize="int8", kv_quantize="int8"), tparams,
        device="cpu")
    info = runner.device_info()
    leaves = jax.tree_util.tree_leaves(
        jq.quantize_params(jax.tree_util.tree_map(lambda x: x.numpy(), tparams)))
    assert info["param_bytes"] == sum(x.nbytes for x in leaves)
    assert info["n_params"] == sum(x.size for x in leaves)
    assert info["kv_dtype_bytes"] == 1


def test_int8_pages_round_trip_and_promote(shared_params):
    """An int8 pool's payload carries its scales and comes back exactly;
    written into a bfloat16-or-float pool it is dequantized."""
    _, tparams = shared_params
    q8 = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE, kv_quantize="int8"), tparams,
                              device="cpu")
    q8.cache.k_pages[:, 3] = 5
    q8.cache.v_pages[:, 3] = -7
    q8.cache.k_scale[:, 3] = 0.5
    q8.cache.v_scale[:, 3] = 0.25
    payload = q8.read_pages([3])
    assert payload["k"].dtype == np.int8 and payload["ks"].shape == (MCFG.num_layers, 1, 8)
    q8.write_pages([7], payload)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        t = getattr(q8.cache, name)
        assert torch.equal(t[:, 7], t[:, 3]), name
    plain = t_runner.ModelRunner(MCFG, EngineConfig(**ENGINE), tparams, device="cpu")
    plain.write_pages([2], payload)
    assert (plain.cache.k_pages[:, 2] == 2.5).all() and (plain.cache.v_pages[:, 2] == -1.75).all()


# ---------------------------------------------------------------------------
# the CUDA kernel vs its plain version (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh_", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 70])
def test_cuda_paged_decode_int8_matches_plain(cuda_device, Dh_, window):
    g = torch.Generator(device=cuda_device).manual_seed(Dh_ + window)
    bf = dict(device=cuda_device, dtype=torch.bfloat16, generator=g)
    Bc, NHc, KVHc, PSc, MPc, NPc, Wc = 24, 8, 2, 16, 12, 400, 4
    kq, ks = tkv._quantize_tokens(torch.randn((NPc, PSc, KVHc * Dh_), **bf))
    vq, vs = tkv._quantize_tokens(torch.randn((NPc, PSc, KVHc * Dh_), **bf))
    table = torch.arange(1, 1 + Bc * MPc, dtype=torch.int32, device=cuda_device).reshape(Bc, MPc)
    past = torch.randint(0, MPc * PSc, (Bc,), generator=g, device=cuda_device).to(torch.int32)
    q = torch.randn((Bc, NHc, Dh_), **bf)
    k_cur, v_cur = (torch.randn((Bc, KVHc, Dh_), **bf) for _ in range(2))
    win = dict(win_k=torch.randn((Bc, Wc, KVHc * Dh_), **bf),
               win_v=torch.randn((Bc, Wc, KVHc * Dh_), **bf), win_len=3)
    sink = torch.randn((NHc,), generator=g, device=cuda_device)
    args = (q, kq, vq, table, past, k_cur, v_cur, window, sink)
    before = pd.INT8.launches
    got = pd.paged_decode_attention(*args, k_scale=ks, v_scale=vs, **win)
    assert pd.INT8.launches == before + 1
    want = pd.paged_decode_plain(*args, k_scale=ks, v_scale=vs, **win)
    torch.testing.assert_close(got.float(), want.float(), atol=CUDA_TOL, rtol=CUDA_TOL)
