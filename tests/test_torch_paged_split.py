"""The paged-decode kernel's split-K decomposition, on the CPU.

The kernel cuts each row's key range at the points of
``paged_decode.split_plan``, computes one partial (m, l, acc) per
split and merges them with the carry as one more partial and the sink
once. ``split_partials_plain`` and ``merge_partials_plain`` are those
two steps in PyTorch; here their composition is held against
``paged_decode_plain`` and against the JAX reference
(``pallas_paged.paged_decode_attention`` in interpret mode), float32,
to 2e-5 (summation order only).

Cases: bf16-valued and int8 pages (with per-token scales); with and
without sink, sliding window, window slots and the carry; rows with a
past of 0, of exactly one split, and one whose window starts just
before a split boundary, so the boundary lies inside the window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sutro_tpu.engine import kvcache as jkv
from sutro_tpu.ops.pallas_paged import paged_decode_attention as jax_paged_decode
from sutro_tpu_torch.ops import paged_decode as pd

TOL = 2e-5
B, NH, KVH, Dh, PS, MP = 4, 4, 2, 16, 16, 16
G = NH // KVH
KD = KVH * Dh
NP = 1 + B * MP
N_SM = 132
W = 4


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def test_split_plan_is_static_and_covers_the_table():
    """Whole 64-token tiles, enough splits to cover the table, more of
    them for fewer rows, and the serve shapes' plans."""
    for mp, ps, b, kvh in [(16, 16, 4, 2), (32, 64, 64, 8), (130, 64, 64, 8),
                           (24, 64, 64, 4), (1, 8, 1, 1), (0, 64, 3, 2)]:
        split, n = pd.split_plan(mp, ps, b, kvh, N_SM)
        assert split % pd.SPLIT_TILE == 0 and n >= 1
        assert split * n >= mp * ps and split * (n - 1) < max(mp * ps, 1)
    assert pd.split_plan(130, 64, 8, 8, N_SM)[1] > pd.split_plan(130, 64, 64, 8, N_SM)[1]
    assert pd.split_plan(32, 64, 64, 8, N_SM) == (512, 4)      # qwen3-8b / qwen3-32b
    assert pd.split_plan(24, 64, 64, 4, N_SM) == (192, 8)      # qwen3-30b-a3b


def _case(rng, int8):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if int8:
        kp, ks = (np.asarray(a) for a in jkv._quantize_tokens(jnp.asarray(f(NP, PS, KD))))
        vp, vs = (np.asarray(a) for a in jkv._quantize_tokens(jnp.asarray(f(NP, PS, KD))))
    else:  # values a bf16 pool holds
        kp, vp = (_t(f(NP, PS, KD)).bfloat16().float().numpy() for _ in range(2))
        ks = vs = None
    table = np.zeros((B, MP), np.int32)
    table[:] = np.arange(1, NP).reshape(B, MP)
    # past 0; exactly one split (64 tokens); 70, whose window of 13 starts
    # at 58 + win_len, before the boundary at 64; a long row
    past = np.array([0, 64, 70, 250], np.int32)
    m0 = f(B, NH)
    l0 = np.abs(f(B, NH)) * 5 + 0.5
    acc0 = f(B, NH, Dh) * 3
    pfx = np.array([0, 2, 1, 3], np.int32)  # shared pages each row skips
    m0[pfx == 0], l0[pfx == 0], acc0[pfx == 0] = -1e30, 0.0, 0.0  # the cold carry
    return dict(q=f(B, NH, Dh), k_pages=kp, v_pages=vp, k_scale=ks, v_scale=vs, table=table,
                past=past, k_cur=f(B, KVH, Dh), v_cur=f(B, KVH, Dh), win_k=f(B, W, KD),
                win_v=f(B, W, KD), sink=f(NH), pfx=pfx, m0=m0, l0=l0, acc0=acc0)


def _block_diag(acc):
    """[B, NH, Dh] per-head acc -> the reference's [B, NH, KVH*Dh]."""
    out = np.zeros((B, NH, KD), np.float32)
    for n in range(NH):
        out[:, n, (n // G) * Dh : (n // G + 1) * Dh] = acc[:, n]
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("win_len", [None, 3])
@pytest.mark.parametrize("carry", [False, True])
def test_split_merge_matches_plain_and_jax(int8, window, sink, win_len, carry):
    c = _case(np.random.default_rng(5 + int8), int8)
    split, n_splits = pd.split_plan(MP, PS, B, KVH, N_SM)
    assert (split, n_splits) == (64, 4)  # so the cases above hit the boundaries they name
    page_dtype = torch.int8 if int8 else torch.float32
    targs = [_t(c["q"]), _t(c["k_pages"], page_dtype), _t(c["v_pages"], page_dtype),
             _t(c["table"], torch.int32), _t(c["past"], torch.int32), _t(c["k_cur"]),
             _t(c["v_cur"])]
    kw = dict(window=window)
    jkw = {}
    if win_len is not None:
        kw.update(win_k=_t(c["win_k"]), win_v=_t(c["win_v"]), win_len=win_len)
        jkw.update(win_k=jnp.asarray(c["win_k"]), win_v=jnp.asarray(c["win_v"]),
                   win_len=jnp.asarray(win_len, jnp.int32))
    if int8:
        kw.update(k_scale=_t(c["k_scale"]), v_scale=_t(c["v_scale"]))
        jkw.update(k_scale=jnp.asarray(c["k_scale"]), v_scale=jnp.asarray(c["v_scale"]))
    carry_kw = {}
    if carry:
        carry_kw = dict(m0=_t(c["m0"]), l0=_t(c["l0"]), acc0=_t(c["acc0"]))
        jkw.update(pfx_cnt=jnp.asarray(c["pfx"]), m0=jnp.asarray(c["m0"]),
                   l0=jnp.asarray(c["l0"]), acc0=jnp.asarray(_block_diag(c["acc0"])))
    tsink = _t(c["sink"]) if sink else None

    m, l, acc = pd.split_partials_plain(
        *targs, split, n_splits, pfx_cnt=_t(c["pfx"], torch.int32) if carry else None, **kw)
    got = pd.merge_partials_plain(m, l, acc, sink=tsink, **carry_kw)

    plain = pd.paged_decode_plain(
        *targs, sink=tsink, pfx_cnt=_t(c["pfx"], torch.int32) if carry else None,
        **carry_kw, **kw)
    want = jax_paged_decode(
        *[jnp.asarray(c[k]) for k in ("q", "k_pages", "v_pages", "table", "past", "k_cur",
                                      "v_cur")],
        jnp.asarray(window, jnp.int32), jnp.asarray(c["sink"]) if sink else None,
        interpret=True, cross_row=False, **jkw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # a split with nothing to walk is the empty partial; the current
    # token is always in some split
    assert ((l == 0) <= (m <= -1e29)).all()
    assert (l.sum(0) > 0).all()
