"""The PyTorch port's sampling against the JAX package.

The two frameworks draw different random numbers from the same seed, so
the draws are compared as distributions: greedy tokens and the kept set
of a top-k / top-p filter must be exactly the JAX package's, and the
port's draws must pass a chi-square test (p > 1e-3) against the exact
probabilities. Row-seeded draws must not depend on batch composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sutro_tpu.ops import sampling as js
from sutro_tpu_torch.ops import sampling as ts


def _logits(rng, B, V, scale=3.0):
    return (scale * rng.standard_normal((B, V))).astype(np.float32)


def test_greedy_is_exact_argmax_like_jax():
    rng = np.random.default_rng(0)
    lg = _logits(rng, 16, 1000)
    want = js.sample(jnp.asarray(lg), jax.random.PRNGKey(0), temperature=0.0, top_p=1.0)
    got = ts.sample(torch.as_tensor(lg), 0, temperature=0.0, top_p=1.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), lg.argmax(-1))


def _kept(probs_row, top_k, top_p):
    """The filter's kept set, computed in numpy from the contract."""
    order = np.argsort(-probs_row, kind="stable")
    p = probs_row[order]
    keep = (np.cumsum(p) - p) < top_p
    if top_k > 0:
        keep &= np.arange(len(p)) < top_k
    return set(order[keep].tolist())


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.6), (5, 0.8)])
def test_kept_set_matches_jax(top_k, top_p):
    """Both samplers draw exactly the filter's kept set: every kept
    token appears over many draws, and nothing else does."""
    rng = np.random.default_rng(1)
    V, N = 48, 3000
    row = np.linspace(8.0, 0.0, V).astype(np.float32)
    rng.shuffle(row)
    lg = np.broadcast_to(row, (N, V)).copy()
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    want = _kept(probs, top_k, top_p)
    assert 2 <= len(want) <= 8
    jax_draws = js.sample(
        jnp.asarray(lg), jax.random.PRNGKey(3), temperature=1.0,
        top_p=top_p, top_k=top_k,
    )
    got = ts.sample(torch.as_tensor(lg), 3, temperature=1.0, top_p=top_p, top_k=top_k)
    assert set(np.asarray(jax_draws).tolist()) == want
    assert set(got.numpy().tolist()) == want


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (0, 0.9), (4, 1.0)])
def test_draws_pass_chi_square(top_k, top_p):
    rng = np.random.default_rng(2)
    V, N = 12, 40000
    row = rng.standard_normal(V).astype(np.float32)
    probs = np.exp(row.astype(np.float64) - row.max())
    probs /= probs.sum()
    kept = sorted(_kept(probs, top_k, top_p))
    expect = np.zeros(V)
    expect[kept] = probs[kept] / probs[kept].sum()
    lg = torch.as_tensor(np.broadcast_to(row, (N, V)).copy())
    got = ts.sample(lg, 11, temperature=1.0, top_p=top_p, top_k=top_k).numpy()
    counts = np.bincount(got, minlength=V)
    assert counts[expect == 0].sum() == 0
    want = N * expect[kept] / expect[kept].sum()
    _, p = stats.chisquare(counts[kept], want)
    assert p > 1e-3, (counts, want)


def test_temperature_scales_the_distribution():
    rng = np.random.default_rng(3)
    V, N = 8, 40000
    row = rng.standard_normal(V).astype(np.float32)
    T = 0.5
    probs = np.exp(row.astype(np.float64) / T - (row / T).max())
    probs /= probs.sum()
    lg = torch.as_tensor(np.broadcast_to(row, (N, V)).copy())
    got = ts.sample(lg, 5, temperature=T, top_p=1.0).numpy()
    _, p = stats.chisquare(np.bincount(got, minlength=V), N * probs / probs.sum())
    assert p > 1e-3


def test_row_seeded_draws_ignore_batch_composition():
    rng = np.random.default_rng(4)
    V = 200
    lg = _logits(rng, 6, V, scale=1.0)
    seeds = [11, 12, 13, 14, 15, 16]
    kw = dict(temperature=1.0, top_p=0.95)
    full = ts.sample(torch.as_tensor(lg), 7, row_seeds=seeds, **kw).numpy()
    # rows 2 and 4 alone, in another order, beside other rows
    sub = ts.sample(
        torch.as_tensor(lg[[4, 0, 2]]), 7, row_seeds=[15, 99, 13], **kw
    ).numpy()
    assert sub[0] == full[4] and sub[2] == full[2]
    # and a different seed draws a different stream
    many = [
        int(ts.sample(torch.as_tensor(lg[:1]), 7, row_seeds=[s], **kw)[0])
        for s in range(40)
    ]
    assert len(set(many)) > 5


def test_keys_split_and_fold_deterministically():
    k1, s1 = ts.split_key(0)
    k2, s2 = ts.split_key(0)
    assert (k1, s1) == (k2, s2) and k1 != s1
    assert ts.fold_in(5, 1) != ts.fold_in(5, 2)
    assert all(0 <= k < 1 << 63 for k in (k1, s1, ts.fold_in(k1, 7)))


def test_cumulative_logprob_matches_jax():
    rng = np.random.default_rng(5)
    lg = _logits(rng, 4, 300)
    tok = np.array([0, 5, 299, 17], np.int32)
    want = js.cumulative_logprob(jnp.asarray(lg), jnp.asarray(tok))
    got = ts.cumulative_logprob(torch.as_tensor(lg), torch.as_tensor(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_apply_penalties_matches_jax():
    rng = np.random.default_rng(6)
    B, V, K = 3, 50, 4
    lg = _logits(rng, B, V)
    seen = rng.random((B, V)) < 0.2
    ids = np.array([[1, 7, -1, -1], [0, 49, 3, 3], [-1, -1, -1, -1]], np.int32)
    cnt = rng.integers(1, 4, (B, K)).astype(np.float32)
    pres = np.array([0.5, 0.0, 1.0], np.float32)
    freq = np.array([0.1, 0.3, 0.0], np.float32)
    rep = np.array([1.2, 1.0, 0.8], np.float32)
    want = js.apply_penalties(*(jnp.asarray(x) for x in (lg, seen, ids, cnt, pres, freq, rep)))
    got = ts.apply_penalties(*(torch.as_tensor(x) for x in (lg, seen, ids, cnt, pres, freq, rep)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_allowed_mask_restricts_draws():
    rng = np.random.default_rng(7)
    lg = _logits(rng, 200, 30)
    allowed = np.zeros((200, 30), bool)
    allowed[:, [3, 9, 21]] = True
    got = ts.sample(torch.as_tensor(lg), 1, temperature=1.0, top_p=0.9,
                    allowed=torch.as_tensor(allowed)).numpy()
    assert set(got.tolist()) <= {3, 9, 21}
