"""The host-side plans of the two redesigned kernels, on the CPU.

- The prefix carry's split plan (``prefix_carry.split_plan``): splits
  x tiles cover the prefix exactly once, no split is empty, the grid
  stays within one wave and a split walks at least ``MIN_TILES`` tiles;
  the serve's shapes get the plans the kernel was measured at.
- The kernel's decomposition along that plan, with plain PyTorch steps
  in place of the launch (as ``test_torch_paged_split.py`` does for
  paged decode): each split's partial carry is the plain carry over the
  split's pages, and their combine (max, rescale, sum) equals the plain
  carry and the reference's ``prefix_attention_carry``, for the plan's
  splits and for forced ones; float32, 2e-5 (summation order only).
- The grouped GEMM's launch, with a stub in place of the kernel: one
  kernel for every M, sized by the shapes alone, and the group sizes
  are never read on the host.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sutro_tpu.ops.pallas_paged import prefix_attention_carry as jax_carry
from sutro_tpu_torch.ops import grouped_matmul as gm
from sutro_tpu_torch.ops import prefix_carry as pc

TOL = 2e-5
N_SM = 132


@pytest.mark.parametrize("Pp,PS,B,G,KVH,Dh", [
    (16, 64, 64, 8, 4, 128),    # serve 2: qwen3-30b-a3b, 1,024-token template
    (64, 64, 64, 8, 4, 128),    # a 4,096-token template
    (64, 64, 64, 8, 8, 128),    # qwen3-32b's heads
    (1, 64, 13, 1, 2, 64), (3, 8, 4, 2, 2, 64), (100, 16, 2, 4, 1, 256),
    (64, 64, 1, 16, 2, 256), (7, 64, 500, 8, 4, 128), (2, 64, 64, 8, 4, 64),
])
def test_carry_split_plan(Pp, PS, B, G, KVH, Dh):
    per, n = pc.split_plan(Pp, PS, B, G, KVH, Dh, N_SM)
    tiles = math.ceil(Pp * PS / pc.TILE_TOKENS[Dh])
    assert per >= 1 and n >= 1
    assert per * n >= tiles and per * (n - 1) < tiles      # exactly once, none empty
    if n > 1:
        blocks = KVH * math.ceil(B * G / pc.QUERY_ROWS)
        assert blocks * n <= pc.BLOCKS_PER_SM * N_SM        # at most one wave
        assert per >= pc.MIN_TILES


def test_carry_split_plan_at_serve_shapes():
    assert pc.split_plan(16, 64, 64, 8, 4, 128, N_SM) == (4, 4)   # serve 2
    assert pc.split_plan(64, 64, 64, 8, 4, 128, N_SM) == (16, 4)  # 4,096-token template
    assert pc.split_plan(16, 64, 4, 8, 4, 128, N_SM)[1] > 2       # few rows: more splits


def _carry_case(rng, B, NH, KVH, Dh, PS, n_pfx):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    NP = 2 + n_pfx
    pages = np.concatenate([rng.permutation(np.arange(1, NP))[:n_pfx], [0, 0]]).astype(np.int32)
    Lp = n_pfx * PS
    pfx_len = np.where(np.arange(B) % 3 == 1, 0, Lp).astype(np.int32)
    pfx_len[2::3] = Lp - 5                                   # ends mid-page
    q_pos = (pfx_len + rng.integers(0, 40, B)).astype(np.int32)
    return (f(B, NH, Dh), f(NP, PS, KVH * Dh), f(NP, PS, KVH * Dh), pages, pfx_len, q_pos)


def _split_partials(q, kp, vp, pages, pfx_len, q_pos, window, per, n):
    """Split ``s`` of the plan carries prefix tokens ``[lo, lo + span)``,
    ``span = per`` tiles: the plain carry over those tokens' pages, with
    lengths and positions counted from ``lo``. Partials stacked ``[n, ...]``."""
    span = per * pc.TILE_TOKENS[q.shape[-1]]
    PS = kp.shape[1]
    assert span % PS == 0
    parts = []
    for s in range(n):
        lo = s * span
        parts.append(pc.prefix_attention_carry_plain(
            q, kp, vp, pages[lo // PS : (lo + span) // PS], torch.clamp(pfx_len - lo, min=0),
            q_pos - lo, window))
    return tuple(torch.stack(x) for x in zip(*parts))


def _combine(m, l, acc):
    """The kernel's combine: partial carries ``[S, ...]`` -> one carry, by
    max, rescale and sum (an all-empty row keeps the cold carry: its
    weights are 1 over l = acc = 0)."""
    mx = m.amax(0)
    w = torch.exp(m - mx)
    return mx, (w * l).sum(0), (w[..., None] * acc).sum(0)


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_carry_partials_combine_to_the_plain_carry_and_jax(window, Dh):
    """The plan's splits and forced ones (one tile each; one split)."""
    B, NH, KVH, PS, n_pfx = 7, 8, 2, 16, 9
    G = NH // KVH
    q, kp, vp, pages, pfx_len, q_pos = _carry_case(
        np.random.default_rng(Dh + window), B, NH, KVH, Dh, PS, n_pfx)
    t = lambda a, d=torch.float32: torch.as_tensor(np.array(a), dtype=d)  # noqa: E731
    args = (t(q), t(kp), t(vp), t(pages, torch.int32), t(pfx_len, torch.int32),
            t(q_pos, torch.int32), window)
    m_ref, l_ref, a_ref = (np.asarray(x) for x in jax_carry(
        *(jnp.asarray(x) for x in (q, kp, vp, pages, pfx_len, q_pos)),
        jnp.asarray(window, jnp.int32)))
    a_ref = a_ref.reshape(B, NH, KVH, Dh)[:, np.arange(NH), np.arange(NH) // G]
    m_p, l_p, a_p = pc.prefix_attention_carry_plain(*args)
    tiles = math.ceil(pages.shape[0] * PS / pc.TILE_TOKENS[Dh])
    plans = {pc.split_plan(pages.shape[0], PS, B, G, KVH, Dh, N_SM), (1, tiles), (tiles, 1)}
    for per, n in plans:
        m, l, a = _combine(*_split_partials(*args, per, n))
        live = l_p > 0
        for got, want in ((l, l_p), (a, a_p), (m[live], m_p[live])):
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(l.numpy(), l_ref, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(a.numpy(), a_ref, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(m.numpy()[live.numpy()], m_ref[live.numpy()],
                                   atol=TOL, rtol=TOL)
        outside = pfx_len == 0
        assert (m.numpy()[outside] == pc.NEG_INF).all()      # the cold carry
        assert (l.numpy()[outside] == 0).all() and (a.numpy()[outside] == 0).all()


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on the card."""
    is_cuda = True


class _DeviceSizes(_OnCard):
    """Group sizes that fail on any read of their values on the host."""
    def tolist(self):
        raise AssertionError("the wrapper read the group sizes on the host")

    item = numpy = cpu = __int__ = __index__ = __bool__ = __iter__ = tolist


@pytest.mark.parametrize("M", [1, 24, 512, 4095, 4096, 32768])
def test_grouped_matmul_launches_one_kernel_by_shape_alone(monkeypatch, M):
    """Decode steps (24, 512 rows) and prefills alike take the one
    kernel, its grid sized by M, H, F and E alone."""
    E, H, F = 128, 16, 24
    calls = []
    monkeypatch.setattr(gm.KERNEL, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(gm, "stream_handle", lambda device: None)
    lhs = torch.zeros((M, H), dtype=torch.bfloat16).as_subclass(_OnCard)
    rhs = torch.zeros((E, H, F), dtype=torch.bfloat16).as_subclass(_OnCard)
    gs = torch.zeros(E, dtype=torch.int32).as_subclass(_DeviceSizes)
    out = gm.grouped_matmul(lhs, rhs, gs)
    assert tuple(out.shape) == (M, F) and out.dtype == torch.bfloat16
    assert len(calls) == 1 and calls[0][4:8] == (M, H, F, E)
    assert calls[0][2].value == gs.data_ptr()   # the sizes go to the kernel as a pointer
