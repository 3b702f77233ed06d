"""The PyTorch port's attention against the JAX package.

Same inputs, made from numpy seeds, go through both sides:

- ``chunk_attention`` (port) vs ``chunk_attention`` (JAX, plain path):
  prefill, paged decode with a fused-window buffer, T > 1 over paged
  past, sliding windows and sinks; float32, to 2e-5 (summation order
  only).
- each kernel module's plain version vs the JAX Pallas kernel in
  interpret mode, at the shapes of tests/test_pallas_kernels.py:
  paged decode and flash prefill to 2e-5; the KV page write exactly on
  pages >= 1 (page 0 is the garbage page).

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card (bfloat16, atol = rtol = 2e-2, the output rounding) and skip
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sutro_tpu.ops.attention import chunk_attention as jax_chunk_attention
from sutro_tpu.ops.pallas_flash import flash_prefill as jax_flash_prefill
from sutro_tpu.ops.pallas_kv import kv_write_pallas
from sutro_tpu.ops.pallas_paged import paged_decode_attention as jax_paged_decode
from sutro_tpu_torch.ops import flash_prefill as fp
from sutro_tpu_torch.ops import kv_write as kw
from sutro_tpu_torch.ops import paged_decode as pd
from sutro_tpu_torch.ops.attention import chunk_attention

TOL = 2e-5  # float32 on both sides; only the summation order differs


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)  # a writable copy


def _decode_case(rng, *, B=3, NH=4, KVH=2, Dh=16, PS=8, MP=6, NP=32, W=0):
    """tests/test_pallas_kernels.py::_make_decode_case shapes, plus an
    optional fused-window buffer of W slots."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    table = np.zeros((B, MP), np.int32)
    for b in range(B):
        table[b] = np.arange(1 + b * MP, 1 + (b + 1) * MP)
    return dict(
        q=f(B, 1, NH, Dh), k_cur=f(B, 1, KVH, Dh), v_cur=f(B, 1, KVH, Dh),
        k_pages=f(NP, PS, KVH * Dh), v_pages=f(NP, PS, KVH * Dh),
        table=table, past=rng.integers(1, MP * PS - W, B).astype(np.int32),
        win_k=f(B, W, KVH * Dh), win_v=f(B, W, KVH * Dh), sink=f(NH),
    )


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("with_sink", [False, True])
@pytest.mark.parametrize("T", [1, 37])
def test_chunk_attention_prefill_matches_jax(window, with_sink, T):
    rng = np.random.default_rng(7 + T)
    B, NH, KVH, Dh = 2, 4, 2, 16
    q = rng.standard_normal((B, T, NH, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    sink = rng.standard_normal(NH).astype(np.float32) if with_sink else None
    valid = np.array([T, max(T // 2, 1)], np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want = jax_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        positions=jnp.asarray(pos), valid_len=jnp.asarray(valid),
        window=jnp.asarray(window, jnp.int32),
        sink=None if sink is None else jnp.asarray(sink),
    )
    got = chunk_attention(
        _t(q), _t(k), _t(v), positions=_t(pos, torch.int32),
        valid_len=_t(valid, torch.int32), window=window,
        sink=None if sink is None else _t(sink),
    )
    want = np.asarray(want)
    for b in range(B):  # padded tails are computed and discarded
        n = int(valid[b])
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("with_sink", [False, True])
@pytest.mark.parametrize("W,win_len", [(0, 0), (4, 0), (4, 3)])
def test_chunk_attention_paged_decode_matches_jax(window, with_sink, W, win_len):
    rng = np.random.default_rng(42)
    c = _decode_case(rng, W=W)
    B = c["q"].shape[0]
    sink = c["sink"] if with_sink else None
    pos = (c["past"] + win_len)[:, None]
    win = {}
    if W:
        win = dict(win_k=jnp.asarray(c["win_k"]), win_v=jnp.asarray(c["win_v"]),
                   win_len=jnp.asarray(win_len, jnp.int32))
    want = jax_chunk_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k_cur"]), jnp.asarray(c["v_cur"]),
        positions=jnp.asarray(pos), valid_len=jnp.ones((B,), jnp.int32),
        past_k_pages=jnp.asarray(c["k_pages"]), past_v_pages=jnp.asarray(c["v_pages"]),
        page_table=jnp.asarray(c["table"]), past_len=jnp.asarray(c["past"]),
        window=jnp.asarray(window, jnp.int32),
        sink=None if sink is None else jnp.asarray(sink), **win,
    )
    twin = {}
    if W:
        twin = dict(win_k=_t(c["win_k"]), win_v=_t(c["win_v"]), win_len=win_len)
    got = chunk_attention(
        _t(c["q"]), _t(c["k_cur"]), _t(c["v_cur"]),
        positions=_t(pos, torch.int32), valid_len=torch.ones(B, dtype=torch.int32),
        past_k_pages=_t(c["k_pages"]), past_v_pages=_t(c["v_pages"]),
        page_table=_t(c["table"], torch.int32), past_len=_t(c["past"], torch.int32),
        window=window, sink=None if sink is None else _t(sink), **twin,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_chunk_attention_chunk_over_paged_past_matches_jax(window):
    """T > 1 over paged past (chunked long prompts): gather + dense."""
    rng = np.random.default_rng(5)
    c = _decode_case(rng)
    B, T, NH, KVH, Dh = 3, 9, 4, 2, 16
    q = rng.standard_normal((B, T, NH, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    start = np.array([8, 13, 0], np.int32)
    valid = np.array([9, 4, 7], np.int32)
    pos = start[:, None] + np.arange(T, dtype=np.int32)[None]
    want = jax_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        positions=jnp.asarray(pos), valid_len=jnp.asarray(valid),
        past_k_pages=jnp.asarray(c["k_pages"]), past_v_pages=jnp.asarray(c["v_pages"]),
        page_table=jnp.asarray(c["table"]), past_len=jnp.asarray(start),
        window=jnp.asarray(window, jnp.int32),
    )
    got = chunk_attention(
        _t(q), _t(k), _t(v), positions=_t(pos, torch.int32),
        valid_len=_t(valid, torch.int32),
        past_k_pages=_t(c["k_pages"]), past_v_pages=_t(c["v_pages"]),
        page_table=_t(c["table"], torch.int32), past_len=_t(start, torch.int32),
        window=window,
    )
    want = np.asarray(want)
    for b in range(B):
        n = int(valid[b])
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("with_sink", [False, True])
@pytest.mark.parametrize("W,win_len", [(0, 0), (4, 2)])
def test_paged_decode_plain_matches_pallas(window, with_sink, W, win_len):
    rng = np.random.default_rng(42)
    c = _decode_case(rng, W=W)
    c["past"][0] = 0  # a row at its first decode step
    sink = c["sink"] if with_sink else None
    win = {}
    if W:
        win = dict(win_k=jnp.asarray(c["win_k"]), win_v=jnp.asarray(c["win_v"]),
                   win_len=jnp.asarray(win_len, jnp.int32))
    want = jax_paged_decode(
        jnp.asarray(c["q"][:, 0]), jnp.asarray(c["k_pages"]), jnp.asarray(c["v_pages"]),
        jnp.asarray(c["table"]), jnp.asarray(c["past"]),
        jnp.asarray(c["k_cur"][:, 0]), jnp.asarray(c["v_cur"][:, 0]),
        jnp.asarray(window, jnp.int32), None if sink is None else jnp.asarray(sink),
        interpret=True, **win,
    )
    twin = {}
    if W:
        twin = dict(win_k=_t(c["win_k"]), win_v=_t(c["win_v"]), win_len=win_len)
    got = pd.paged_decode_attention(
        _t(c["q"][:, 0]), _t(c["k_pages"]), _t(c["v_pages"]),
        _t(c["table"], torch.int32), _t(c["past"], torch.int32),
        _t(c["k_cur"][:, 0]), _t(c["v_cur"][:, 0]), window,
        None if sink is None else _t(sink), **twin,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_paged_decode_plain_padding_rows():
    """Inactive slots (all-zero table, past 0) attend to their current
    token only: finite, and equal to that token's value."""
    rng = np.random.default_rng(0)
    c = _decode_case(rng)
    table = np.zeros_like(c["table"])
    past = np.zeros(3, np.int32)
    got = pd.paged_decode_attention(
        _t(c["q"][:, 0]), _t(c["k_pages"]), _t(c["v_pages"]),
        _t(table, torch.int32), _t(past, torch.int32),
        _t(c["k_cur"][:, 0]), _t(c["v_cur"][:, 0]),
    )
    want = np.repeat(c["v_cur"][:, 0], 2, axis=1)  # G = 2 heads per KV head
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("T,window,with_sink", [
    (128, 0, False), (128, 5, True), (256, 200, False),
])
def test_flash_prefill_plain_matches_pallas(T, window, with_sink):
    rng = np.random.default_rng(7)
    B, NH, KVH, Dh = 2, 4, 2, 128
    q = rng.standard_normal((B, T, NH, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, Dh)).astype(np.float32)
    sink = rng.standard_normal(NH).astype(np.float32) if with_sink else None
    want = jax_flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        window=jnp.asarray(window, jnp.int32),
        sink=None if sink is None else jnp.asarray(sink), interpret=True,
    )
    got = fp.flash_prefill(
        _t(q), _t(k), _t(v), window=window, sink=None if sink is None else _t(sink)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Tb", [3, 12])
def test_kv_write_plain_matches_pallas(Tb):
    rng = np.random.default_rng(Tb)
    L, NP, PS, KD, B, MP = 2, 16, 8, 32, 3, 4
    k_pages = rng.standard_normal((L, NP, PS, KD)).astype(np.float32)
    v_pages = rng.standard_normal((L, NP, PS, KD)).astype(np.float32)
    k_new = rng.standard_normal((L, B, Tb, KD)).astype(np.float32)
    v_new = rng.standard_normal((L, B, Tb, KD)).astype(np.float32)
    table = np.array([[3, 4, 5, 0], [7, 1, 2, 9], [0, 0, 0, 0]], np.int32)
    start = np.array([5, 11, 0], np.int32)   # row 1 crosses a page edge
    valid = np.array([Tb, Tb - 1, Tb], np.int32)  # row 2 is a padding row
    want_k, want_v = kv_write_pallas(
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(table), jnp.asarray(start),
        jnp.asarray(valid), interpret=True,
    )
    got_k, got_v = _t(k_pages), _t(v_pages)
    kw.kv_write(got_k, got_v, _t(k_new), _t(v_new), _t(table, torch.int32),
                _t(start, torch.int32), _t(valid, torch.int32))
    np.testing.assert_array_equal(got_k[:, 1:].numpy(), np.asarray(want_k)[:, 1:])
    np.testing.assert_array_equal(got_v[:, 1:].numpy(), np.asarray(want_v)[:, 1:])
    # nothing lands on the garbage page
    np.testing.assert_array_equal(got_k[:, 0].numpy(), k_pages[:, 0])


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------

CUDA_TOL = 2e-2  # bfloat16 output rounding of an f32-accumulated kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_cuda_paged_decode_matches_plain(cuda_device, Dh):
    rng = np.random.default_rng(Dh)
    c = _decode_case(rng, B=5, NH=8, KVH=2, Dh=Dh, PS=16, MP=8, NP=48, W=4)
    c["past"][1] = 0
    args = [_t(c["q"][:, 0]), _t(c["k_pages"]), _t(c["v_pages"]),
            _t(c["table"], torch.int32), _t(c["past"], torch.int32),
            _t(c["k_cur"][:, 0]), _t(c["v_cur"][:, 0])]
    args = [a.to(cuda_device, torch.bfloat16 if a.is_floating_point() else a.dtype)
            for a in args]
    win = dict(win_k=_t(c["win_k"]).to(cuda_device, torch.bfloat16),
               win_v=_t(c["win_v"]).to(cuda_device, torch.bfloat16), win_len=2)
    sink = _t(c["sink"]).to(cuda_device)
    for kw_ in (dict(window=0), dict(window=7, sink=sink, **win)):
        got = pd.paged_decode_attention(*args, **kw_)
        want = pd.paged_decode_plain(*args, **kw_)
        torch.testing.assert_close(got.float(), want.float(), atol=CUDA_TOL, rtol=CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_cuda_flash_prefill_matches_plain(cuda_device, Dh):
    g = torch.Generator(device=cuda_device).manual_seed(Dh)
    bf = dict(device=cuda_device, dtype=torch.bfloat16, generator=g)
    q = torch.randn((2, 100, 8, Dh), **bf)
    k = torch.randn((2, 100, 2, Dh), **bf)
    v = torch.randn((2, 100, 2, Dh), **bf)
    sink = torch.randn((8,), device=cuda_device, generator=g)
    for kw_ in (dict(), dict(window=30, sink=sink)):
        got = fp.flash_prefill(q, k, v, **kw_)
        want = fp.flash_prefill_plain(q, k, v, **kw_)
        torch.testing.assert_close(got.float(), want.float(), atol=CUDA_TOL, rtol=CUDA_TOL)


@pytest.mark.cuda
def test_cuda_kv_write_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    bf = dict(device=cuda_device, dtype=torch.bfloat16, generator=g)
    pools = [torch.randn((3, 16, 8, 256), **bf) for _ in range(2)]
    new = [torch.randn((3, 3, 12, 256), **bf) for _ in range(2)]
    meta = [torch.tensor(x, dtype=torch.int32, device=cuda_device) for x in (
        [[3, 4, 5, 0], [7, 1, 2, 9], [0, 0, 0, 0]], [5, 11, 0], [12, 11, 12])]
    got = [p.clone() for p in pools]
    want = [p.clone() for p in pools]
    kw.kv_write(*got, *new, *meta)
    kw.kv_write_plain(*want, *new, *meta)
    assert torch.equal(got[0][:, 1:], want[0][:, 1:])
    assert torch.equal(got[1][:, 1:], want[1][:, 1:])
