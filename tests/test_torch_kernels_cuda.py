"""The redesigned attention kernels against their plain versions, on the card.

Every test is marked ``cuda`` and skips where there is no card. The
module imports neither ``jax`` nor ``sutro_tpu`` and needs nothing of
``tests/conftest.py``, so on a machine with the card and no JAX it runs
as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q

Inputs are bfloat16 (int8 pages with their per-token scales), outputs
held at atol = rtol = 2e-2: the output's bf16 rounding, plus p rounded
to bf16 for the value product in both kernels.

- flash prefill: T in {1, 15, 64, 65, 500, 2048} x Dh in {64, 128, 256}
  x G in {1, 4, 8}, each with no options and with a window and a sink;
- paged decode (bf16 and int8 pages): pasts of 0, 1, every split
  boundary of the wrapper's plan +- 1 and 8,192, padding rows, a window
  that starts inside a split, window slots with win_len 0..W, the carry
  with pfx_cnt > 0, the sink;
- the combinations each wrapper refuses raise.
"""

import numpy as np
import pytest
import torch

from sutro_tpu_torch.ops import flash_prefill as fp
from sutro_tpu_torch.ops import paged_decode as pd

TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda", 0)


def _close(got, want):
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 15, 64, 65, 500, 2048])
@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_prefill_matches_plain(dev, T, Dh, G):
    KVH = 2
    NH = G * KVH
    B = 1 if T == 2048 else 2
    g = torch.Generator(device=dev).manual_seed(T * 1000 + Dh + G)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q = torch.randn((B, T, NH, Dh), **bf)
    k = torch.randn((B, T, KVH, Dh), **bf)
    v = torch.randn((B, T, KVH, Dh), **bf)
    sink = torch.randn((NH,), device=dev, generator=g)
    for kw in (dict(), dict(window=max(1, T // 3), sink=sink)):
        got = fp.flash_prefill(q, k, v, **kw)
        want = fp.flash_prefill_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        _close(got, want)


def test_flash_prefill_refuses(dev):
    bf = dict(device=dev, dtype=torch.bfloat16)
    q, k = torch.zeros((1, 8, 4, 128), **bf), torch.zeros((1, 8, 2, 128), **bf)
    with pytest.raises(TypeError):
        fp.flash_prefill(q.float(), k.float(), k.float())
    with pytest.raises(ValueError):  # Dh outside {64, 128, 256}
        fp.flash_prefill(torch.zeros((1, 8, 4, 96), **bf), *(torch.zeros((1, 8, 2, 96), **bf),) * 2)
    with pytest.raises(ValueError):  # NH not a multiple of KVH
        fp.flash_prefill(torch.zeros((1, 8, 3, 128), **bf), k, k)
    with pytest.raises(ValueError):  # inconsistent shapes
        fp.flash_prefill(q, k, torch.zeros((1, 7, 2, 128), **bf))
    with pytest.raises(ValueError):
        fp.flash_prefill(q, k, k, sink=torch.zeros((3,), device=dev))
    with pytest.raises(ValueError):  # not contiguous
        fp.flash_prefill(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

PS, MP = 64, 130  # 8,320 tokens a row: room for a past of 8,192 and the window
B_ROWS = 40       # the split plan depends on B: every case has 40 rows


def _decode_case(dev, Dh, G, int8, seed, KVH=2):
    """Rows at every split boundary of the wrapper's plan +- 1, 0, 1,
    8,192, and two padding rows (zero table, past 0)."""
    rng = np.random.default_rng(seed)
    NH = G * KVH
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split, n_splits = pd.split_plan(MP, PS, B_ROWS, KVH, n_sm)
    pasts = [0, 1, 63, 64, 65, 8192]
    for s in range(1, n_splits):
        pasts += [p for p in (s * split - 1, s * split, s * split + 1) if p <= 8192]
    pasts = pasts[: B_ROWS - 2]
    past = np.zeros(B_ROWS, np.int64)  # rows 1 and the last ones pad
    past[0] = pasts[0]
    past[2 : 1 + len(pasts)] = pasts[1:]
    B = B_ROWS
    NP = 1 + int(sum(-(-int(p) // PS) for p in past))
    table = np.zeros((B, MP), np.int32)
    perm = rng.permutation(np.arange(1, NP))
    nxt = 0
    for b in range(B):
        n = -(-int(past[b]) // PS)
        table[b, :n] = perm[nxt : nxt + n]
        nxt += n
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    KD = KVH * Dh
    x = dict(
        q=torch.randn((B, NH, Dh), **bf),
        k_pages=torch.randn((NP, PS, KD), **bf), v_pages=torch.randn((NP, PS, KD), **bf),
        page_table=torch.as_tensor(table, device=dev),
        past_len=torch.as_tensor(past.astype(np.int32), device=dev),
        k_cur=torch.randn((B, KVH, Dh), **bf), v_cur=torch.randn((B, KVH, Dh), **bf),
    )
    scales = {}
    if int8:
        from sutro_tpu_torch.engine.kvcache import _quantize_tokens

        for name in ("k", "v"):
            qp, sc = _quantize_tokens(x.pop(f"{name}_pages"))
            x[f"{name}_pages"] = qp
            scales[f"{name}_scale"] = sc
    extra = dict(
        win_k=torch.randn((B, 8, KD), **bf), win_v=torch.randn((B, 8, KD), **bf),
        sink=torch.randn((NH,), device=dev, generator=g),
    )
    return x, scales, extra, past


def _args(x):
    return (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_matches_plain(dev, Dh, G, int8):
    x, scales, e, past = _decode_case(dev, Dh, G, int8, seed=Dh * 10 + G + 100 * int8)
    args = _args(x)
    cases = {
        "plain": dict(),
        "sink": dict(sink=e["sink"]),
        # a window of 200 starts inside a split for every long row
        "window200_slots_full": dict(window=200, win_k=e["win_k"], win_v=e["win_v"], win_len=8),
        "window4_slots3": dict(window=4, sink=e["sink"], win_k=e["win_k"], win_v=e["win_v"],
                               win_len=3),
    }
    for win_len in range(0, 9):
        cases[f"slots{win_len}"] = dict(win_k=e["win_k"], win_v=e["win_v"], win_len=win_len)
    for name, kw in cases.items():
        got = pd.paged_decode_attention(*args, **kw, **scales)
        want = pd.paged_decode_plain(*args, **kw, **scales)
        torch.cuda.synchronize()
        try:
            _close(got, want)
        except AssertionError as err:
            raise AssertionError(f"case {name}") from err


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 300])
def test_paged_decode_carry_matches_plain(dev, Dh, int8, window):
    """The carry joins the merge as one more partial; rows skip their
    first pfx_cnt pages (0 for the padding rows and the short ones)."""
    x, scales, e, past = _decode_case(dev, Dh, 8, int8, seed=7 + Dh + int8)
    B, NH = x["q"].shape[:2]
    g = torch.Generator(device=dev).manual_seed(3)
    pfx = np.minimum(past // PS, np.arange(B) % 5 * 7).astype(np.int32)
    carry = dict(
        pfx_cnt=torch.as_tensor(pfx, device=dev),
        m0=torch.randn((B, NH), device=dev, generator=g),
        l0=torch.rand((B, NH), device=dev, generator=g) * 50 + 0.5,
        acc0=torch.randn((B, NH, Dh), device=dev, generator=g) * 10,
    )
    cold = pfx == 0
    carry["m0"][torch.as_tensor(cold, device=dev)] = -1e30
    carry["l0"][torch.as_tensor(cold, device=dev)] = 0.0
    carry["acc0"][torch.as_tensor(cold, device=dev)] = 0.0
    kw = dict(window=window, sink=e["sink"], win_k=e["win_k"], win_v=e["win_v"], win_len=5)
    got = pd.paged_decode_attention(*_args(x), **kw, **carry, **scales)
    want = pd.paged_decode_plain(*_args(x), **kw, **carry, **scales)
    torch.cuda.synchronize()
    _close(got, want)


def test_paged_decode_refuses(dev):
    x, scales, e, _ = _decode_case(dev, 64, 4, True, seed=1)
    args = list(_args(x))
    with pytest.raises(ValueError):  # k_scale without v_scale
        pd.paged_decode_attention(*args, k_scale=scales["k_scale"])
    with pytest.raises(TypeError):  # int8 pages without their scales
        pd.paged_decode_attention(*args)
    y, _, _, _ = _decode_case(dev, 64, 4, False, seed=2)
    yargs = list(_args(y))
    with pytest.raises(TypeError):  # float32 q
        pd.paged_decode_attention(yargs[0].float(), *yargs[1:])
    with pytest.raises(TypeError):  # int64 table
        pd.paged_decode_attention(*yargs[:3], yargs[3].long(), *yargs[4:])
    with pytest.raises(ValueError):  # a pfx_cnt without the carry
        pd.paged_decode_attention(*yargs, pfx_cnt=torch.zeros_like(yargs[4]))
    B = yargs[0].shape[0]
    # G = 32 query heads per KV head: more than one m16 tile
    bf = dict(device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pd.paged_decode_attention(torch.zeros((B, 64, 64), **bf), *yargs[1:5],
                                  torch.zeros((B, 2, 64), **bf), torch.zeros((B, 2, 64), **bf))
    with pytest.raises(ValueError):  # Dh = 96
        pd.paged_decode_attention(torch.zeros((B, 4, 96), **bf),
                                  torch.zeros((4, PS, 192), **bf), torch.zeros((4, PS, 192), **bf),
                                  *yargs[3:5], torch.zeros((B, 2, 96), **bf),
                                  torch.zeros((B, 2, 96), **bf))
    with pytest.raises(ValueError):  # a pool that is not 16-byte aligned
        flat = torch.zeros(yargs[1].numel() + 1, **bf)
        pool = flat[1:].view(yargs[1].shape)
        pd.paged_decode_attention(yargs[0], pool, yargs[2], *yargs[3:])
    with pytest.raises(ValueError):  # inconsistent shapes
        pd.paged_decode_attention(*yargs[:5], yargs[5][:, :1], yargs[6])
