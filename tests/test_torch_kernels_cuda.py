"""The hand-written kernels against their plain versions, on the card.

Every test is marked ``cuda`` and skips where there is no card. The
module imports neither ``jax`` nor ``sutro_tpu`` and needs nothing of
``tests/conftest.py``, so on a machine with the card and no JAX it runs
as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q

Inputs are bfloat16 (int8 pages with their per-token scales), outputs
held at atol = rtol = 2e-2: the output's bf16 rounding, plus p rounded
to bf16 for the value product in the attention kernels.

- flash prefill: T in {1, 15, 64, 65, 500, 2048} x Dh in {64, 128, 256}
  x G in {1, 4, 8}, each with no options and with a window and a sink;
  an embedding batch at Qwen3-Embedding-0.6B's heads (16 over 8) with
  zero-padded rows of ragged lengths, each row also alone;
- paged decode (bf16 and int8 pages): pasts of 0, 1, every split
  boundary of the wrapper's plan +- 1 and 8,192, padding rows, a window
  that starts inside a split, window slots with win_len 0..W, the carry
  with pfx_cnt > 0, the sink;
- the prefix carry: Dh in {64, 128, 256} x G in {1, 4, 8, 16} x
  prefixes of 1, 16 and 64 pages (64 to 4,096 tokens), each with no
  window and a window that cuts the prefix; rows outside the group
  (pfx_len 0), a pfx_len that ends mid-page, page-0 padding past the
  shared pages, B*G not a multiple of the query tile;
- the grouped GEMM: empty groups, one hot expert, all groups empty,
  rows past the last group (which must be zero), M from 1 row to a few
  decode rows and across a row tile, H and F not multiples of the tiles,
  and Qwen3-30B-A3B's expert widths (gate/up and down) from a few decode
  rows to a prefill's 32,768, and gpt-oss-20b's (32 experts at H = F =
  2,880, 22.5 tiles of 128: a tail on every K and N) at a decode step's
  256, 4,000 and 16,000 rows, gate/up and down;
- the KV page write (bit-exact: it only copies): tokens bound for page
  0 and past the table's end (dropped), a chunk of a pool's layers
  written through a slice, padding rows, a prefill chunk, a full decode
  window written as one call, and a speculative window's commit with
  per-row accepted counts of 0, of 1 < a < steps and of steps in one
  call, at Qwen3-8B's and Qwen3-30B-A3B's widths;
- gpt-oss-20b's attention (64 query heads over 8 KV heads of 64): the
  prefix carry over 16 shared pages, and the paged decode started from
  it with the sink, against the plain decode over the full table, with
  no window and with the 128-token window that cuts the prefix;
- the shard shapes of a mesh (each rank's heads, KV heads, pool width
  and expert block): paged decode with and without the carry at
  Qwen3-30B-A3B's tp=2 heads (16 over 2) and at 8 over 1, flash prefill
  at those heads over a 1,024-token template and a 4,096-token sequence
  chunk, the KV write at ``KVH/tp*Dh`` = 256 and 128, and the grouped
  GEMM at E=128 with F=384 (tp=2), at E=64 with F=768 (ep=2) and at
  gpt-oss-120b's tp=2 width F=1,440 (a tail on N), gate/up and down;
- the combinations each wrapper refuses raise.
"""

import zlib

import numpy as np
import pytest
import torch

from sutro_tpu_torch.ops import flash_prefill as fp
from sutro_tpu_torch.ops import grouped_matmul as gm
from sutro_tpu_torch.ops import kv_write as kw
from sutro_tpu_torch.ops import paged_decode as pd
from sutro_tpu_torch.ops import prefix_carry as pc

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


@pytest.mark.parametrize("T", [32, 512])
def test_flash_prefill_embedding_batch_with_padded_rows(dev, T):
    """qwen3-emb-0.6b's heads (16 over 8, Dh=128) on an embedding batch:
    rows of ragged valid lengths padded to one bucket, the padding's
    q/k/v zeros. Every valid position matches the plain version and the
    row's own call alone (padding never reaches a valid query)."""
    B, NH, KVH, Dh = 8, 16, 8, 128
    g = torch.Generator(device=dev).manual_seed(T)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q = torch.randn((B, T, NH, Dh), **bf)
    k = torch.randn((B, T, KVH, Dh), **bf)
    v = torch.randn((B, T, KVH, Dh), **bf)
    lens = [T, 1, T // 2, T - 1, 3, T // 4, 0, T // 2 + 1]
    for b, n in enumerate(lens):
        for x in (q, k, v):
            x[b, n:] = 0
    got = fp.flash_prefill(q, k, v)
    want = fp.flash_prefill_plain(q, k, v)
    torch.cuda.synchronize()
    for b, n in enumerate(lens):
        _close(got[b, :n], want[b, :n])
        alone = fp.flash_prefill(q[b : b + 1, :n].contiguous(), k[b : b + 1, :n].contiguous(),
                                 v[b : b + 1, :n].contiguous()) if n else got[b : b + 1, :0]
        _close(got[b : b + 1, :n], alone)


@pytest.mark.parametrize("NH,KVH", [(16, 2), (8, 1)])
@pytest.mark.parametrize("T", [1024, 4096])
def test_flash_prefill_at_shard_heads(dev, NH, KVH, T):
    """A rank's heads under tp: Qwen3-30B-A3B's 32 over 4 at tp=2 and
    tp=4, over a template and over one rank's sequence chunk."""
    Dh, B = 128, 2 if T == 1024 else 1
    g = torch.Generator(device=dev).manual_seed(T + NH)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    q = torch.randn((B, T, NH, Dh), **bf)
    k = torch.randn((B, T, KVH, Dh), **bf)
    v = torch.randn((B, T, KVH, Dh), **bf)
    got = fp.flash_prefill(q, k, v)
    want = fp.flash_prefill_plain(q, k, v)
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


@pytest.mark.parametrize("KVH", [2, 1])
@pytest.mark.parametrize("carry", [False, True])
def test_paged_decode_at_shard_heads(dev, KVH, carry):
    """A rank's heads and pool under tp: 8 query heads a KV head, over
    KVH 2 (Qwen3-30B-A3B at tp=2: 16 heads) and KVH 1 (tp=4), with the
    window slots, and with a carry from shared pages."""
    x, scales, e, past = _decode_case(dev, 128, 8, False, seed=31 + KVH + carry, KVH=KVH)
    B, NH = x["q"].shape[:2]
    kw_ = dict(win_k=e["win_k"], win_v=e["win_v"], win_len=5)
    if carry:
        g = torch.Generator(device=dev).manual_seed(5)
        pfx = np.minimum(past // PS, 16).astype(np.int32)
        cold = torch.as_tensor(pfx == 0, device=dev)
        kw_.update(
            pfx_cnt=torch.as_tensor(pfx, device=dev),
            m0=torch.randn((B, NH), device=dev, generator=g).masked_fill(cold[:, None], -1e30),
            l0=(torch.rand((B, NH), device=dev, generator=g) * 50 + 0.5).masked_fill(
                cold[:, None], 0.0),
            acc0=(torch.randn((B, NH, 128), device=dev, generator=g) * 10).masked_fill(
                cold[:, None, None], 0.0),
        )
    got = pd.paged_decode_attention(*_args(x), **kw_)
    want = pd.paged_decode_plain(*_args(x), **kw_)
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


# ---------------------------------------------------------------------------
# prefix carry
# ---------------------------------------------------------------------------

CARRY_B = 13  # B*G is not a multiple of the kernel's query tile for any G


def _carry_case(dev, Dh, G, n_pages, seed, KVH=2):
    """A shared prefix of ``n_pages`` pages (page-0 padding after them)
    in a pool of scattered pages. Row kinds, in turn: members with the
    full prefix, rows outside the group (pfx_len 0), members whose
    pfx_len ends mid-page; q_pos past each row's prefix."""
    rng = np.random.default_rng(seed)
    NH, KD = G * KVH, KVH * Dh
    NP = 1 + n_pages + 3
    pages = rng.permutation(np.arange(1, NP))[:n_pages].astype(np.int32)
    padded = np.concatenate([pages, np.zeros(2, np.int32)])
    Lp = n_pages * PS
    kind = np.arange(CARRY_B) % 3
    pfx_len = np.where(kind == 0, Lp, np.where(kind == 1, 0, max(1, Lp - 17)))
    q_pos = pfx_len + rng.integers(0, 300, CARRY_B)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    return dict(q=torch.randn((CARRY_B, NH, Dh), **bf),
                k_pages=torch.randn((NP, PS, KD), **bf),
                v_pages=torch.randn((NP, PS, KD), **bf),
                pfx_pages=i32(padded), pfx_len=i32(pfx_len), q_pos=i32(q_pos)), Lp


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("n_pages", [1, 16, 64])
def test_prefix_carry_matches_plain(dev, Dh, G, n_pages):
    x, Lp = _carry_case(dev, Dh, G, n_pages, seed=Dh * 100 + G * 7 + n_pages)
    outside = x["pfx_len"] == 0
    # no window, and one that starts inside the prefix for every member
    for window in (0, Lp // 2 + 5):
        args = (x["q"], x["k_pages"], x["v_pages"], x["pfx_pages"], x["pfx_len"], x["q_pos"],
                window)
        got = pc.prefix_attention_carry(*args)
        want = pc.prefix_attention_carry_plain(*args)
        torch.cuda.synchronize()
        live = want[1] > 0  # m matters only where a key was in range
        try:
            _close(got[0][live], want[0][live])
            _close(got[1], want[1])
            _close(got[2], want[2])
        except AssertionError as err:
            raise AssertionError(f"window {window}") from err
        # the cold carry, exactly, for the rows outside the group
        assert (got[0][outside] == pc.NEG_INF).all()
        assert (got[1][outside] == 0).all() and (got[2][outside] == 0).all()


@pytest.mark.parametrize("window", [0, 128])
def test_gpt_oss_carry_then_decode_matches_plain_full_table(dev, window):
    """gpt-oss-20b's heads behind 16 shared pages (1,024 tokens): the
    carry kernel, then the decode kernel started from it with the sink
    and a fused window's slots, equal the plain decode over each row's
    whole table. The 128-token window cuts the prefix, so a member's
    carry holds its last tokens or nothing."""
    B, NH, KVH, Dh, n_pfx = 64, 64, 8, 64, 16
    rng = np.random.default_rng(20 + window)
    member = np.arange(B) % 8 != 7
    past = np.where(member, n_pfx * PS + rng.integers(1, 300, B), rng.integers(0, 300, B))
    n_pool = 1 + n_pfx + int(sum(-(-int(p) // PS) for p in past))
    table = np.zeros((B, 32), np.int32)
    nxt = 1 + n_pfx
    for b in range(B):
        head = n_pfx if member[b] else 0
        table[b, :head] = np.arange(1, 1 + head)
        n = -(-int(past[b]) // PS) - head
        table[b, head : head + n] = np.arange(nxt, nxt + n)
        nxt += n
    g = torch.Generator(device=dev).manual_seed(window)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    KD = KVH * Dh
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    q = torch.randn((B, NH, Dh), **bf)
    k_pages, v_pages = (torch.randn((n_pool, PS, KD), **bf) for _ in range(2))
    args = (q, k_pages, v_pages, i32(table), i32(past), torch.randn((B, KVH, Dh), **bf),
            torch.randn((B, KVH, Dh), **bf))
    kw = dict(window=window, sink=torch.randn((NH,), device=dev, generator=g),
              win_k=torch.randn((B, 8, KD), **bf), win_v=torch.randn((B, 8, KD), **bf),
              win_len=4)
    m0, l0, acc0 = pc.prefix_attention_carry(
        q, k_pages, v_pages, i32(np.arange(1, 1 + n_pfx)),
        i32(np.where(member, n_pfx * PS, 0)), i32(past + 4), window)
    got = pd.paged_decode_attention(*args, **kw, pfx_cnt=i32(np.where(member, n_pfx, 0)),
                                    m0=m0, l0=l0, acc0=acc0)
    want = pd.paged_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(got, want)


def test_prefix_carry_refuses(dev):
    x, _ = _carry_case(dev, 64, 4, 1, seed=5)
    args = [x["q"], x["k_pages"], x["v_pages"], x["pfx_pages"], x["pfx_len"], x["q_pos"]]
    with pytest.raises(TypeError):  # float32 q
        pc.prefix_attention_carry(args[0].float(), *args[1:])
    with pytest.raises(TypeError):  # int64 lengths
        pc.prefix_attention_carry(*args[:4], args[4].long(), args[5])
    with pytest.raises(ValueError):  # Dh = 96
        bf = dict(device=dev, dtype=torch.bfloat16)
        pc.prefix_attention_carry(torch.zeros((CARRY_B, 4, 96), **bf),
                                  torch.zeros((3, PS, 192), **bf),
                                  torch.zeros((3, PS, 192), **bf), *args[3:])
    with pytest.raises(ValueError):  # inconsistent shapes
        pc.prefix_attention_carry(*args[:4], args[4][:-1], args[5])


# ---------------------------------------------------------------------------
# grouped GEMM
# ---------------------------------------------------------------------------


def _sizes_summing_to(rng, E, M, empty=()):
    """Random group sizes with sum M, the groups ``empty`` left empty."""
    live = [e for e in range(E) if e not in empty]
    cuts = np.sort(rng.integers(0, M + 1, len(live) - 1))
    parts = np.diff(np.concatenate([[0], cuts, [M]]))
    sizes = [0] * E
    for e, n in zip(live, parts):
        sizes[e] = int(n)
    return sizes


def _gmm_cases():
    """name: (E, H, F, sizes or a total M, lhs rows past the last group).
    A total M is cut into random sizes with some groups empty."""
    E, H, F = 8, 136, 200  # H, F multiples of 8, not of the tiles
    return {
        "empty_groups": (E, H, F, [100, 28, 0, 128, 0, 7, 0, 1], 0),
        "one_hot_expert": (E, H, F, [0, 0, 0, 0, 0, 700, 0, 0], 0),
        "all_groups_empty": (E, H, F, [0] * E, 70),
        "rows_past_groups": (E, H, F, [100, 28, 0, 60, 5, 0, 0, 3], 150),
        "M1": (E, H, F, 1, 0),
        "M127": (E, H, F, 127, 0),
        "M129_past_groups": (E, H, F, 129, 33),
        "large_M": (E, H, F, 3000, 0),
        "wide_H520_F1032": (E, 520, 1032, 2500, 40),
        "qwen3_30b_gate_M24": (128, 2048, 768, 24, 0),
        "qwen3_30b_gate_M528_22_experts": (128, 2048, 768,
                                           [24 if e % 6 == 0 else 0 for e in range(128)], 0),
        "qwen3_30b_gate_M4096": (128, 2048, 768, 4096, 0),
        "qwen3_30b_gate_M32768": (128, 2048, 768, 32768, 0),
        "qwen3_30b_down_M512": (128, 768, 2048, 512, 0),
        "qwen3_30b_down_M16384": (128, 768, 2048, 16384, 0),
        "gpt_oss_gate_M256": (32, 2880, 2880, 256, 0),
        "gpt_oss_gate_M4000": (32, 2880, 2880, 4000, 0),
        "gpt_oss_gate_M16000": (32, 2880, 2880, 16000, 0),
        "gpt_oss_down_M256_past_groups": (32, 2880, 2880, 256, 40),
        "gpt_oss_down_M4000": (32, 2880, 2880, 4000, 0),
        "gpt_oss_down_M16000": (32, 2880, 2880, 16000, 0),
        # a rank's expert block on a mesh: Qwen3-30B-A3B at tp=2 (F/2)
        # and at ep=2 (E/2), gpt-oss-120b at tp=2 (F = 1,440: a tail on N)
        "qwen3_30b_tp2_gate_M512": (128, 2048, 384, 512, 0),
        "qwen3_30b_tp2_down_M512": (128, 384, 2048, 512, 0),
        "qwen3_30b_tp2_gate_M16384": (128, 2048, 384, 16384, 0),
        "qwen3_30b_ep2_gate_M512_past_groups": (64, 2048, 768, 400, 112),
        "qwen3_30b_ep2_down_M16384": (64, 768, 2048, 16384, 0),
        "gpt_oss_120b_tp2_gate_M256": (128, 2880, 1440, 256, 0),
        "gpt_oss_120b_tp2_down_M4000": (128, 1440, 2880, 4000, 0),
    }


@pytest.mark.parametrize("name", list(_gmm_cases()))
def test_grouped_matmul_matches_plain(dev, name):
    E, H, F, sizes, pad = _gmm_cases()[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if not isinstance(sizes, list):
        sizes = _sizes_summing_to(rng, E, sizes, empty=(1, E // 2))
    g = torch.Generator(device=dev).manual_seed(len(name))
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    n = sum(sizes)
    lhs = torch.randn((n + pad, H), **bf)
    rhs = torch.randn((E, H, F), **bf) * H ** -0.5
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = gm.grouped_matmul(lhs, rhs, gs)
    want = gm.grouped_matmul_plain(lhs, rhs, gs)
    torch.cuda.synchronize()
    _close(got, want)
    assert not got[n:].any(), "rows past the last group must be zero"


# ---------------------------------------------------------------------------
# KV page write
# ---------------------------------------------------------------------------


def _kv_cases():
    """name: (L, KD, PS, MP, starts, valid lengths, chunk tokens Tb,
    layers written of the pool or None for all, table edit). Tables hold
    distinct random pages >= 1 unless the edit zeroes entries."""
    steps = 8
    return {
        # 8 rows, one entry of each table zeroed: the tokens bound for
        # page 0 are dropped, the rest land
        "page0_entries": (3, 1024, 64, 8, [0, 60, 64, 100, 130, 0, 5, 190],
                          [64, 8, 64, 30, 60, 1, 64, 2], 64, None, "zero_one_entry"),
        # rows whose chunk runs past the table's last page
        "past_table_end": (2, 512, 64, 4, [200, 250, 255, 0], [64, 64, 1, 64], 64, None, None),
        # a chunk of the pool's layers (a contiguous slice) written: the
        # other layers stay as they were
        "layer_chunk": (48, 512, 64, 24, [0, 1000, 1471, 64], [8, 8, 8, 8], 8, (16, 32), None),
        "one_layer": (36, 1024, 64, 32, [5, 2040, 700], [8, 8, 8], 8, (35, 36), None),
        # padding rows (zero table, valid 0) between live ones
        "padding_rows": (4, 1024, 64, 32, [0, 0, 77, 0, 1500, 0], [12, 0, 12, 0, 12, 0], 12,
                         None, "zero_odd_rows"),
        # a prefill chunk: 4 rows of up to 500 tokens, padded tails
        "prefill_chunk": (2, 512, 64, 24, [0, 0, 1024, 0], [500, 37, 256, 499], 500, None, None),
        # a full decode window of 64 rows x 8 steps in one call (4 pages
        # a row keep the pools small; the window's rows land anywhere in
        # them)
        "window_qwen3_30b": (48, 512, 64, 4, "ragged64", [steps] * 64, steps, None, None),
        "window_qwen3_8b": (36, 1024, 64, 4, "ragged64", [steps] * 64, steps, None, None),
        # a speculative window's commit: per-row accepted counts of 0,
        # of 1 < a < steps, and of steps, in one call
        "commit_mixed_accepted": (48, 512, 64, 4, "ragged64",
                                  [0, 3, steps, 1, 7, 0, 2, steps] * 8, steps, None, None),
        # a rank's block of the pool on a mesh: Qwen3-30B-A3B's KVH/tp*Dh
        # at tp=2 (256) and tp=4 (128)
        "window_qwen3_30b_tp2": (48, 256, 64, 4, "ragged64", [steps] * 64, steps, None, None),
        "prefill_qwen3_30b_tp4": (48, 128, 64, 24, [0, 0, 1024, 0], [500, 37, 256, 499], 500,
                                  None, None),
    }


@pytest.mark.parametrize("name", list(_kv_cases()))
def test_kv_write_matches_plain(dev, name):
    L, KD, PS_, MP_, starts, valid, Tb, layers, edit = _kv_cases()[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if starts == "ragged64":
        starts = rng.integers(0, MP_ * PS_ - Tb, 64).tolist()
    B = len(starts)
    NP = 1 + B * MP_
    table = rng.permutation(np.arange(1, NP)).reshape(B, MP_).astype(np.int32)
    if edit == "zero_one_entry":
        for b, s in enumerate(starts):
            table[b, (s + valid[b] // 2) // PS_] = 0
    elif edit == "zero_odd_rows":
        table[1::2] = 0
    g = torch.Generator(device=dev).manual_seed(len(name))
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    pools = [torch.randn((L, NP, PS_, KD), **bf) for _ in range(2)]
    lo, hi = layers or (0, L)
    new = [torch.randn((hi - lo, B, Tb, KD), **bf) for _ in range(2)]
    meta = [torch.as_tensor(np.asarray(x, np.int32), device=dev)
            for x in (table, starts, valid)]
    got = [p.clone() for p in pools]
    want = [p.clone() for p in pools]
    kw.kv_write(*(p[lo:hi] for p in got), *new, *meta)
    kw.kv_write_plain(*(p[lo:hi] for p in want), *new, *meta)
    torch.cuda.synchronize()
    for a, b, p in zip(got, want, pools):
        assert torch.equal(a, b)
        assert torch.equal(a[:lo], p[:lo]) and torch.equal(a[hi:], p[hi:])
        assert torch.equal(a[:, 0], p[:, 0]), "page 0 must not be written"
    # the plain version wrote what it should: every live token's row
    for b, (s, n) in enumerate(zip(starts, valid)):
        for t in (0, n - 1) if n else ():
            pos = s + t
            if pos // PS_ < MP_ and table[b, pos // PS_] > 0:
                page = int(table[b, pos // PS_])
                assert torch.equal(got[0][lo:hi, page, pos % PS_], new[0][:, b, t])


def test_kv_write_refuses(dev):
    bf = dict(device=dev, dtype=torch.bfloat16)
    pools = [torch.zeros((2, 4, 8, 64), **bf) for _ in range(2)]
    new = [torch.zeros((2, 1, 3, 64), **bf) for _ in range(2)]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    meta = [i32([[1, 2]]), i32([0]), i32([3])]
    with pytest.raises(TypeError):
        kw.kv_write(*pools, *(t.float() for t in new), *meta)
    with pytest.raises(TypeError):
        kw.kv_write(*pools, *new, meta[0].long(), *meta[1:])
    with pytest.raises(ValueError):
        kw.kv_write(*pools, new[0][:, :, :2], new[1], *meta)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros((2, 1, 64, 3), **bf).transpose(2, 3)
        kw.kv_write(*pools, strided, new[1], *meta)
