"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain
version.

Port of ``sutro_tpu/ops/pallas_paged.py::paged_decode_attention``. One
query token per row attends over the row's pages (walk bounded by
``past_len``), the fused decode window's slots that are not in the pool
yet (slot ``s < win_len`` sits at position ``past_len + s``), and the
current token (at ``past_len + win_len``). Per-layer sliding window;
the attention sink joins the softmax denominator only.

The pool carries the fused ``[NP, PS, KVH*Dh]`` layout of
engine/kvcache.py.

int8-page option (the reference's ``k_scale``/``v_scale``): pages are
int8 with per-token float32 scales ``[NP, PS]``; ``q``, the current
token, the window slots and the output stay bfloat16. As in the
reference kernel, the K scale multiplies each page token's score and
the V scale multiplies ``p`` in the value sum only (the normalizer sums
the unscaled ``p``). The plain version dequantizes the gathered pages
instead; both compute the same function.

Carry option (the reference's shared-prefix mode): with ``pfx_cnt``
``[B]``, row ``b`` skips its first ``pfx_cnt[b]`` pages and starts its
online softmax from the injected carry ``m0``/``l0`` ``[B, NH]``,
``acc0`` ``[B, NH, Dh]`` float32 (ops/prefix_carry.py computes it once
for a job-shared prefix). A row with ``pfx_cnt`` 0 and the cold carry
(-1e30, 0, 0) is a plain row. The sink still joins once, in the final
denominator.

On a CUDA tensor the wrapper launches ``csrc/paged_decode.cu`` or
raises; on a CPU tensor it runs :func:`paged_decode_plain`. Launches
over int8 pages count on ``INT8`` (with or without the carry), other
launches with the carry on ``CARRY``, the rest on ``KERNEL``.

The kernel is split-K flash-decoding: :func:`split_plan` cuts each
row's key range into splits of a fixed number of tokens (from the
table's static width and the shapes, never from ``past_len``), one
block per (split, KV head, row) writes a partial (m, l, acc) per query
head, and a second kernel merges a row's partials with the carry as one
more partial and the sink once (:func:`merge_partials_plain` is that
merge in PyTorch; :func:`split_partials_plain` the partials). One call
is one launch on its counter, the merge included.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .cuda_build import CudaKernel, ptr, sm_count, stream_handle

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16     # query heads per KV head: one m16 tile of the tensor cores
SPLIT_TILE = 64    # a split is a whole number of 64-token tiles
BLOCKS_PER_SM = 16  # the plan's aim for a batch whose tables are full

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 16 + [_I] * 11 + [ctypes.c_float, _P]
KERNEL = CudaKernel(
    "paged_decode", "paged_decode_bf16", _ARGS,
    replaces="sutro_tpu/ops/pallas_paged.py:713",
)
CARRY = CudaKernel(
    "paged_decode_carry", "paged_decode_bf16", _ARGS,
    replaces="sutro_tpu/ops/pallas_paged.py:713 (pfx_cnt/m0/l0/acc0, :734-743)",
    source="paged_decode",
)
INT8 = CudaKernel(
    "paged_decode_int8", "paged_decode_int8", [_P] * 18 + [_I] * 11 + [ctypes.c_float, _P],
    replaces="sutro_tpu/ops/pallas_paged.py:713 (k_scale/v_scale, :729-733)",
    source="paged_decode",
)


def split_plan(MP: int, PS: int, B: int, KVH: int, n_sm: int) -> Tuple[int, int]:
    """``(tokens per split, splits)`` for a call over ``[B, MP]`` tables
    of ``PS``-token pages on a card with ``n_sm`` multiprocessors. A
    batch whose tables were full would give about ``BLOCKS_PER_SM``
    blocks of (split, KV head, row) per multiprocessor; splits are whole
    64-token tiles, balanced over the table's width. Static shapes only:
    ``past_len`` is never read, so nothing waits for the card."""
    tiles = max(1, math.ceil(MP * PS / SPLIT_TILE))
    per = max(1, math.ceil(tiles * B * KVH / (BLOCKS_PER_SM * max(1, n_sm))))
    n_splits = math.ceil(tiles / per)
    per = math.ceil(tiles / n_splits)
    return per * SPLIT_TILE, n_splits


def split_partials_plain(
    q, k_pages, v_pages, page_table, past_len, k_cur, v_cur, split: int, n_splits: int,
    window: int = 0, win_k=None, win_v=None, win_len: int = 0, pfx_cnt=None,
    k_scale=None, v_scale=None,
):
    """What the split kernel's blocks compute, in float32: for split
    ``s`` of row ``b``, the page tokens ``[s * split, (s+1) * split)``
    from the first in-window token (and the first page after the shared
    prefix) to ``past_len``; the window slots and the current token
    belong to the split of the row's last page token (split 0 for an
    empty past). Returns ``m, l`` ``[S, B, NH]`` and ``acc`` ``[S, B, NH,
    Dh]``; a split with no key has ``m = -1e30, l = 0, acc = 0``."""
    B, NH, Dh = q.shape
    KVH = k_cur.shape[1]
    G = NH // KVH
    MP = page_table.shape[1]
    PS = k_pages.shape[1]
    ctx = MP * PS
    dev = q.device
    idx = page_table.long().reshape(-1)
    kp, vp = k_pages[idx].float(), v_pages[idx].float()
    if k_scale is not None:
        kp = kp * k_scale[idx].float()[..., None]
        vp = vp * v_scale[idx].float()[..., None]
    past = past_len.long()
    pos = past + int(win_len)
    tok = torch.arange(ctx, device=dev)
    t_lo = torch.zeros_like(past)
    if window > 0:
        t_lo = torch.clamp(pos - window + 1, min=0)
    if pfx_cnt is not None:
        t_lo = torch.maximum(t_lo, pfx_cnt.long() * PS)
    tail = torch.where(past > 0, torch.div(past - 1, split, rounding_mode="floor"), 0)
    keys = [kp.reshape(B, ctx, KVH, Dh)]
    vals = [vp.reshape(B, ctx, KVH, Dh)]
    ok = [(tok[None] < past[:, None]) & (tok[None] >= t_lo[:, None])]
    owner = [torch.div(tok, split, rounding_mode="floor")[None].expand(B, ctx)]
    W = 0 if win_k is None else win_k.shape[1]
    if W:
        slot = torch.arange(W, device=dev)
        keys.append(win_k.reshape(B, W, KVH, Dh))
        vals.append(win_v.reshape(B, W, KVH, Dh))
        w_ok = slot < int(win_len)
        if window > 0:
            w_ok = w_ok & (int(win_len) - slot < window)
        ok.append(w_ok[None].expand(B, W))
        owner.append(tail[:, None].expand(B, W))
    keys.append(k_cur[:, None])
    vals.append(v_cur[:, None])
    ok.append(torch.ones((B, 1), dtype=torch.bool, device=dev))
    owner.append(tail[:, None])
    keys = torch.cat([x.float() for x in keys], 1)      # [B, S_k, KVH, Dh]
    vals = torch.cat([x.float() for x in vals], 1)
    ok = torch.cat(ok, 1)
    owner = torch.cat(owner, 1)
    splits = torch.arange(n_splits, device=dev)
    mine = ok[None] & (owner[None] == splits[:, None, None])  # [S, B, S_k]
    mine = mine[:, :, None, None, :]
    qg = q.float().reshape(B, KVH, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, keys) * Dh ** -0.5
    s = torch.where(mine, s[None], torch.full_like(s[None], NEG_INF))  # [S, B, KVH, G, S_k]
    m = s.amax(-1)
    p = torch.where(mine, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    acc = torch.einsum("zbkgs,bskd->zbkgd", p, vals)
    return (m.reshape(n_splits, B, NH), l.reshape(n_splits, B, NH),
            acc.reshape(n_splits, B, NH, Dh))


def merge_partials_plain(m, l, acc, sink=None, m0=None, l0=None, acc0=None):
    """The merge kernel in PyTorch: ``[S, B, NH]`` partials ``m, l`` and
    ``[S, B, NH, Dh]`` ``acc``, the carry ``m0, l0`` ``[B, NH]``, ``acc0``
    ``[B, NH, Dh]`` as one more partial, and the sink once in the
    denominator. A partial with ``l == 0`` adds nothing (its ``acc`` is
    not read). Returns float32 ``[B, NH, Dh]``."""
    M = m.amax(0)
    if m0 is not None:
        M = torch.maximum(M, m0)
    if sink is not None:
        M = torch.maximum(M, sink.float()[None])
    live = l > 0
    f = torch.where(live, torch.exp(m - M[None]), torch.zeros_like(m))
    L = (l * f).sum(0)
    A = torch.where(live[..., None], acc * f[..., None], torch.zeros_like(acc)).sum(0)
    if m0 is not None:
        fc = torch.exp(m0 - M)
        L = L + l0 * fc
        A = A + acc0 * fc[..., None]
    if sink is not None:
        L = L + torch.exp(sink.float()[None] - M)
    return A / torch.clamp(L, min=1e-30)[..., None]


def paged_decode_plain(
    q: torch.Tensor,           # [B, NH, Dh]
    k_pages: torch.Tensor,     # [NP, PS, KVH*Dh] one layer's pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    past_len: torch.Tensor,    # [B] int32
    k_cur: torch.Tensor,       # [B, KVH, Dh]
    v_cur: torch.Tensor,
    window: int = 0,
    sink: Optional[torch.Tensor] = None,   # [NH]
    win_k: Optional[torch.Tensor] = None,  # [B, W, KVH*Dh]
    win_v: Optional[torch.Tensor] = None,
    win_len: int = 0,
    pfx_cnt: Optional[torch.Tensor] = None,  # [B] int32 pages to skip
    m0: Optional[torch.Tensor] = None,       # [B, NH] f32 carry
    l0: Optional[torch.Tensor] = None,
    acc0: Optional[torch.Tensor] = None,     # [B, NH, Dh] f32
    k_scale: Optional[torch.Tensor] = None,  # [NP, PS] f32 (int8 pages)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather version of the kernel: one online-softmax step from the
    carry (the cold carry without one) over every key, in float32. int8
    pages are dequantized as they are gathered."""
    B, NH, Dh = q.shape
    KVH = k_cur.shape[1]
    G = NH // KVH
    MP = page_table.shape[1]
    PS = k_pages.shape[1]
    ctx = MP * PS
    dev = q.device
    idx = page_table.long().reshape(-1)
    kp, vp = k_pages[idx].float(), v_pages[idx].float()
    if k_scale is not None:
        kp = kp * k_scale[idx].float()[..., None]
        vp = vp * v_scale[idx].float()[..., None]
    keys = [kp.reshape(B, ctx, KVH, Dh)]
    vals = [vp.reshape(B, ctx, KVH, Dh)]
    tok = torch.arange(ctx, device=dev)
    past = past_len.long()
    pos = past + int(win_len)                           # [B] query position
    key_pos = [tok[None].expand(B, ctx)]
    valid = [tok[None] < past[:, None]]
    if pfx_cnt is not None:
        valid[0] = valid[0] & (tok[None] >= pfx_cnt.long()[:, None] * PS)
    W = 0 if win_k is None else win_k.shape[1]
    if W:
        slot = torch.arange(W, device=dev)
        keys.append(win_k.reshape(B, W, KVH, Dh))
        vals.append(win_v.reshape(B, W, KVH, Dh))
        key_pos.append(past[:, None] + slot[None])
        valid.append((slot < int(win_len))[None].expand(B, W))
    keys.append(k_cur[:, None])
    vals.append(v_cur[:, None])
    key_pos.append(pos[:, None])
    valid.append(torch.ones((B, 1), dtype=torch.bool, device=dev))
    keys = torch.cat([x.float() for x in keys], 1)      # [B, S, KVH, Dh]
    vals = torch.cat([x.float() for x in vals], 1)
    key_pos = torch.cat(key_pos, 1)
    ok = torch.cat(valid, 1) & (key_pos <= pos[:, None])
    if window > 0:
        ok = ok & (pos[:, None] - key_pos < window)
    ok = ok[:, None, None, :]
    qg = q.float().reshape(B, KVH, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, keys) * Dh ** -0.5
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    if pfx_cnt is not None:
        m_c = m0.float().reshape(B, KVH, G)
        l_c = l0.float().reshape(B, KVH, G)
        acc_c = acc0.float().reshape(B, KVH, G, Dh)
    else:
        m_c = torch.full((B, KVH, G), NEG_INF, device=dev)
        l_c = torch.zeros((B, KVH, G), device=dev)
        acc_c = torch.zeros((B, KVH, G, Dh), device=dev)
    m = torch.maximum(m_c, s.amax(-1))
    if sink is not None:
        sk = sink.float().reshape(1, KVH, G)
        m = torch.maximum(m, sk)
    # p under the mask: an all-masked key adds 0, not exp(-1e30 + 1e30)
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    alpha = torch.exp(m_c - m)
    l = l_c * alpha + p.sum(-1)
    if sink is not None:
        l = l + torch.exp(sk - m)
    acc = acc_c * alpha[..., None] + torch.einsum("bkgs,bskd->bkgd", p, vals)
    return (acc / l[..., None]).reshape(B, NH, Dh).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,           # [B, NH, Dh] current-step queries
    k_pages: torch.Tensor,     # [NP, PS, KVH*Dh] one layer's fused pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    past_len: torch.Tensor,    # [B] int32 tokens already in the pool
    k_cur: torch.Tensor,       # [B, KVH, Dh] current token K (post-RoPE)
    v_cur: torch.Tensor,
    window: int = 0,           # 0 => full attention
    sink: Optional[torch.Tensor] = None,   # [NH] logits
    win_k: Optional[torch.Tensor] = None,  # [B, W, KVH*Dh] window buffer
    win_v: Optional[torch.Tensor] = None,
    win_len: int = 0,          # valid window slots
    pfx_cnt: Optional[torch.Tensor] = None,  # [B] int32 shared pages to skip
    m0: Optional[torch.Tensor] = None,       # [B, NH] f32 injected carry
    l0: Optional[torch.Tensor] = None,
    acc0: Optional[torch.Tensor] = None,     # [B, NH, Dh] f32
    k_scale: Optional[torch.Tensor] = None,  # [NP, PS] f32: int8 pages
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns ``[B, NH, Dh]`` attention outputs for one decode step.

    Contract (as in the reference): ``past_len[b] <= MP * PS``; an
    inactive row has an all-zero table and ``past_len`` 0 and attends
    to its current token only; with the carry, ``pfx_cnt[b] * PS <=
    past_len[b]``."""
    carry = pfx_cnt is not None
    if carry and (m0 is None or l0 is None or acc0 is None):
        raise ValueError("paged_decode_attention: pfx_cnt needs m0, l0 and acc0")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("paged_decode_attention: k_scale and v_scale go together")
    if not q.is_cuda:
        return paged_decode_plain(
            q, k_pages, v_pages, page_table, past_len, k_cur, v_cur,
            window, sink, win_k, win_v, win_len, pfx_cnt, m0, l0, acc0,
            k_scale, v_scale,
        )
    B, NH, Dh = q.shape
    NP, PS, KD = k_pages.shape
    KVH = k_cur.shape[1]
    MP = page_table.shape[1]
    W = 0 if win_k is None else win_k.shape[1]
    bf16 = [q, k_cur, v_cur] + ([win_k, win_v] if W else [])
    page_dtype = torch.int8 if quantized else torch.bfloat16
    if any(t.dtype != torch.bfloat16 for t in bf16) or any(
        t.dtype != page_dtype for t in (k_pages, v_pages)
    ):
        raise TypeError(
            "paged_decode_attention: the kernel takes bfloat16 q/k/v and "
            "bfloat16 pages, or int8 pages with k_scale/v_scale"
        )
    if quantized and (
        any(t.dtype != torch.float32 for t in (k_scale, v_scale))
        or tuple(k_scale.shape) != (NP, PS) or v_scale.shape != k_scale.shape
    ):
        raise ValueError("paged_decode_attention: k_scale/v_scale must be [NP, PS] float32")
    if page_table.dtype != torch.int32 or past_len.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table/past_len must be int32")
    if Dh not in HEAD_DIMS or NH % KVH or NH // KVH > MAX_GROUP:
        raise ValueError(
            f"paged_decode_attention: unsupported NH={NH} KVH={KVH} Dh={Dh}"
        )
    if (
        KD != KVH * Dh
        or v_pages.shape != k_pages.shape
        or tuple(k_cur.shape) != (B, KVH, Dh)
        or v_cur.shape != k_cur.shape
        or tuple(page_table.shape) != (B, MP)
        or tuple(past_len.shape) != (B,)
        or (W and (tuple(win_k.shape) != (B, W, KD) or win_v.shape != win_k.shape))
    ):
        raise ValueError("paged_decode_attention: inconsistent shapes")
    if sink is not None:
        if tuple(sink.shape) != (NH,):
            raise ValueError("paged_decode_attention: sink must be [NH]")
        sink = sink.float().contiguous()
    if carry:
        if pfx_cnt.dtype != torch.int32 or tuple(pfx_cnt.shape) != (B,):
            raise ValueError("paged_decode_attention: pfx_cnt must be int32 [B]")
        if (
            any(t.dtype != torch.float32 for t in (m0, l0, acc0))
            or tuple(m0.shape) != (B, NH) or l0.shape != m0.shape
            or tuple(acc0.shape) != (B, NH, Dh)
        ):
            raise ValueError(
                "paged_decode_attention: the carry is m0/l0 [B, NH] and "
                f"acc0 [B, NH, Dh] float32, got {tuple(m0.shape)} "
                f"{tuple(l0.shape)} {tuple(acc0.shape)}"
            )
    args = [q, k_pages, v_pages, page_table, past_len, k_cur, v_cur] + (
        [win_k, win_v] if W else []
    ) + ([sink] if sink is not None else []) + (
        [pfx_cnt, m0, l0, acc0] if carry else []
    ) + ([k_scale, v_scale] if quantized else [])
    if any(t.device != q.device for t in args):
        raise ValueError("paged_decode_attention: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("paged_decode_attention: tensors must be contiguous")
    rows = [q, k_pages, v_pages, k_cur, v_cur] + ([win_k, win_v] if W else [])
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError(
            "paged_decode_attention: q, the pools, the current token and the window "
            "must be 16-byte aligned"
        )
    out = torch.empty_like(q)
    if B == 0:
        return out
    split, n_splits = split_plan(MP, PS, B, KVH, sm_count(q.device))
    # the partials m, l [S, B, NH] and acc [S, B, NH, Dh], float32
    work = torch.empty(n_splits * B * NH * (Dh + 2), dtype=torch.float32, device=q.device)
    common = (
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(page_table), ptr(past_len),
        ptr(k_cur), ptr(v_cur), ptr(win_k if W else None),
        ptr(win_v if W else None), ptr(sink), ptr(pfx_cnt), ptr(m0),
        ptr(l0), ptr(acc0),
    )
    tail = (
        ptr(out), ptr(work), B, NH, KVH, Dh, PS, MP, W, int(win_len), int(window),
        split, n_splits, ctypes.c_float(Dh ** -0.5), stream_handle(q.device),
    )
    if quantized:
        INT8.launch(*common, ptr(k_scale), ptr(v_scale), *tail)
    else:
        (CARRY if carry else KERNEL).launch(*common, *tail)
    return out
