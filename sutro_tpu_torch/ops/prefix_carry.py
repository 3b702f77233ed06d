"""Shared-prefix attention carry: the CUDA kernel's wrapper and its plain
version.

Port of ``sutro_tpu/ops/pallas_paged.py::prefix_attention_carry_pallas``
(and its plain twin ``prefix_attention_carry``). Every row's decode
query attends over one job-shared, page-aligned prefix (``pfx_pages``,
padded with the garbage page 0); the result is the online-softmax carry
``(m0, l0, acc0)`` that the paged-decode kernel's carry option starts
from, so the shared pages are read once per layer-step for the whole
batch. Row ``b`` sees prefix tokens ``t < pfx_len[b]`` within its
window (``q_pos[b] - t < window``); a row outside the group
(``pfx_len`` 0) gets the cold carry (-1e30, 0, 0).

The carry is per head: ``m0``/``l0`` ``[B, NH]`` and ``acc0`` ``[B, NH,
Dh]`` float32. The reference's block-diagonal ``[B, NH, KVH*Dh]`` acc
existed for the TPU's matrix unit; row ``n`` of it holds this ``acc0[:,
n]`` in lane block ``n // G`` and zeros elsewhere.

On a CUDA tensor the wrapper launches ``csrc/prefix_carry.cu`` or
raises; on a CPU tensor it runs :func:`prefix_attention_carry_plain`.

Over an int8 pool (``k_scale``/``v_scale``) the carry is always the
plain version with the scales, on any device: that is the reference's
own routing (its XLA ``prefix_attention_carry(k_scale=...)``), since its
Pallas carry is bf16-only (``prefix_carry_supported``). No TPU kernel
computes an int8 carry; a kernel for it is queued in ROADMAP.md.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .cuda_build import CudaKernel, ptr, sm_count, stream_handle

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
TILE_TOKENS = {64: 64, 128: 64, 256: 32}  # prefix tokens per tile, by Dh (csrc TT)
QUERY_ROWS = 64    # query rows (b, g) per block (csrc QT)
BLOCKS_PER_SM = 1  # the kernel's occupancy: one block of 8 warps an SM
MIN_TILES = 4      # tiles a split walks at least

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "prefix_carry",
    "prefix_carry_bf16",
    [_P] * 12 + [_I] * 9 + [ctypes.c_float, _P],
    replaces="sutro_tpu/ops/pallas_paged.py:558",
)

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def prefix_attention_carry_plain(
    q: torch.Tensor,          # [B, NH, Dh]
    k_pages: torch.Tensor,    # [NP, PS, KVH*Dh] one layer's pool
    v_pages: torch.Tensor,
    pfx_pages: torch.Tensor,  # [Pp] int32
    pfx_len: torch.Tensor,    # [B] int32
    q_pos: torch.Tensor,      # [B] int32
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # [NP, PS] f32 (int8 pages)
    v_scale: Optional[torch.Tensor] = None,
) -> Carry:
    """Gather version of the kernel, in float32; int8 pages are
    dequantized as they are gathered."""
    B, NH, Dh = q.shape
    NP, PS, KD = k_pages.shape
    KVH = KD // Dh
    G = NH // KVH
    Lp = pfx_pages.shape[0] * PS
    idx = pfx_pages.long()
    kp, vp = k_pages[idx].float(), v_pages[idx].float()
    if k_scale is not None:
        kp = kp * k_scale[idx].float()[..., None]
        vp = vp * v_scale[idx].float()[..., None]
    kp = kp.reshape(Lp, KVH, Dh)
    vp = vp.reshape(Lp, KVH, Dh)
    qg = q.float().reshape(B, KVH, G, Dh)
    s = torch.einsum("bkgd,lkd->bkgl", qg, kp) * Dh ** -0.5
    t = torch.arange(Lp, device=q.device)
    ok = t[None] < pfx_len.long()[:, None]                # [B, Lp]
    if window > 0:
        ok = ok & (q_pos.long()[:, None] - t[None] < window)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    # p under the mask: an all-masked row keeps l = 0, acc = 0
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bkgl,lkd->bkgd", p, vp)
    return m.reshape(B, NH), p.sum(-1).reshape(B, NH), acc.reshape(B, NH, Dh)


def split_plan(Pp: int, PS: int, B: int, G: int, KVH: int, Dh: int,
               n_sm: int) -> Tuple[int, int]:
    """``(tiles per split, splits)`` of a carry over ``Pp`` pages of
    ``PS`` tokens for ``B`` rows of ``G`` query heads per KV head, on a
    card with ``n_sm`` multiprocessors. Few, long splits: the grid stays
    within one wave of ``BLOCKS_PER_SM`` blocks an SM and a split walks
    at least ``MIN_TILES`` tiles; every split has a tile. Static shapes
    only: ``pfx_len`` is never read, so nothing waits for the card."""
    tiles = max(1, math.ceil(Pp * PS / TILE_TOKENS[Dh]))
    blocks = KVH * math.ceil(B * G / QUERY_ROWS)
    want = max(1, min(BLOCKS_PER_SM * n_sm // blocks, tiles // MIN_TILES))
    per = math.ceil(tiles / want)
    return per, math.ceil(tiles / per)


def prefix_attention_carry(
    q: torch.Tensor,          # [B, NH, Dh] current-step queries
    k_pages: torch.Tensor,    # [NP, PS, KVH*Dh] one layer's fused pool
    v_pages: torch.Tensor,
    pfx_pages: torch.Tensor,  # [Pp] int32 the shared prefix's pages
    pfx_len: torch.Tensor,    # [B] int32 prefix tokens per row (0: none)
    q_pos: torch.Tensor,      # [B] int32 each query's position
    window: int = 0,          # 0 => full attention
    k_scale: Optional[torch.Tensor] = None,  # [NP, PS] f32: int8 pages
    v_scale: Optional[torch.Tensor] = None,
) -> Carry:
    """Returns ``(m0 [B, NH], l0 [B, NH], acc0 [B, NH, Dh])`` float32."""
    if not q.is_cuda or k_scale is not None:
        # an int8 carry is the reference's XLA function on every device
        return prefix_attention_carry_plain(
            q, k_pages, v_pages, pfx_pages, pfx_len, q_pos, window, k_scale, v_scale
        )
    B, NH, Dh = q.shape
    NP, PS, KD = k_pages.shape
    Pp = pfx_pages.shape[0] if pfx_pages.dim() == 1 else -1
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 or (
        v_pages.dtype != torch.bfloat16
    ):
        raise TypeError("prefix_attention_carry: the kernel takes bfloat16 q/k/v")
    if any(t.dtype != torch.int32 for t in (pfx_pages, pfx_len, q_pos)):
        raise TypeError("prefix_attention_carry: pfx_pages/pfx_len/q_pos must be int32")
    KVH = KD // Dh if Dh else 0
    if Dh not in HEAD_DIMS or KD != KVH * Dh or NH % KVH:
        raise ValueError(
            f"prefix_attention_carry: unsupported NH={NH} Dh={Dh} KVH*Dh={KD}"
        )
    if (
        v_pages.shape != k_pages.shape or Pp < 1
        or tuple(pfx_len.shape) != (B,) or tuple(q_pos.shape) != (B,)
    ):
        raise ValueError(
            "prefix_attention_carry: inconsistent shapes q "
            f"{tuple(q.shape)} pages {tuple(k_pages.shape)} pfx_pages "
            f"{tuple(pfx_pages.shape)} pfx_len {tuple(pfx_len.shape)} "
            f"q_pos {tuple(q_pos.shape)}"
        )
    args = [q, k_pages, v_pages, pfx_pages, pfx_len, q_pos]
    if any(t.device != q.device for t in args):
        raise ValueError("prefix_attention_carry: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("prefix_attention_carry: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in args[:3]):
        raise ValueError("prefix_attention_carry: q/k/v must be 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=q.device)
    m0 = torch.empty((B, NH), **f32)
    l0 = torch.empty((B, NH), **f32)
    acc0 = torch.empty((B, NH, Dh), **f32)
    if B == 0:
        return m0, l0, acc0
    per, n_split = split_plan(Pp, PS, B, NH // KVH, KVH, Dh, sm_count(q.device))
    part = [None, None, None]
    if n_split > 1:
        # the partials m, l [S, B, NH] and acc [S, B, NH, Dh] in one buffer,
        # acc first: the combine reads it in 16-byte vectors
        n = n_split * B * NH
        work = torch.empty(n * (Dh + 2), **f32)
        part = [work[n * Dh : n * (Dh + 1)], work[n * (Dh + 1) :], work[: n * Dh]]
    KERNEL.launch(
        *(ptr(t) for t in args), ptr(m0), ptr(l0), ptr(acc0),
        *(ptr(t) for t in part),
        B, NH, KVH, Dh, PS, Pp, int(window), per, n_split,
        ctypes.c_float(Dh ** -0.5), stream_handle(q.device),
    )
    return m0, l0, acc0
