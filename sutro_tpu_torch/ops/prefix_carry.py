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
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .cuda_build import CudaKernel, ptr, stream_handle

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
TILE_TOKENS = 64   # prefix tokens per kernel tile (csrc TT)
QUERY_ROWS = 64    # query rows (b, g) per block (csrc QT)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "prefix_carry",
    "prefix_carry_bf16",
    [_P] * 12 + [_I] * 8 + [ctypes.c_float, _P],
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
) -> Carry:
    """Gather version of the kernel, in float32."""
    B, NH, Dh = q.shape
    NP, PS, KD = k_pages.shape
    KVH = KD // Dh
    G = NH // KVH
    Lp = pfx_pages.shape[0] * PS
    idx = pfx_pages.long()
    kp = k_pages[idx].float().reshape(Lp, KVH, Dh)
    vp = v_pages[idx].float().reshape(Lp, KVH, Dh)
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


def _n_split(n_tiles: int, blocks: int, device) -> int:
    """Splits of the prefix's tiles: enough blocks for two waves of SMs,
    and no split without a tile (the kernel gives each split
    ceil(n_tiles / splits) tiles)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_tiles, math.ceil(2 * sms / blocks)))
    return math.ceil(n_tiles / math.ceil(n_tiles / want))


def prefix_attention_carry(
    q: torch.Tensor,          # [B, NH, Dh] current-step queries
    k_pages: torch.Tensor,    # [NP, PS, KVH*Dh] one layer's fused pool
    v_pages: torch.Tensor,
    pfx_pages: torch.Tensor,  # [Pp] int32 the shared prefix's pages
    pfx_len: torch.Tensor,    # [B] int32 prefix tokens per row (0: none)
    q_pos: torch.Tensor,      # [B] int32 each query's position
    window: int = 0,          # 0 => full attention
) -> Carry:
    """Returns ``(m0 [B, NH], l0 [B, NH], acc0 [B, NH, Dh])`` float32."""
    if not q.is_cuda:
        return prefix_attention_carry_plain(
            q, k_pages, v_pages, pfx_pages, pfx_len, q_pos, window
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
    G = NH // KVH
    n_tiles = math.ceil(Pp * PS / TILE_TOKENS)
    n_split = _n_split(n_tiles, KVH * math.ceil(B * G / QUERY_ROWS), q.device)
    part = [None, None, None]
    if n_split > 1:
        part = [torch.empty((n_split, B, NH), **f32),
                torch.empty((n_split, B, NH), **f32),
                torch.empty((n_split, B, NH, Dh), **f32)]
    KERNEL.launch(
        *(ptr(t) for t in args), ptr(m0), ptr(l0), ptr(acc0),
        *(ptr(t) for t in part),
        B, NH, KVH, Dh, PS, Pp, int(window), n_split,
        ctypes.c_float(Dh ** -0.5), stream_handle(q.device),
    )
    return m0, l0, acc0
