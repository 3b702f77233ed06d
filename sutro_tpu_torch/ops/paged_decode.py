"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain
version.

Port of ``sutro_tpu/ops/pallas_paged.py::paged_decode_attention``. One
query token per row attends over the row's pages (walk bounded by
``past_len``), the fused decode window's slots that are not in the pool
yet (slot ``s < win_len`` sits at position ``past_len + s``), and the
current token (at ``past_len + win_len``). Per-layer sliding window;
the attention sink joins the softmax denominator only.

The pool carries the fused ``[NP, PS, KVH*Dh]`` layout of
engine/kvcache.py. The reference's int8 pages and shared-prefix
(Hydragen) carry options are not ported yet (ROADMAP.md).

On a CUDA tensor the wrapper launches ``csrc/paged_decode.cu`` or
raises; on a CPU tensor it runs :func:`paged_decode_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CudaKernel, ptr, stream_handle

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_GROUP_WIDTH = 2048  # G * Dh per block (the kernel's register budget)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "paged_decode",
    "paged_decode_bf16",
    [_P] * 11 + [_I] * 9 + [ctypes.c_float, _P],
    replaces="sutro_tpu/ops/pallas_paged.py:713",
)


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
) -> torch.Tensor:
    """Gather-and-softmax version of the kernel, in float32."""
    B, NH, Dh = q.shape
    KVH = k_cur.shape[1]
    G = NH // KVH
    MP = page_table.shape[1]
    PS = k_pages.shape[1]
    ctx = MP * PS
    dev = q.device
    idx = page_table.long().reshape(-1)
    keys = [k_pages[idx].reshape(B, ctx, KVH, Dh)]
    vals = [v_pages[idx].reshape(B, ctx, KVH, Dh)]
    tok = torch.arange(ctx, device=dev)
    past = past_len.long()
    pos = past + int(win_len)                           # [B] query position
    key_pos = [tok[None].expand(B, ctx)]
    valid = [tok[None] < past[:, None]]
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
    qg = q.float().reshape(B, KVH, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, keys) * Dh ** -0.5
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if sink is not None:
        col = sink.float().reshape(1, KVH, G, 1).expand(B, KVH, G, 1)
        w = torch.softmax(torch.cat([s, col], -1), -1)[..., :-1]
    else:
        w = torch.softmax(s, -1)
    out = torch.einsum("bkgs,bskd->bkgd", w, vals)
    return out.reshape(B, NH, Dh).to(q.dtype)


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
) -> torch.Tensor:
    """Returns ``[B, NH, Dh]`` attention outputs for one decode step.

    Contract (as in the reference): ``past_len[b] <= MP * PS``; an
    inactive row has an all-zero table and ``past_len`` 0 and attends
    to its current token only."""
    if not q.is_cuda:
        return paged_decode_plain(
            q, k_pages, v_pages, page_table, past_len, k_cur, v_cur,
            window, sink, win_k, win_v, win_len,
        )
    B, NH, Dh = q.shape
    NP, PS, KD = k_pages.shape
    KVH = k_cur.shape[1]
    MP = page_table.shape[1]
    W = 0 if win_k is None else win_k.shape[1]
    bf16 = [q, k_pages, v_pages, k_cur, v_cur] + (
        [win_k, win_v] if W else []
    )
    if any(t.dtype != torch.bfloat16 for t in bf16):
        raise TypeError("paged_decode_attention: the kernel takes bfloat16 q/k/v")
    if page_table.dtype != torch.int32 or past_len.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table/past_len must be int32")
    if Dh not in HEAD_DIMS or NH % KVH or (NH // KVH) * Dh > MAX_GROUP_WIDTH:
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
    args = [q, k_pages, v_pages, page_table, past_len, k_cur, v_cur] + (
        [win_k, win_v] if W else []
    ) + ([sink] if sink is not None else [])
    if any(t.device != q.device for t in args):
        raise ValueError("paged_decode_attention: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("paged_decode_attention: tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    KERNEL.launch(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(page_table), ptr(past_len),
        ptr(k_cur), ptr(v_cur), ptr(win_k if W else None),
        ptr(win_v if W else None), ptr(sink), ptr(out),
        B, NH, KVH, Dh, PS, MP, W, int(win_len), int(window),
        ctypes.c_float(Dh ** -0.5), stream_handle(q.device),
    )
    return out
