"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain
version.

Port of ``sutro_tpu/ops/pallas_paged.py::paged_decode_attention``. One
query token per row attends over the row's pages (walk bounded by
``past_len``), the fused decode window's slots that are not in the pool
yet (slot ``s < win_len`` sits at position ``past_len + s``), and the
current token (at ``past_len + win_len``). Per-layer sliding window;
the attention sink joins the softmax denominator only.

The pool carries the fused ``[NP, PS, KVH*Dh]`` layout of
engine/kvcache.py. The reference's int8 pages are not ported yet
(ROADMAP.md).

Carry option (the reference's shared-prefix mode): with ``pfx_cnt``
``[B]``, row ``b`` skips its first ``pfx_cnt[b]`` pages and starts its
online softmax from the injected carry ``m0``/``l0`` ``[B, NH]``,
``acc0`` ``[B, NH, Dh]`` float32 (ops/prefix_carry.py computes it once
for a job-shared prefix). A row with ``pfx_cnt`` 0 and the cold carry
(-1e30, 0, 0) is a plain row. The sink still joins once, in the final
denominator.

On a CUDA tensor the wrapper launches ``csrc/paged_decode.cu`` or
raises; on a CPU tensor it runs :func:`paged_decode_plain`. Launches
with the carry count on ``CARRY``, the others on ``KERNEL``.
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
_ARGS = [_P] * 15 + [_I] * 9 + [ctypes.c_float, _P]
KERNEL = CudaKernel(
    "paged_decode", "paged_decode_bf16", _ARGS,
    replaces="sutro_tpu/ops/pallas_paged.py:713",
)
CARRY = CudaKernel(
    "paged_decode_carry", "paged_decode_bf16", _ARGS,
    replaces="sutro_tpu/ops/pallas_paged.py:713 (pfx_cnt/m0/l0/acc0, :734-743)",
    source="paged_decode",
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
    pfx_cnt: Optional[torch.Tensor] = None,  # [B] int32 pages to skip
    m0: Optional[torch.Tensor] = None,       # [B, NH] f32 carry
    l0: Optional[torch.Tensor] = None,
    acc0: Optional[torch.Tensor] = None,     # [B, NH, Dh] f32
) -> torch.Tensor:
    """Gather version of the kernel: one online-softmax step from the
    carry (the cold carry without one) over every key, in float32."""
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
) -> torch.Tensor:
    """Returns ``[B, NH, Dh]`` attention outputs for one decode step.

    Contract (as in the reference): ``past_len[b] <= MP * PS``; an
    inactive row has an all-zero table and ``past_len`` 0 and attends
    to its current token only; with the carry, ``pfx_cnt[b] * PS <=
    past_len[b]``."""
    carry = pfx_cnt is not None
    if carry and (m0 is None or l0 is None or acc0 is None):
        raise ValueError("paged_decode_attention: pfx_cnt needs m0, l0 and acc0")
    if not q.is_cuda:
        return paged_decode_plain(
            q, k_pages, v_pages, page_table, past_len, k_cur, v_cur,
            window, sink, win_k, win_v, win_len, pfx_cnt, m0, l0, acc0,
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
    )
    if any(t.device != q.device for t in args):
        raise ValueError("paged_decode_attention: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("paged_decode_attention: tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    (CARRY if carry else KERNEL).launch(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(page_table), ptr(past_len),
        ptr(k_cur), ptr(v_cur), ptr(win_k if W else None),
        ptr(win_v if W else None), ptr(sink), ptr(pfx_cnt), ptr(m0),
        ptr(l0), ptr(acc0), ptr(out),
        B, NH, KVH, Dh, PS, MP, W, int(win_len), int(window),
        ctypes.c_float(Dh ** -0.5), stream_handle(q.device),
    )
    return out
