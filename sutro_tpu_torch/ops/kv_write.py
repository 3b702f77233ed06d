"""In-place KV page write: the CUDA kernel's wrapper and its plain
version.

Port of ``sutro_tpu/ops/pallas_kv.py::kv_write_pallas``. Row ``b``'s
chunk token ``t < valid_len[b]`` lands in every layer's pool at page
``page_table[b, (start[b] + t) // PS]``, page row ``(start[b] + t) % PS``.
Tokens whose page is the garbage page 0, or whose page index falls
outside the table, are dropped, so pages >= 1 are only ever written by
real tokens.

Unlike the reference, which returned new pools, both versions update
``k_pages``/``v_pages`` IN PLACE and return nothing.

On a CUDA tensor the wrapper launches ``csrc/kv_write.cu`` or raises;
on a CPU tensor it runs :func:`kv_write_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, ptr, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "kv_write",
    "kv_write_bf16",
    [_P] * 7 + [_I] * 7 + [_P],
    replaces="sutro_tpu/ops/pallas_kv.py:141",
)


def kv_write_plain(
    k_pages: torch.Tensor,     # [L, NP, PS, KD]
    v_pages: torch.Tensor,
    k_new: torch.Tensor,       # [L, B, Tb, KD]
    v_new: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    start: torch.Tensor,       # [B] int32 global position of token 0
    valid_len: torch.Tensor,   # [B] int32 real tokens in the chunk
) -> None:
    """Index-put version of the kernel (in place)."""
    L, NP, PS, KD = k_pages.shape
    Tb = k_new.shape[2]
    MP = page_table.shape[1]
    t = torch.arange(Tb, device=k_pages.device)
    pos = start.long()[:, None] + t[None]                  # [B, Tb]
    pi = torch.div(pos, PS, rounding_mode="floor")
    ok = (t[None] < valid_len.long()[:, None]) & (pi < MP) & (pos >= 0)
    page = page_table.long().gather(1, pi.clamp(0, MP - 1))
    ok = ok & (page > 0) & (page < NP)
    b_idx, t_idx = ok.nonzero(as_tuple=True)
    flat = page[b_idx, t_idx] * PS + pos[b_idx, t_idx] % PS
    k_pages.view(L, NP * PS, KD)[:, flat] = k_new[:, b_idx, t_idx].to(k_pages.dtype)
    v_pages.view(L, NP * PS, KD)[:, flat] = v_new[:, b_idx, t_idx].to(v_pages.dtype)


def kv_write(
    k_pages: torch.Tensor,     # [L, NP, PS, KD] fused page pool
    v_pages: torch.Tensor,
    k_new: torch.Tensor,       # [L, B, Tb, KD]
    v_new: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    start: torch.Tensor,       # [B] int32
    valid_len: torch.Tensor,   # [B] int32
) -> None:
    """Write a chunk's K/V into the pools in place."""
    if not k_pages.is_cuda:
        kv_write_plain(k_pages, v_pages, k_new, v_new, page_table, start, valid_len)
        return
    L, NP, PS, KD = k_pages.shape
    _, B, Tb, _ = k_new.shape
    MP = page_table.shape[1]
    args = (k_pages, v_pages, k_new, v_new, page_table, start, valid_len)
    if any(t.dtype != torch.bfloat16 for t in args[:4]):
        raise TypeError("kv_write: the kernel takes bfloat16 pools and chunks")
    if any(t.dtype != torch.int32 for t in args[4:]):
        raise TypeError("kv_write: page_table/start/valid_len must be int32")
    if (
        KD % 8
        or v_pages.shape != k_pages.shape
        or tuple(k_new.shape) != (L, B, Tb, KD)
        or v_new.shape != k_new.shape
        or tuple(page_table.shape) != (B, MP)
        or tuple(start.shape) != (B,)
        or tuple(valid_len.shape) != (B,)
    ):
        raise ValueError("kv_write: inconsistent shapes")
    if any(t.device != k_pages.device for t in args):
        raise ValueError("kv_write: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("kv_write: tensors must be contiguous")
    if B == 0 or Tb == 0:
        return
    KERNEL.launch(
        ptr(k_pages), ptr(v_pages), ptr(k_new), ptr(v_new), ptr(page_table),
        ptr(start), ptr(valid_len), L, NP, PS, KD, B, Tb, MP,
        stream_handle(k_pages.device),
    )
