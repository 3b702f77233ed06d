"""Paged KV cache.

Port of ``sutro_tpu/engine/kvcache.py``. Layout:

- ``k_pages`` / ``v_pages``: ``[L, NP, PS, KVH*Dh]`` device tensors.
  Page 0 is a reserved garbage page: padding rows' tables point at it,
  and the page write drops every token bound for it. The KV-head and
  head-dim axes are stored FUSED as one trailing axis, the layout the
  reference's kernels read; the CUDA kernels keep it, so a token's
  K (or V) row of one layer is one contiguous ``KVH*Dh`` run.
- ``page_table``: host-side ``numpy`` ``[B, MP]`` int32, uploaded with
  each step. Pages are allocated/freed by a host-side free list.

``write_kv`` lands a chunk's K/V into the pages IN PLACE (the reference
returned a new cache; PyTorch tensors are mutable, and copying a
multi-GB pool per write is exactly what the in-place kernel avoids).
``gather_kv_layer`` produces one layer's contiguous ``[B, CTX, KVH, Dh]``
view for the dense attention path (T > 1 over paged past).

The int8 pool (``EngineConfig.kv_quantize``) is not ported yet.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..ops.kv_write import kv_write
from .config import EngineConfig


@dataclasses.dataclass
class KVCache:
    k_pages: torch.Tensor  # [L, NP, PS, KVH*Dh]
    v_pages: torch.Tensor  # [L, NP, PS, KVH*Dh]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]


def alloc_cache(
    mcfg: ModelConfig, ecfg: EngineConfig, num_pages: int,
    dtype: torch.dtype = torch.bfloat16, device="cuda",
) -> KVCache:
    if getattr(ecfg, "kv_quantize", None):
        raise NotImplementedError(
            "int8 KV pages (kv_quantize) are not ported to the CUDA "
            "engine yet (queued in ROADMAP.md)"
        )
    shape = (
        mcfg.num_layers,
        num_pages,
        ecfg.kv_page_size,
        mcfg.num_kv_heads * mcfg.head_dim,
    )
    return KVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
    )


class PageAllocator:
    """Host-side page allocator. Page 0 is reserved as the garbage page.

    Allocation is CONTIGUOUS-FIRST: a slot's reserved pages form one
    ascending run whenever a large-enough hole exists (first-fit over
    the sorted free set), falling back to scattered pages otherwise.
    Correctness never depends on contiguity (the kernel and the gather
    path accept any table)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))  # sorted asc

    def alloc(self, n: int = 1) -> List[int]:
        free = self._free
        if len(free) < n:
            raise MemoryError(
                f"KV cache out of pages (requested {n}, free {len(free)})"
            )
        # first-fit contiguous run over the sorted free list
        run_start = 0
        run_len = 1
        for i in range(1, len(free)):
            if free[i] == free[i - 1] + 1:
                run_len += 1
                if run_len == n:
                    pages = free[run_start : run_start + n]
                    del free[run_start : run_start + n]
                    return pages
            else:
                run_start = i
                run_len = 1
        if n == 1 and free:
            return [free.pop(0)]
        # no hole big enough: scattered fallback (ascending)
        pages = free[:n]
        del free[:n]
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p != 0:
                bisect.insort(self._free, p)

    def reserve(self, pages: List[int]) -> None:
        """Remove SPECIFIC page ids from the free list (pages owned by a
        store that outlives the batcher session). Atomic: raises
        KeyError leaving the free list untouched if any id (or
        duplicate) is not currently free."""
        free = self._free
        want = sorted(int(p) for p in pages)
        for a, b in zip(want, want[1:]):
            if a == b:
                raise KeyError(f"duplicate page id {a} in reserve()")
        for p in want:
            i = bisect.bisect_left(free, p)
            if i >= len(free) or free[i] != p:
                raise KeyError(f"page {p} is not free (cannot reserve)")
        drop = set(want)
        self._free = [p for p in free if p not in drop]

    @property
    def free_count(self) -> int:
        return len(self._free)


def pages_needed(length: int, page_size: int) -> int:
    return (length + page_size - 1) // page_size


def write_kv(
    cache: KVCache,
    k_chunk: torch.Tensor,       # [L, B, T, KVH, Dh] or fused [L, B, T, KD]
    v_chunk: torch.Tensor,
    page_table: torch.Tensor,    # [B, MP] int32
    start: torch.Tensor,         # [B] int32 global position of chunk token 0
    valid_len: torch.Tensor,     # [B] int32 real tokens in chunk
) -> None:
    """Write a chunk's K/V into the cache's pages IN PLACE (the kernel
    of ops/kv_write.py on the card). Padding tokens and tokens bound
    for the garbage page 0 are dropped."""
    L, B, T = k_chunk.shape[:3]
    KD = cache.k_pages.shape[-1]
    dt = cache.k_pages.dtype
    kv_write(
        cache.k_pages, cache.v_pages,
        k_chunk.reshape(L, B, T, KD).to(dt).contiguous(),
        v_chunk.reshape(L, B, T, KD).to(dt).contiguous(),
        page_table, start, valid_len,
    )


def gather_kv_layer(
    k_pages_l: torch.Tensor,   # [NP, PS, KVH*Dh] one layer's pages
    v_pages_l: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer page gather: [B, MP] table -> ([B, CTX, KVH, Dh]) x2,
    CTX = MP * PS, for the dense attention path (the paged kernel
    reads pages in place and skips this copy)."""
    NP, PS, KD = k_pages_l.shape
    B, MP = page_table.shape
    idx = page_table.long().reshape(-1)
    k = k_pages_l[idx].reshape(B, MP * PS, kv_heads, KD // kv_heads)
    v = v_pages_l[idx].reshape(B, MP * PS, kv_heads, KD // kv_heads)
    return k, v


def make_page_table(rows: List[List[int]], max_pages: int) -> np.ndarray:
    """Pad per-slot page lists to a dense [B, MP] int32 table (garbage page 0)."""
    out = np.zeros((len(rows), max_pages), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
