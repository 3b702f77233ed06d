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

int8 pool (``EngineConfig.kv_quantize = "int8"``): int8 pages plus
per-TOKEN dequantization scales ``k_scale``/``v_scale`` ``[L, NP, PS]``
float32 (amax / 127 over the fused ``KVH*Dh`` axis), so a decode append
quantizes once and no page is ever rescaled. As in the reference, its
pages are written by plain tensor indexing (the page-write kernel is
bf16-only there too), and read by the paged-decode kernel's int8
option or dequantized by ``gather_kv_layer``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..ops.kv_write import kv_write
from .config import EngineConfig


@dataclasses.dataclass
class KVCache:
    k_pages: torch.Tensor  # [L, NP, PS, KVH*Dh] bf16, or int8 quantized
    v_pages: torch.Tensor  # [L, NP, PS, KVH*Dh]
    # int8 KV mode: per-token dequantization scales
    k_scale: Optional[torch.Tensor] = None  # [L, NP, PS] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def alloc_cache(
    mcfg: ModelConfig, ecfg: EngineConfig, num_pages: int,
    dtype: torch.dtype = torch.bfloat16, device="cuda",
    layers: Optional[int] = None, kv_heads: Optional[int] = None,
) -> KVCache:
    """The pool; under a mesh a rank's block of it: ``layers`` (L/pp)
    and ``kv_heads`` (KVH/tp) of the model's."""
    shape = (
        layers or mcfg.num_layers,
        num_pages,
        ecfg.kv_page_size,
        (kv_heads or mcfg.num_kv_heads) * mcfg.head_dim,
    )
    mode = getattr(ecfg, "kv_quantize", None)
    if mode == "int8":
        return KVCache(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        )
    if mode:
        raise ValueError(f"Unknown kv_quantize mode {mode!r} (only 'int8')")
    return KVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
    )


def _quantize_tokens(
    x: torch.Tensor, amax_group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., KD] float -> (int8 values, f32 per-token scales [...]),
    the reference's formula: ``scale = max(amax / 127, 1e-8)``. Under TP
    (``amax_group``: the mesh's ``model`` group) a rank holds a block of
    KD; the reference's scale is over the FULL fused axis, so the amax
    is MAX-reduced over the group first and the shards agree."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if amax_group is not None:
        amax_group.all_reduce(amax, "max")
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


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
    amax_group=None,             # int8 pool under TP (_quantize_tokens)
) -> None:
    """Write a chunk's K/V into the cache's pages IN PLACE (the kernel
    of ops/kv_write.py on the card; an int8 pool quantizes per token
    and scatters values and scales by tensor indexing). Padding tokens
    and tokens bound for the garbage page 0 are dropped."""
    L, B, T = k_chunk.shape[:3]
    KD = cache.k_pages.shape[-1]
    if cache.quantized:
        _write_quantized(cache, k_chunk.reshape(L, B, T, KD),
                         v_chunk.reshape(L, B, T, KD), page_table, start, valid_len,
                         amax_group)
        return
    dt = cache.k_pages.dtype
    kv_write(
        cache.k_pages, cache.v_pages,
        k_chunk.reshape(L, B, T, KD).to(dt).contiguous(),
        v_chunk.reshape(L, B, T, KD).to(dt).contiguous(),
        page_table, start, valid_len,
    )


def _write_quantized(cache, k, v, page_table, start, valid_len, amax_group=None) -> None:
    """The int8 pool's write (the reference's ``write_kv`` quantized
    branch): quantize per token, then scatter values and scales. Tokens
    to drop are sent to flat slot 0 (page 0) carrying slot 0's current
    contents, so the scatter needs no host-side mask (no wait for the
    card) and page 0 keeps what it held."""
    L, B, T, KD = k.shape
    NP, PS, MP = cache.num_pages, cache.page_size, page_table.shape[1]
    dev = k.device
    t = torch.arange(T, device=dev)
    pos = start.long()[:, None] + t[None]                          # [B, T]
    page = page_table.long().gather(1, (pos // PS).clamp(max=MP - 1))
    keep = ((t[None] < valid_len.long()[:, None]) & (page > 0)).reshape(-1)
    flat = torch.where(keep, (page * PS + pos % PS).reshape(-1), 0)
    for pages, scales, x in ((cache.k_pages, cache.k_scale, k),
                             (cache.v_pages, cache.v_scale, v)):
        q, sc = _quantize_tokens(x.reshape(L, B * T, KD), amax_group)
        pf = pages.view(L, NP * PS, KD)
        sf = scales.view(L, NP * PS)
        pf[:, flat] = torch.where(keep[None, :, None], q, pf[:, :1])
        sf[:, flat] = torch.where(keep[None], sc, sf[:, :1])


def gather_kv_layer(
    k_pages_l: torch.Tensor,   # [NP, PS, KVH*Dh] one layer's pages
    v_pages_l: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    kv_heads: int,
    k_scale_l: Optional[torch.Tensor] = None,  # [NP, PS] (int8 KV mode)
    v_scale_l: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,   # dequant target; None => f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer page gather: [B, MP] table -> ([B, CTX, KVH, Dh]) x2,
    CTX = MP * PS, for the dense attention path (the paged kernel
    reads pages in place and skips this copy). With int8 scales the
    gathered pages are dequantized (the f32 product, rounded once) into
    ``out_dtype``, the caller's compute dtype."""
    NP, PS, KD = k_pages_l.shape
    B, MP = page_table.shape
    idx = page_table.long().reshape(-1)
    k = k_pages_l[idx]
    v = v_pages_l[idx]
    if k_scale_l is not None:
        dt = out_dtype or torch.float32
        k = torch.mul(k, k_scale_l[idx][..., None],
                      out=torch.empty(k.shape, dtype=dt, device=k.device))
        v = torch.mul(v, v_scale_l[idx][..., None],
                      out=torch.empty(v.shape, dtype=dt, device=v.device))
    return (k.reshape(B, MP * PS, kv_heads, KD // kv_heads),
            v.reshape(B, MP * PS, kv_heads, KD // kv_heads))


def make_page_table(rows: List[List[int]], max_pages: int) -> np.ndarray:
    """Pad per-slot page lists to a dense [B, MP] int32 table (garbage page 0)."""
    out = np.zeros((len(rows), max_pages), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
