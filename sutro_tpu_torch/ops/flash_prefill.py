"""Causal flash prefill attention: the CUDA kernel's wrapper and its
plain version.

Port of ``sutro_tpu/ops/pallas_flash.py::flash_prefill``. Contract, as
in the reference: self-attention over a chunk with NO past, so query and
key positions are ``[0, T)``. Padding tails (``t >= valid_len``) are
computed and discarded by the caller: a padded query only attends
causally, so every used position sees real keys only. GQA, per-layer
sliding window, attention sink in the denominator at finalize; f32 math.

The reference gated its TPU kernel on shapes (``T % 128 == 0``,
``Dh % 128 == 0``); this kernel takes every ``T`` and ``Dh`` in
{64, 128, 256}.

On a CUDA tensor the wrapper launches ``csrc/flash_prefill.cu`` or
raises; on a CPU tensor it runs :func:`flash_prefill_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CudaKernel, ptr, stream_handle

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "flash_prefill",
    "flash_prefill_bf16",
    [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P],
    replaces="sutro_tpu/ops/pallas_flash.py:167",
)


def flash_prefill_plain(
    q: torch.Tensor,           # [B, T, NH, Dh]
    k: torch.Tensor,           # [B, T, KVH, Dh]
    v: torch.Tensor,
    *,
    window: int = 0,
    sink: Optional[torch.Tensor] = None,  # [NH]
) -> torch.Tensor:
    """Dense masked-softmax version of the kernel, in float32."""
    B, T, NH, Dh = q.shape
    KVH = k.shape[2]
    G = NH // KVH
    pos = torch.arange(T, device=q.device)
    ok = pos[None, :] <= pos[:, None]                     # [Tq, Tk]
    if window > 0:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    qg = q.float().reshape(B, T, KVH, G, Dh)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * Dh ** -0.5
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    if sink is not None:
        col = sink.float().reshape(1, KVH, G, 1, 1).expand(B, KVH, G, T, 1)
        w = torch.softmax(torch.cat([s, col], -1), -1)[..., :-1]
    else:
        w = torch.softmax(s, -1)
    out = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return out.reshape(B, T, NH, Dh).to(q.dtype)


def flash_prefill(
    q: torch.Tensor,           # [B, T, NH, Dh]
    k: torch.Tensor,           # [B, T, KVH, Dh] (post-RoPE)
    v: torch.Tensor,
    *,
    window: int = 0,           # 0 => full attention
    sink: Optional[torch.Tensor] = None,  # [NH] logits
) -> torch.Tensor:
    """Returns ``[B, T, NH, Dh]`` causal self-attention over the chunk."""
    if not q.is_cuda:
        return flash_prefill_plain(q, k, v, window=window, sink=sink)
    B, T, NH, Dh = q.shape
    KVH = k.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_prefill: the kernel takes bfloat16 q/k/v")
    if Dh not in HEAD_DIMS or NH % KVH:
        raise ValueError(f"flash_prefill: unsupported NH={NH} KVH={KVH} Dh={Dh}")
    if tuple(k.shape) != (B, T, KVH, Dh) or v.shape != k.shape:
        raise ValueError("flash_prefill: inconsistent shapes")
    if sink is not None:
        if tuple(sink.shape) != (NH,):
            raise ValueError("flash_prefill: sink must be [NH]")
        sink = sink.float().contiguous()
    args = (q, k, v) + ((sink,) if sink is not None else ())
    if any(t.device != q.device for t in args):
        raise ValueError("flash_prefill: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("flash_prefill: tensors must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    KERNEL.launch(
        ptr(q), ptr(k), ptr(v), ptr(sink), ptr(out),
        B, T, NH, KVH, Dh, int(window), ctypes.c_float(Dh ** -0.5),
        stream_handle(q.device),
    )
    return out
