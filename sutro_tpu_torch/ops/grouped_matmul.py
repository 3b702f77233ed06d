"""Grouped matmul (the MoE expert GEMM): the CUDA kernel's wrapper and
its plain version.

Port of ``sutro_tpu/ops/pallas_gmm.py::grouped_matmul``, with the
contract of ``jax.lax.ragged_dot``: rows of ``lhs [M, H]`` are sorted
by group, ``group_sizes [E]`` int32 counts them (summing to at most
``M``; empty groups allowed), and ``out[i] = lhs[i] @ rhs[g(i)]`` for
``rhs [E, H, F]``, accumulated in float32 and returned in ``lhs``'s
dtype; rows past the last group are zero.

The group sizes never come to the host on the card: the kernel reads
them on the device (csrc/grouped_matmul.cu), so the fused decode window
chains through the MoE layers without a host wait.

On a CUDA tensor the wrapper launches ``csrc/grouped_matmul.cu`` (one
``wgmma``/TMA kernel for every M) or raises; on a CPU tensor it runs
:func:`grouped_matmul_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, ptr, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "grouped_matmul",
    "grouped_matmul_bf16",
    [_P] * 4 + [_I] * 4 + [_P],
    replaces="sutro_tpu/ops/pallas_gmm.py:67",
)
MAX_EXPERTS = 1024  # the kernel's tile table in shared memory (csrc MAX_EXPERTS)


def grouped_matmul_plain(
    lhs: torch.Tensor,          # [M, H] rows sorted by group
    rhs: torch.Tensor,          # [E, H, F]
    group_sizes: torch.Tensor,  # [E] int32
) -> torch.Tensor:
    """One float32 product per group (reads the sizes on the host);
    rows past ``sum(group_sizes)`` are zero, as in ``ragged_dot``."""
    M = lhs.shape[0]
    out = torch.zeros((M, rhs.shape[2]), dtype=lhs.dtype, device=lhs.device)
    start = 0
    # the wrapper runs this for CPU tensors only: no card to wait for
    # graftlint: disable=jit-host-sync
    for e, n in enumerate(group_sizes.tolist()):
        if n > 0:
            out[start : start + n] = (
                lhs[start : start + n].float() @ rhs[e].float()
            ).to(lhs.dtype)
        start += max(n, 0)
    return out


def grouped_matmul(
    lhs: torch.Tensor,          # [M, H] rows sorted by group
    rhs: torch.Tensor,          # [E, H, F]
    group_sizes: torch.Tensor,  # [E] int32, sum <= M
) -> torch.Tensor:
    """Returns ``[M, F]`` with ``out[i] = lhs[i] @ rhs[g(i)]`` (zero past
    the last group)."""
    if not lhs.is_cuda:
        return grouped_matmul_plain(lhs, rhs, group_sizes)
    if lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16:
        raise TypeError(
            f"grouped_matmul: the kernel takes bfloat16, got {lhs.dtype} {rhs.dtype}"
        )
    if group_sizes.dtype != torch.int32:
        raise TypeError("grouped_matmul: group_sizes must be int32")
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(
            f"grouped_matmul: lhs {tuple(lhs.shape)} rhs {tuple(rhs.shape)} "
            f"group_sizes {tuple(group_sizes.shape)}"
        )
    M, H = lhs.shape
    E, H2, F = rhs.shape
    if H2 != H or group_sizes.shape[0] != E or not 1 <= E <= MAX_EXPERTS or H % 8 or F % 8:
        raise ValueError(
            f"grouped_matmul: unsupported shapes lhs {tuple(lhs.shape)} rhs "
            f"{tuple(rhs.shape)} group_sizes {tuple(group_sizes.shape)} "
            f"(H and F must be multiples of 8, 1 <= E <= {MAX_EXPERTS})"
        )
    args = (lhs, rhs, group_sizes)
    if any(t.device != lhs.device for t in args):
        raise ValueError("grouped_matmul: tensors on different devices")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("grouped_matmul: tensors must be contiguous")
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("grouped_matmul: lhs/rhs must be 16-byte aligned")
    out = torch.empty((M, F), dtype=lhs.dtype, device=lhs.device)
    if M == 0:
        return out
    KERNEL.launch(
        ptr(lhs), ptr(rhs), ptr(group_sizes), ptr(out), M, H, F, E,
        stream_handle(lhs.device),
    )
    return out
