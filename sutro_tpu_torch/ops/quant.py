"""Int8 weight-only quantization.

Port of ``sutro_tpu/ops/quant.py``. Symmetric per-output-channel int8
for the projection matrices:

- a weight ``w[..., in, out]`` becomes ``{"qw": int8, "scale": f32}``
  with ``scale[..., 1, out] = max|w| / 127`` over the reduction axis;
- at rest it takes 1 byte per element instead of 2 (bf16);
- norms, biases, routers, sinks and the token embedding stay in the
  activation dtype.

``materialize`` dequantizes a leaf right before its matrix product, as
the reference's ``models/transformer.py::_w`` does in XLA outside any
Pallas kernel; the products stay ``torch.matmul``.

Quantization works on tensors on any device, one leading-axis slice
(and, for a 2-D leaf, one block of output columns) at a time, so a
``[64, 5120, 25600]`` leaf never exists as float32 (33.5 GB).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

# leaves (by name) that get int8 treatment: the big matmul operands
QUANT_LEAVES = frozenset(
    {
        "wq", "wk", "wv", "wo",
        "w_gate", "w_up", "w_down",
        "we_gate", "we_up", "we_down",
        "lm_head",
    }
)

COLUMN_BLOCK = 8192  # output columns per float32 temporary of a 2-D leaf


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "qw" in leaf and "scale" in leaf


def quantized_empty(shape, device) -> Dict[str, torch.Tensor]:
    """Uninitialized ``{"qw", "scale"}`` buffers for a ``w[..., in, out]``
    of ``shape``."""
    return {
        "qw": torch.empty(shape, dtype=torch.int8, device=device),
        "scale": torch.empty(
            (*shape[:-2], 1, shape[-1]), dtype=torch.float32, device=device
        ),
    }


def quantize_into(w: torch.Tensor, out: Dict[str, torch.Tensor]) -> None:
    """Quantize ``w[..., in, out]`` into ``out`` (:func:`quantized_empty`)
    with the reference's formula: ``scale = max(amax, 1e-8) / 127`` over
    axis -2, ``qw = clip(round(w / scale), -127, 127)``, an f32 division
    rounded half to even (``torch.round`` and ``np.round`` agree)."""
    if w.dim() > 2:
        for i in range(w.shape[0]):
            quantize_into(w[i], {"qw": out["qw"][i], "scale": out["scale"][i]})
        return
    for j in range(0, w.shape[-1], COLUMN_BLOCK):
        w32 = w[:, j : j + COLUMN_BLOCK].float()
        amax = w32.abs().amax(dim=-2, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        out["qw"][:, j : j + COLUMN_BLOCK] = torch.clamp(
            torch.round(w32 / scale), -127, 127
        ).to(torch.int8)
        out["scale"][:, j : j + COLUMN_BLOCK] = scale


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 over the reduction (second to
    last) axis. ``w[..., in, out] -> qw int8 + scale[..., 1, out]``."""
    out = quantized_empty(w.shape, w.device)
    quantize_into(w, out)
    return out


def materialize(leaf: Any, dtype: torch.dtype) -> torch.Tensor:
    """Quantized dict -> dequantized tensor in ``dtype``; plain tensors
    pass through. The reference's float32 product ``qw * scale``, rounded
    once to ``dtype``, in one elementwise pass that reads the int8 values
    and writes ``dtype`` (no float32 copy of the weight)."""
    if not is_quantized(leaf):
        return leaf
    qw = leaf["qw"]
    out = torch.empty(qw.shape, dtype=dtype, device=qw.device)
    return torch.mul(qw, leaf["scale"], out=out)


def quantize_params(params: Any) -> Any:
    """Quantize every QUANT_LEAVES tensor in the parameter dict (stacked
    layer layouts included: the channel axis is always last)."""

    def visit(d: Any) -> Any:
        if not isinstance(d, dict):
            return d
        out = {}
        for name, leaf in d.items():
            if isinstance(leaf, dict):
                out[name] = visit(leaf)
            elif name in QUANT_LEAVES:
                out[name] = quantize_weight(leaf)
            else:
                out[name] = leaf
        return out

    return visit(params)


def tensors(params: Any):
    """Every tensor of a (possibly quantized) parameter dict."""
    if isinstance(params, dict):
        for v in params.values():
            yield from tensors(v)
    elif torch.is_tensor(params):
        yield params


def params_bytes(params: Any) -> int:
    """Bytes at rest: int8 leaves and their scales at their own widths."""
    return int(sum(t.numel() * t.element_size() for t in tensors(params)))
