"""Analytic roofline self-grading (a copy of
``sutro_tpu/engine/roofline.py``, with an H100 row).

Every captured number grades itself against the hardware roofline, so
wins and regressions are machine-readable without hand math. No engine
import: the doctor and bench scripts use it on documents alone.

Decode at batch B moves, per step:
  param_bytes                  (every weight read once per step)
+ B * avg_ctx * L * 2 * KVH * Dh * kv_bytes     (KV read)
+ B * L * 2 * KVH * Dh * kv_bytes               (KV write)
so roofline tok/s/chip = B / (bytes_per_step / HBM_BW), and
pct_hbm_roofline = measured / roofline. Prefill is compute-bound:
MFU = 2 * n_params * tok/s / peak_FLOPs (standard inference-forward
approximation; attention FLOPs excluded, so this slightly overstates
the roofline and understates MFU at long contexts — a conservative
grade).

Hardware table: public chip specs (HBM GB/s, dense bf16 peak TFLOP/s),
matched by substring against the device kind the runner reports
(``torch.cuda.get_device_name``, e.g. "NVIDIA H100 80GB HBM3").
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

# device_kind substring (lowercased) -> (HBM GB/s, bf16 peak TFLOP/s)
_HW: Dict[str, Tuple[float, float]] = {
    # H100 SXM (NVIDIA data sheet, 700 W): HBM3 at 3.35 TB/s, 989 dense
    # bf16 TFLOP/s; the kind reads "NVIDIA H100 80GB HBM3"
    "h100": (3350.0, 989.0),
    "v5 lite": (819.0, 197.0),   # v5e reports kind "TPU v5 lite"
    "v5litepod": (819.0, 197.0),
    "v5e": (819.0, 197.0),
    "v5p": (2765.0, 459.0),
    "v6 lite": (1640.0, 918.0),  # Trillium / v6e
    "v6e": (1640.0, 918.0),
    "v4": (1228.0, 275.0),
}


def hw_specs(device_kind: str) -> Optional[Tuple[float, float]]:
    """(HBM GB/s, bf16 peak TFLOP/s) for a ``device_kind`` string,
    or None when unknown (CPU, emulators): grades are then omitted
    rather than fabricated against a made-up roofline."""
    kind = (device_kind or "").lower()
    for key, specs in _HW.items():
        if key in kind:
            return specs
    return None


def decode_bytes_per_step(
    *,
    param_bytes: int,
    batch: int,
    avg_ctx: float,
    num_layers: int,
    kv_heads: int,
    head_dim: int,
    kv_dtype_bytes: int = 2,
) -> float:
    kv_row = num_layers * 2 * kv_heads * head_dim * kv_dtype_bytes
    return float(param_bytes) + batch * kv_row * (avg_ctx + 1)


def grade_decode(
    tok_s_per_chip: float,
    *,
    batch: int,
    bytes_per_step: float,
    device_kind: str,
) -> Dict[str, Any]:
    """Self-grading fields for a decode throughput record."""
    out: Dict[str, Any] = {
        "analytic_bytes_per_step": int(bytes_per_step),
        "device_kind": device_kind,
    }
    specs = hw_specs(device_kind)
    if specs is None or tok_s_per_chip <= 0 or batch <= 0:
        out["pct_hbm_roofline"] = None
        return out
    hbm_gb_s, _ = specs
    steps_per_s = tok_s_per_chip / batch
    gb_s = bytes_per_step * steps_per_s / 1e9
    out["hbm_gb_s"] = hbm_gb_s
    out["bytes_gb_s"] = round(gb_s, 1)
    out["pct_hbm_roofline"] = round(100.0 * gb_s / hbm_gb_s, 1)
    return out


def grade_prefill(
    tok_s: float, *, n_params: int, device_kind: str
) -> Dict[str, Any]:
    """Self-grading fields for a prefill throughput record (MFU)."""
    out: Dict[str, Any] = {}
    specs = hw_specs(device_kind)
    if specs is None or tok_s <= 0 or n_params <= 0:
        out["mfu_prefill"] = None
        return out
    _, peak_tflops = specs
    flops = 2.0 * n_params * tok_s
    out["mfu_prefill"] = round(100.0 * flops / (peak_tflops * 1e12), 1)
    return out
