"""Weight and activation rounding for the reference and its controls.

- ``int_round_trip(w, 8)``: symmetric per-output-channel int8, the
  weight-only int8 that an int8 configuration states: ``scale =
  max(amax over the input axis, 1e-8) / 127``, ``q = clip(round(w /
  scale), -127, 127)``, values ``q * scale`` in float32. ``bits=4`` is
  the same with 7 levels a side (the int4 control).
- ``fp8_round_trip(x)``: float8 e4m3 with a scale per row (per output
  channel of a weight ``[out, in]``, per token of an activation
  ``[N, in]``) that maps the row's largest magnitude to 448 (the fp8
  control).
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def int_round_trip(w: torch.Tensor, bits: int = 8, block: int = 4096) -> torch.Tensor:
    """``w [..., out, in]`` -> float32 values of its per-channel round trip."""
    levels = (1 << (bits - 1)) - 1
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    flat_w, flat_o = w.reshape(-1, w.shape[-1]), out.view(-1, w.shape[-1])
    for a in range(0, flat_w.shape[0], block):
        x = flat_w[a : a + block].float()
        scale = x.abs().amax(-1, keepdim=True).clamp(min=1e-8) / levels
        flat_o[a : a + block] = torch.clamp(torch.round(x / scale), -levels, levels) * scale
    return out


def fp8_round_trip(x: torch.Tensor, block: int = 4096) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    flat_x, flat_o = x.reshape(-1, x.shape[-1]), out.view(-1, x.shape[-1])
    for a in range(0, flat_x.shape[0], block):
        r = flat_x[a : a + block].float()
        scale = r.abs().amax(-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
        flat_o[a : a + block] = (r / scale).to(torch.float8_e4m3fn).float() * scale
    return out
