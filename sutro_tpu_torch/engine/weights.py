"""Parameter loading for the PyTorch engine.

``params_from_numpy`` turns the JAX package's parameter tree, given as
numpy arrays (``{"embed", "final_norm", "layers": {...}, "lm_head"?}``
with ``[L, ...]``-stacked layer tensors), into the port's dict of
tensors, so both engines compute the same function in the tests. The
layouts are the same, so this is a checked copy.

The Hugging Face checkpoint loader of ``sutro_tpu/engine/weights.py`` is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models import transformer


def params_from_numpy(
    cfg: ModelConfig,
    tree: Mapping[str, Any],
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, Any]:
    """numpy parameter tree -> the port's parameter dict on ``device``
    in ``dtype``. Raises on a missing, extra or misshapen leaf."""
    want = {
        k: {n: s[0] for n, s in v.items()} if k == "layers" else v[0]
        for k, v in transformer.param_spec(cfg).items()
    }

    def leaf(name: str, x, shape) -> torch.Tensor:
        if isinstance(x, Mapping):
            raise NotImplementedError(
                f"{name}: int8-quantized weights are not ported yet"
            )
        arr = np.array(x, dtype=np.float32)  # a writable copy
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    if set(tree) != set(want):
        raise ValueError(
            f"parameter tree keys {sorted(tree)} != expected {sorted(want)}"
        )
    out: Dict[str, Any] = {}
    for key, shape in want.items():
        if isinstance(shape, dict):
            layers = tree[key]
            if set(layers) != set(shape):
                raise ValueError(
                    f"layer keys {sorted(layers)} != expected {sorted(shape)}"
                )
            out[key] = {
                n: leaf(f"layers.{n}", layers[n], s) for n, s in shape.items()
            }
        else:
            out[key] = leaf(key, tree[key], shape)
    return out
