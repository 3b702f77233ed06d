"""Parameter loading for the PyTorch engine.

``params_from_numpy`` turns the JAX package's parameter tree, given as
numpy arrays (``{"embed", "final_norm", "layers": {...}, "lm_head"?}``
with ``[L, ...]``-stacked layer tensors), into the port's dict of
tensors, so both engines compute the same function in the tests. The
layouts are the same, so this is a checked copy. Quantized leaves, as
the reference's ``quantize_params`` returns them (``{"qw": int8 [...,
in, out], "scale": f32 [..., 1, out]}``), are carried as int8 and
float32 tensors in the same dict form (ops/quant.py).

The Hugging Face checkpoint loader of ``sutro_tpu/engine/weights.py`` is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models import transformer
from ..ops.quant import QUANT_LEAVES


def params_from_numpy(
    cfg: ModelConfig,
    tree: Mapping[str, Any],
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, Any]:
    """numpy parameter tree -> the port's parameter dict on ``device``
    in ``dtype`` (int8 leaves stay int8, their scales float32). Raises
    on a missing, extra or misshapen leaf."""
    want = {
        k: {n: s[0] for n, s in v.items()} if k == "layers" else v[0]
        for k, v in transformer.param_spec(cfg).items()
    }

    def tensor(name: str, x, shape, np_dtype, t_dtype) -> torch.Tensor:
        arr = np.array(x, dtype=np_dtype)  # a writable copy
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(shape)}")
        return torch.from_numpy(arr).to(device=device, dtype=t_dtype)

    def leaf(name: str, x, shape):
        if not isinstance(x, Mapping):
            return tensor(name, x, shape, np.float32, dtype)
        if set(x) != {"qw", "scale"} or name.split(".")[-1] not in QUANT_LEAVES:
            raise ValueError(f"{name}: not a quantized leaf: keys {sorted(x)}")
        if np.asarray(x["qw"]).dtype != np.int8:
            raise ValueError(f"{name}: qw must be int8")
        return {
            "qw": tensor(name + ".qw", x["qw"], shape, np.int8, torch.int8),
            "scale": tensor(name + ".scale", x["scale"],
                            (*shape[:-2], 1, shape[-1]), np.float32, torch.float32),
        }

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
