"""Parameter loading for the PyTorch engine.

``params_from_numpy`` turns the JAX package's parameter tree, given as
numpy arrays (``{"embed", "final_norm", "layers": {...}, "lm_head"?}``
with ``[L, ...]``-stacked layer tensors), into the port's dict of
tensors, so both engines compute the same function in the tests. The
layouts are the same, so this is a checked copy. Quantized leaves, as
the reference's ``quantize_params`` returns them (``{"qw": int8 [...,
in, out], "scale": f32 [..., 1, out]}``), are carried as int8 and
float32 tensors in the same dict form (ops/quant.py).

``load_checkpoint`` maps a local Hugging Face safetensors checkpoint
(``EngineConfig.weights_dir/<engine_key>/``, one file or shards with a
``model.safetensors.index.json``) into the same dict, with the mapping
of ``sutro_tpu/engine/weights.py``: per-layer tensors stacked on a
leading layer axis, projections transposed to ``[in, out]`` (HF stores
``[out, in]``), the per-expert Qwen-MoE layout and gpt-oss's fused
``gate_up`` layout with its biases, ``lm_head`` unless the embeddings
are tied, cast to the engine's parameter dtype. It needs no
``safetensors`` package: ``_ShardIndex`` reads the format itself (an
8-byte little-endian header length, a JSON header, then the raw
tensors; ``F32``, ``F16`` and ``BF16``). Every tensor's shape is checked
against the model config from the headers before anything is
allocated on the device; then each stacked leaf is allocated once on
the device and filled one tensor at a time from a memory map, so the
host never holds more than one tensor (36 layers are never stacked on
the host).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models import transformer
from ..ops.quant import QUANT_LEAVES, quantize_weight


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


# safetensors dtype -> (numpy dtype of the raw words, torch dtype); numpy
# has no bfloat16, so BF16 words are read as int16 and viewed as bf16
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
}


class _ShardIndex:
    """name -> tensor over one or many ``.safetensors`` files, each
    memory-mapped copy-on-write (nothing is read until a tensor is)."""

    def __init__(self, ckpt_dir: str):
        self.dir = ckpt_dir
        self.files: Dict[str, str] = {}
        self._headers: Dict[str, Tuple[int, Dict[str, Any]]] = {}
        self._maps: Dict[str, np.memmap] = {}
        index_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
            for name, fname in index["weight_map"].items():
                self.files[name] = os.path.join(ckpt_dir, fname)
        else:
            for fname in sorted(os.listdir(ckpt_dir)):
                if fname.endswith(".safetensors"):
                    path = os.path.join(ckpt_dir, fname)
                    for name in self._header(path)[1]:
                        self.files[name] = path

    def _header(self, path: str) -> Tuple[int, Dict[str, Any]]:
        """(offset of the data section, {name: entry}) of one file."""
        got = self._headers.get(path)
        if got is None:
            with open(path, "rb") as f:
                n = int.from_bytes(f.read(8), "little")
                header = json.loads(f.read(n))
            header.pop("__metadata__", None)
            got = self._headers[path] = (8 + n, header)
        return got

    def __contains__(self, name: str) -> bool:
        return name in self.files

    def names(self) -> List[str]:
        return list(self.files)

    def entry(self, name: str) -> Dict[str, Any]:
        """The header entry ``{"dtype", "shape", "data_offsets"}``."""
        return self._header(self.files[name])[1][name]

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.entry(name)["shape"])

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored, on the host: a view of the memory map
        (a copy only when the data is not aligned to its dtype)."""
        path = self.files[name]
        base, header = self._header(path)
        info = header[name]
        if info["dtype"] not in _DTYPES:
            raise ValueError(
                f"{name}: dtype {info['dtype']} is not supported "
                f"(only {sorted(_DTYPES)})"
            )
        np_dtype, t_dtype = _DTYPES[info["dtype"]]
        if path not in self._maps:
            self._maps[path] = np.memmap(path, dtype=np.uint8, mode="c")
        lo, hi = info["data_offsets"]
        raw = self._maps[path][base + lo : base + hi]
        arr = raw.view(np_dtype)
        if arr.ctypes.data % arr.itemsize:
            arr = arr.copy()
        t = torch.from_numpy(np.asarray(arr)).reshape(info["shape"])
        return t.view(t_dtype) if t_dtype is torch.bfloat16 else t


# how a source tensor lands in its slot of a stacked leaf: as stored, its
# 2-D transpose, or the even / odd entries of its last axis (gpt-oss's
# interleaved gate/up)
_OPS = {
    "id": lambda t: t,
    "T": lambda t: t.T,
    "even": lambda t: t[..., 0::2],
    "odd": lambda t: t[..., 1::2],
}


def load_checkpoint(
    ckpt_dir: str, mcfg: ModelConfig, ecfg, device="cuda", mesh=None, spec_fn=None,
    quantize: bool = False,
) -> Dict[str, Any]:
    """Load and remap an HF checkpoint for any supported family into
    the port's parameter dict on ``device`` in ``ecfg.param_dtype``
    (the dict ``params_from_numpy`` returns, which
    ``ModelRunner(params=...)`` takes). Raises KeyError on a missing
    tensor and ValueError on a misshapen one, before anything is
    allocated on the device.

    With a ``mesh`` (parallel/mesh.py) every leaf is this rank's block
    under ``spec_fn(path, shape)`` (default
    ``parallel.sharding.leaf_spec``), and only that block of each source
    tensor is read from its memory map.

    With ``quantize`` the ``QUANT_LEAVES`` come back int8
    (ops/quant.py), equal to ``quantize_params`` of the unquantized
    load: each layer's slice is read whole and quantized, then cut to
    the rank's block (a row-parallel leaf's per-channel scale reduces
    over the axis that is split), so no rank holds more than one
    layer's slice of a leaf in full precision."""
    from ..parallel import sharding

    spec_fn = spec_fn or sharding.leaf_spec
    idx = _ShardIndex(ckpt_dir)
    dtype = getattr(torch, ecfg.param_dtype)
    spec = transformer.param_spec(mcfg)
    lspec = {n: s[0] for n, s in spec["layers"].items()}
    L = mcfg.num_layers

    def resolve(name: str) -> str:
        """Embedding-model checkpoints saved from the bare trunk (e.g.
        Qwen3-Embedding's Qwen3Model) drop the ``model.`` prefix."""
        if name in idx:
            return name
        if name.startswith("model.") and name[6:] in idx:
            return name[6:]
        return name

    # leaf path -> (shape, [(slot index, source name, op, source shape)])
    plan: Dict[Tuple[str, ...], Tuple[tuple, List[tuple]]] = {}

    def hf_shape(shape: tuple, op: str) -> tuple:
        return tuple(reversed(shape)) if op == "T" else shape

    def stack(key: str, fmt: str, transpose: bool = False) -> None:
        shape, op = lspec[key], ("T" if transpose else "id")
        plan[("layers", key)] = (shape, [
            ((i,), resolve(fmt.format(i=i)), op, hf_shape(shape[1:], op))
            for i in range(L)
        ])

    def present(fmt: str) -> bool:
        return resolve(fmt.format(i=0)) in idx

    p = "model.layers.{i}."
    stack("attn_norm", p + "input_layernorm.weight")
    for key, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
        stack(key, p + f"self_attn.{proj}_proj.weight", transpose=True)
    if mcfg.attn_bias:
        for key, proj in (("bq", "q"), ("bk", "k"), ("bv", "v"), ("bo", "o")):
            stack(key, p + f"self_attn.{proj}_proj.bias")
    if mcfg.qk_norm:
        stack("q_norm", p + "self_attn.q_norm.weight")
        stack("k_norm", p + "self_attn.k_norm.weight")
    if mcfg.attention_sink:
        stack("sink", p + "self_attn.sinks")
    if mcfg.post_norms:
        # Gemma3 norm quartet
        stack("post_attn_norm", p + "post_attention_layernorm.weight")
        stack("mlp_norm", p + "pre_feedforward_layernorm.weight")
        stack("post_mlp_norm", p + "post_feedforward_layernorm.weight")
    else:
        stack("mlp_norm", p + "post_attention_layernorm.weight")

    if mcfg.moe_experts:
        E = mcfg.moe_experts
        if present(p + "mlp.gate.weight"):
            stack("router", p + "mlp.gate.weight", transpose=True)
        elif present(p + "mlp.router.weight"):
            stack("router", p + "mlp.router.weight", transpose=True)
        else:
            raise KeyError("No MoE router weight found in checkpoint")
        if "model.layers.0.mlp.experts.0.gate_proj.weight" in idx:
            for key, sub in (("we_gate", "gate_proj"), ("we_up", "up_proj"),
                             ("we_down", "down_proj")):
                shape = lspec[key]
                plan[("layers", key)] = (shape, [
                    ((i, e), f"model.layers.{i}.mlp.experts.{e}.{sub}.weight",
                     "T", hf_shape(shape[2:], "T"))
                    for i in range(L) for e in range(E)
                ])
        else:
            # gpt-oss fused layout: experts.gate_up_proj [E, H, 2F] with
            # gate/up interleaved on the last axis (+ biases [E, 2F]),
            # experts.down_proj [E, F, H] (+ bias [E, H])
            g = lspec["we_gate"]
            gu_shape = (*g[1:-1], 2 * g[-1])
            for key, op in (("we_gate", "even"), ("we_up", "odd")):
                plan[("layers", key)] = (lspec[key], [
                    ((i,), f"model.layers.{i}.mlp.experts.gate_up_proj", op,
                     gu_shape)
                    for i in range(L)
                ])
            stack("we_down", p + "mlp.experts.down_proj")
        if mcfg.moe_bias:
            if present(p + "mlp.router.bias"):
                stack("router_b", p + "mlp.router.bias")
            elif present(p + "mlp.gate.bias"):
                stack("router_b", p + "mlp.gate.bias")
            if "model.layers.0.mlp.experts.gate_up_proj_bias" in idx:
                gb = lspec["we_gate_b"]
                for key, op in (("we_gate_b", "even"), ("we_up_b", "odd")):
                    plan[("layers", key)] = (lspec[key], [
                        ((i,), f"model.layers.{i}.mlp.experts.gate_up_proj_bias",
                         op, (*gb[1:-1], 2 * gb[-1]))
                        for i in range(L)
                    ])
                stack("we_down_b", p + "mlp.experts.down_proj_bias")
    else:
        stack("w_gate", p + "mlp.gate_proj.weight", transpose=True)
        stack("w_up", p + "mlp.up_proj.weight", transpose=True)
        stack("w_down", p + "mlp.down_proj.weight", transpose=True)

    plan[("embed",)] = (spec["embed"][0], [
        ((), resolve("model.embed_tokens.weight"), "id", spec["embed"][0])])
    plan[("final_norm",)] = (spec["final_norm"][0], [
        ((), resolve("model.norm.weight"), "id", spec["final_norm"][0])])
    if "lm_head" in spec and "lm_head.weight" in idx:
        shape = spec["lm_head"][0]
        plan[("lm_head",)] = (shape, [((), "lm_head.weight", "T", hf_shape(shape, "T"))])

    # every source present and shaped as the config says, from the
    # headers alone, before any device allocation
    for path, (_, sources) in plan.items():
        for _, name, _, want in sources:
            if name not in idx:
                raise KeyError(f"checkpoint {ckpt_dir} has no tensor {name!r}")
            if idx.shape(name) != tuple(want):
                raise ValueError(
                    f"Checkpoint shape mismatch at {name} "
                    f"({'.'.join(path)}): got {idx.shape(name)}, want "
                    f"{tuple(want)} for model {mcfg.name}"
                )

    def fill(dst, shape, cut, sources) -> None:
        """Block ``cut`` of a leaf of ``shape`` into ``dst``, from its
        ``sources`` (each at its slot, a prefix of the leaf's index)."""
        ranges = [range(*c.indices(n)) for c, n in zip(cut, shape)]
        for slot, name, op, _ in sources:
            # this block's slot, if any, and its block of the source
            if any(i not in r for i, r in zip(slot, ranges)):
                continue
            here = tuple(i - r.start for i, r in zip(slot, ranges))
            src = idx.get(name)
            if mesh is None:   # raw words to the device, cast there
                src = _OPS[op](src.to(device))
            else:              # only the block leaves the memory map
                src = _OPS[op](src)[cut[len(slot):]].to(device)
            dst[here].copy_(src)
            del src

    def block(path, shape) -> tuple:
        if mesh is None:
            return (slice(None),) * len(shape)
        return sharding.spec_slices(spec_fn(path, shape), shape, mesh)

    def local(cut, shape) -> tuple:
        return tuple(len(range(*c.indices(n))) for c, n in zip(cut, shape))

    def quantized(path, shape, sources) -> Dict[str, torch.Tensor]:
        """A QUANT_LEAVES leaf: each leading-axis slice (the whole leaf
        if it is 2-D) read whole and quantized, then cut to the block."""
        scale_shape = (*shape[:-2], 1, shape[-1])
        qcut, scut = block((*path, "qw"), shape), block((*path, "scale"), scale_shape)
        out = {"qw": torch.empty(local(qcut, shape), dtype=torch.int8, device=device),
               "scale": torch.empty(local(scut, scale_shape), dtype=torch.float32,
                                    device=device)}
        if len(shape) == 2:
            w = torch.empty(shape, dtype=dtype, device=device)
            fill(w, shape, (slice(None),) * 2, sources)
            q = quantize_weight(w)
            out["qw"].copy_(q["qw"][qcut])
            out["scale"].copy_(q["scale"][scut])
            return out
        qrows, srows = (range(*c[0].indices(shape[0])) for c in (qcut, scut))
        for i in range(shape[0]):
            if i not in qrows and i not in srows:
                continue   # a layer of another pipeline stage
            w = torch.empty((1, *shape[1:]), dtype=dtype, device=device)
            fill(w, shape, (slice(i, i + 1),) + (slice(None),) * (len(shape) - 1), sources)
            q = quantize_weight(w[0])
            del w
            if i in qrows:
                out["qw"][i - qrows.start].copy_(q["qw"][qcut[1:]])
            if i in srows:
                out["scale"][i - srows.start].copy_(q["scale"][scut[1:]])
        return out

    params: Dict[str, Any] = {"layers": {}}
    with torch.no_grad():
        for path, (shape, sources) in plan.items():
            if quantize and path[-1] in QUANT_LEAVES:
                leaf = quantized(path, shape, sources)
            else:
                cut = block(path, shape)
                leaf = torch.empty(local(cut, shape), dtype=dtype, device=device)
                fill(leaf, shape, cut, sources)
            node = params
            for part in path[:-1]:
                node = node[part]
            node[path[-1]] = leaf
    return params
