"""The port's checkpoint loader against the JAX package's.

Hugging Face checkpoints are written with ``safetensors`` (numpy, and
torch for BF16, which numpy lacks) from parameters the JAX package's
``init_params`` draws: tiny-dense, tiny-moe (the per-expert Qwen-MoE
layout) and tiny-oss (gpt-oss's fused ``gate_up`` layout with its
biases and router bias), in F32, F16 and BF16, as one file or as two
shards with a ``model.safetensors.index.json``.

- ``sutro_tpu_torch.engine.weights.load_checkpoint(..., device="cpu")``
  equals ``sutro_tpu.engine.weights.load_checkpoint`` leaf for leaf:
  exactly at float32, and bit for bit at bfloat16 (the same cast). The
  JAX loader reads F32 and F16 files; it cannot read BF16 (numpy has no
  bfloat16), so a BF16 file is held against the JAX loader on the F32
  file of the same (bf16-representable) values;
- the port's reader returns the bits ``safetensors`` returns for every
  dtype;
- a misshapen or missing tensor is refused.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as save_np
from safetensors.torch import save_file as save_pt

from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.engine.weights import load_checkpoint as jax_load
from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import _ShardIndex, load_checkpoint
from sutro_tpu_torch.models.configs import MODEL_CONFIGS as T_CONFIGS

MODELS = ("tiny-dense", "tiny-moe", "tiny-oss")


def hf_tensors(cfg, tree) -> dict:
    """The JAX parameter tree (numpy leaves) as HF tensors: projections
    back to ``[out, in]``; per-expert weights for a MoE without biases,
    the fused, interleaved ``gate_up`` layout for one with them."""
    out = {
        "model.embed_tokens.weight": tree["embed"],
        "model.norm.weight": tree["final_norm"],
    }
    if "lm_head" in tree:
        out["lm_head.weight"] = tree["lm_head"].T
    lay = tree["layers"]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        for key, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
            out[p + f"self_attn.{proj}_proj.weight"] = lay[key][i].T
        for key, proj in (("bq", "q"), ("bk", "k"), ("bv", "v"), ("bo", "o")):
            if key in lay:
                out[p + f"self_attn.{proj}_proj.bias"] = lay[key][i]
        if "q_norm" in lay:
            out[p + "self_attn.q_norm.weight"] = lay["q_norm"][i]
            out[p + "self_attn.k_norm.weight"] = lay["k_norm"][i]
        if "sink" in lay:
            out[p + "self_attn.sinks"] = lay["sink"][i]
        out[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        if not cfg.moe_experts:
            for key, proj in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down")):
                out[p + f"mlp.{proj}_proj.weight"] = lay[key][i].T
        elif not cfg.moe_bias:
            out[p + "mlp.gate.weight"] = lay["router"][i].T
            for e in range(cfg.moe_experts):
                for key, proj in (("we_gate", "gate"), ("we_up", "up"),
                                  ("we_down", "down")):
                    out[p + f"mlp.experts.{e}.{proj}_proj.weight"] = lay[key][i, e].T
        else:
            out[p + "mlp.router.weight"] = lay["router"][i].T
            out[p + "mlp.router.bias"] = lay["router_b"][i]
            g, u = lay["we_gate"][i], lay["we_up"][i]
            gu = np.empty((*g.shape[:-1], 2 * g.shape[-1]), g.dtype)
            gu[..., 0::2], gu[..., 1::2] = g, u
            out[p + "mlp.experts.gate_up_proj"] = gu
            out[p + "mlp.experts.down_proj"] = lay["we_down"][i]
            gb, ub = lay["we_gate_b"][i], lay["we_up_b"][i]
            gub = np.empty((*gb.shape[:-1], 2 * gb.shape[-1]), gb.dtype)
            gub[..., 0::2], gub[..., 1::2] = gb, ub
            out[p + "mlp.experts.gate_up_proj_bias"] = gub
            out[p + "mlp.experts.down_proj_bias"] = lay["we_down_b"][i]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def save_hf(tensors: dict, ckpt_dir, dtype: str = "F32", shards: int = 1) -> None:
    """``tensors`` (float32 numpy) as an HF checkpoint in ``dtype``,
    in one file or ``shards`` files with an index."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names = sorted(tensors)
    parts = [names[k::shards] for k in range(shards)]
    weight_map = {}
    for k, part in enumerate(parts):
        fname = ("model.safetensors" if shards == 1
                 else f"model-{k + 1:05d}-of-{shards:05d}.safetensors")
        path = os.path.join(ckpt_dir, fname)
        chunk = {n: tensors[n] for n in part}
        if dtype == "BF16":
            save_pt({n: torch.from_numpy(v).to(torch.bfloat16) for n, v in chunk.items()},
                    path)
        else:
            save_np({n: v.astype({"F32": np.float32, "F16": np.float16}[dtype])
                     for n, v in chunk.items()}, path)
        weight_map.update({n: fname for n in part})
    if shards > 1:
        with open(os.path.join(ckpt_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)


def write_hf_checkpoint(cfg, seed: int, ckpt_dir, dtype: str = "F32", shards: int = 1):
    """Draw ``cfg``'s parameters with the JAX package's ``init_params``
    (float32) and write them as an HF checkpoint; returns the tensors."""
    params = jax_transformer.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    tensors = hf_tensors(cfg, tree)
    save_hf(tensors, ckpt_dir, dtype, shards)
    return tensors


def _bf16_values(tensors: dict) -> dict:
    """The float32 values of the tensors rounded to bfloat16."""
    return {n: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
            for n, v in tensors.items()}


def _flat(params, prefix=""):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _assert_same_params(got: dict, want: dict) -> None:
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
@pytest.mark.parametrize("model", MODELS)
def test_loader_matches_jax_loader(tmp_path, model, dtype, shards):
    cfg = MODEL_CONFIGS[model]
    tensors = write_hf_checkpoint(cfg, 11, tmp_path / "ckpt", dtype, shards)
    jax_dir = tmp_path / "ckpt"
    if dtype == "BF16":
        # the JAX loader reads numpy dtypes only: it gets the F32 file
        # of the same bf16-rounded values
        jax_dir = tmp_path / "ckpt_f32"
        save_hf(_bf16_values(tensors), jax_dir, "F32", shards)
    for param_dtype in ("float32", "bfloat16"):
        want = jax_load(str(jax_dir), cfg, JaxEngineConfig(param_dtype=param_dtype))
        got = load_checkpoint(str(tmp_path / "ckpt"), T_CONFIGS[model],
                              EngineConfig(param_dtype=param_dtype), device="cpu")
        _assert_same_params(got, want)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_reader_returns_the_bits_of_safetensors(tmp_path, dtype):
    rng = np.random.default_rng(5)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b.c": rng.standard_normal((7,)).astype(np.float32),
               "empty": np.zeros((0, 4), np.float32),
               "scalar": np.array(2.5, np.float32)}
    save_hf(tensors, tmp_path, dtype)
    idx = _ShardIndex(str(tmp_path))
    assert sorted(idx.names()) == sorted(tensors)
    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as f:
        for name in tensors:
            want, got = f.get_tensor(name), idx.get(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name


def test_refuses_a_misshapen_or_missing_tensor(tmp_path):
    tensors = write_hf_checkpoint(MODEL_CONFIGS["tiny-dense"], 3, tmp_path / "good")
    cfg = T_CONFIGS["tiny-dense"]
    ecfg = EngineConfig(param_dtype="float32")
    bad = dict(tensors)
    bad["model.layers.1.mlp.up_proj.weight"] = bad["model.layers.1.mlp.up_proj.weight"][:, :-1]
    save_hf(bad, tmp_path / "misshapen")
    with pytest.raises(ValueError, match="up_proj"):
        load_checkpoint(str(tmp_path / "misshapen"), cfg, ecfg, device="cpu")
    missing = {k: v for k, v in tensors.items() if k != "model.layers.0.self_attn.k_norm.weight"}
    save_hf(missing, tmp_path / "missing")
    with pytest.raises(KeyError, match="k_norm"):
        load_checkpoint(str(tmp_path / "missing"), cfg, ecfg, device="cpu")
    # the model is the one the checkpoint is for
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path / "good"), dataclasses.replace(cfg, hidden_size=64),
                        ecfg, device="cpu")


def test_loaded_params_drive_the_runner(tmp_path):
    """``ModelRunner(params=load_checkpoint(...))`` computes what the
    runner over ``params_from_numpy`` of the same tree computes."""
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.weights import params_from_numpy

    cfg = T_CONFIGS["tiny-moe"]
    params = jax_transformer.init_params(MODEL_CONFIGS["tiny-moe"], jax.random.PRNGKey(2), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    save_hf(hf_tensors(MODEL_CONFIGS["tiny-moe"], tree), tmp_path, "F32", 2)
    ecfg = EngineConfig(kv_page_size=8, max_pages_per_seq=8, decode_batch_size=2,
                        max_model_len=64, param_dtype="float32")
    a = ModelRunner(cfg, ecfg, load_checkpoint(str(tmp_path), cfg, ecfg, device="cpu"),
                    device="cpu")
    b = ModelRunner(cfg, ecfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                    device="cpu")
    prompt = np.arange(3, 20, dtype=np.int32)
    table = np.zeros((8,), np.int32)
    table[:3] = [1, 2, 3]
    np.testing.assert_array_equal(a.prefill(prompt, table), b.prefill(prompt, table))
