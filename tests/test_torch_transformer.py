"""The PyTorch port's transformer against the JAX package.

Parameters come from ``transformer.init_params(..., jnp.float32)`` ->
numpy -> ``params_from_numpy``; the zero-initialized leaves (sinks,
biases) are redrawn from a numpy seed so they matter. Both sides run in
float32; logits and the per-layer K/V must agree to 1e-4 (float32
summation order over a few layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sutro_tpu.models import transformer as jt
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.models import transformer as tt
from sutro_tpu_torch.models.configs import MODEL_CONFIGS as T_CONFIGS

TOL = 1e-4

TINY = MODEL_CONFIGS["tiny-dense"]
CONFIGS = {
    "tiny-dense": TINY,
    # gpt-oss attention: alternating windows, sinks, qkv/o biases, the
    # clamped swiglu and YaRN RoPE
    "windows-sinks-bias": dataclasses.replace(
        TINY, sliding_window=4, sliding_pattern="alternate",
        attention_sink=True, attn_bias=True, qk_norm=False,
        activation="swiglu_oss", rope_scaling_factor=4.0,
        rope_original_max=64, tie_embeddings=False,
    ),
    # gemma 3: zero-centered norms, post norms, embedding scale, GeGLU,
    # local RoPE base on the windowed layers
    "gemma-like": dataclasses.replace(
        TINY, num_layers=3, sliding_window=5, sliding_pattern="gemma",
        norm_zero_centered=True, post_norms=True, embed_scale=True,
        activation="gelu", local_rope_theta=10_000.0,
    ),
}


def _params(cfg, seed=0):
    p = jt.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
    rng = np.random.default_rng(seed)
    for name in ("sink", "bq", "bk", "bv", "bo", "attn_norm", "mlp_norm"):
        if name in tree["layers"]:
            x = tree["layers"][name]
            tree["layers"][name] = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    return tree, params_from_numpy(cfg, tree, "cpu", torch.float32)


def test_configs_are_copies():
    assert set(T_CONFIGS) == set(MODEL_CONFIGS)
    for name, cfg in MODEL_CONFIGS.items():
        assert dataclasses.asdict(T_CONFIGS[name]) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    cfg = CONFIGS[name]
    tree, tparams = _params(cfg)
    rng = np.random.default_rng(1)
    B, T = 2, 11
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    valid = np.array([T, 7], np.int32)
    jl, _, (jk, jv) = jt.forward(
        cfg, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(pos), jnp.asarray(valid),
    )
    tl, _, (tk, tv) = tt.forward(
        cfg, tparams, torch.as_tensor(ids), torch.as_tensor(pos),
        torch.as_tensor(valid),
    )
    jl, jk, jv = np.asarray(jl), np.asarray(jk), np.asarray(jv)
    assert tl.dtype == torch.float32
    for b in range(B):  # padded tails are discarded by the engine
        n = int(valid[b])
        np.testing.assert_allclose(tl[b, :n].numpy(), jl[b, :n], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tk[:, b, :n].numpy(), jk[:, b, :n], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tv[:, b, :n].numpy(), jv[:, b, :n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_head_index_gives_the_same_logits(name):
    """Gathering the last valid hidden state before the head (the
    runner's prefill) gives the full head's logits at that position."""
    cfg = CONFIGS[name]
    _, tparams = _params(CONFIGS[name])
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 9)))
    pos = torch.arange(9)[None].expand(3, 9)
    valid = torch.tensor([9, 4, 1])
    full, _, _ = tt.forward(cfg, tparams, ids, pos, valid)
    last, _, _ = tt.forward(cfg, tparams, ids, pos, valid, head_index=valid - 1)
    want = full[torch.arange(3), valid - 1]
    torch.testing.assert_close(last[:, 0], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_decode_forward_matches_jax(name):
    """A prompt's K/V in pages, then one decode token over them with a
    fused-window buffer: the port's paged forward vs the JAX one."""
    cfg = CONFIGS[name]
    tree, tparams = _params(cfg, seed=3)
    L, KD = cfg.num_layers, cfg.kv_size
    rng = np.random.default_rng(4)
    B, PS, MP, NP, W = 2, 4, 4, 9, 3
    k_pages = rng.standard_normal((L, NP, PS, KD)).astype(np.float32)
    v_pages = rng.standard_normal((L, NP, PS, KD)).astype(np.float32)
    win_k = rng.standard_normal((L, B, W, KD)).astype(np.float32)
    win_v = rng.standard_normal((L, B, W, KD)).astype(np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
    past = np.array([13, 6], np.int32)
    win_len = 2
    ids = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = (past + win_len)[:, None]
    ones = np.ones((B,), np.int32)
    jl, _, (jk, _) = jt.forward(
        cfg, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(pos), jnp.asarray(ones),
        paged_past=(jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(table)),
        past_len=jnp.asarray(past),
        window_past=(jnp.asarray(win_k), jnp.asarray(win_v),
                     jnp.asarray(win_len, jnp.int32)),
    )
    t = torch.as_tensor
    tl, _, (tk, _) = tt.forward(
        cfg, tparams, t(ids), t(pos), t(ones),
        paged_past=(t(k_pages), t(v_pages), t(table)), past_len=t(past),
        window_past=(t(win_k), t(win_v), win_len),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    for cfg in (TINY, CONFIGS["windows-sinks-bias"]):
        want = jt.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                             jnp.asarray(cfg.rope_theta, jnp.float32), cfg)
        got = tt.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), cfg.rope_theta, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_init_params_layout_matches_jax():
    for cfg in CONFIGS.values():
        jp = jt.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        g = torch.Generator().manual_seed(0)
        tp = tt.init_params(cfg, g, torch.float32, "cpu")
        assert set(tp) == set(jp)
        assert set(tp["layers"]) == set(jp["layers"])
        for k in tp["layers"]:
            assert tuple(tp["layers"][k].shape) == jp["layers"][k].shape
            assert tp["layers"][k].dtype == torch.float32


def test_moe_raises():
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.init_params(T_CONFIGS["tiny-moe"], torch.Generator(), torch.float32, "cpu")
