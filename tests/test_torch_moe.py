"""The PyTorch port's MoE half against the JAX package.

Same inputs, made from numpy seeds, go through both sides, in float32:

- ``grouped_matmul`` (on the CPU: its plain per-group loop) against the
  reference's Pallas ``grouped_matmul`` in interpret mode and against
  ``jax.lax.ragged_dot``, at the size cases of
  tests/test_pallas_kernels.py (an empty group, a single hot expert);
  2e-4, as there (float32 products of depth 128, summation order only);
- ``moe_mlp`` with ``method`` dense and ragged, with and without the
  gpt-oss biases and ``swiglu_oss``, against ``sutro_tpu/ops/moe.py``;
  1e-5 (float32, summation order);
- the forward of ``tiny-moe``, ``tiny-oss`` and a 16-expert ``tiny-moe``
  (which takes the ragged path) through ``params_from_numpy``; 1e-4;
- greedy engine parity with the JAX engine (``use_pallas=False``):
  token-identical, cumulative logprobs to 1e-4.

The ``cuda``-marked test holds the grouped-GEMM kernel against its plain
version on the card (bfloat16 output rounding: atol = rtol = 2e-2) and
skips without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sutro_tpu.engine.runner as jax_runner
import sutro_tpu.engine.scheduler as jax_sched
from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
from sutro_tpu.models import transformer as jt
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.ops.moe import moe_mlp as jax_moe_mlp
from sutro_tpu.ops.pallas_gmm import grouped_matmul as jax_grouped_matmul
from sutro_tpu_torch.engine import runner as t_runner
from sutro_tpu_torch.engine import scheduler as t_sched
from sutro_tpu_torch.engine.config import EngineConfig
from sutro_tpu_torch.engine.weights import params_from_numpy
from sutro_tpu_torch.models import transformer as tt
from sutro_tpu_torch.ops import grouped_matmul as gm
from sutro_tpu_torch.ops import moe

GMM_TOL = 2e-4
MLP_TOL = 1e-5
FWD_TOL = 1e-4
LOGP_TOL = 1e-4
CUDA_TOL = 2e-2

MOE_CONFIGS = {
    "tiny-moe": MODEL_CONFIGS["tiny-moe"],
    "tiny-oss": MODEL_CONFIGS["tiny-oss"],
    # E > 8: the ragged grouped-GEMM path in both engines
    "tiny-moe-16e": dataclasses.replace(MODEL_CONFIGS["tiny-moe"], moe_experts=16),
}


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)  # a writable copy


@pytest.mark.parametrize("reference", ["pallas_interpret", "ragged_dot"])
@pytest.mark.parametrize("sizes", [
    [100, 28, 0, 128],       # ragged + one empty group
    [64, 64, 64, 64],        # tile-aligned
    [256, 0, 0, 0],          # single hot expert
    [1, 2, 3, 250],          # tiny groups
])
def test_grouped_matmul_matches_jax(sizes, reference):
    rng = np.random.default_rng(13)
    E, H, F = len(sizes), 128, 256
    M = sum(sizes)
    lhs = rng.standard_normal((M, H)).astype(np.float32)
    rhs = rng.standard_normal((E, H, F)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    if reference == "ragged_dot":
        want = jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs))
    else:
        want = jax_grouped_matmul(
            jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), interpret=True
        )
    got = gm.grouped_matmul(_t(lhs), _t(rhs), _t(gs, torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GMM_TOL, rtol=GMM_TOL)


def test_grouped_matmul_rows_past_the_groups_are_zero():
    """``ragged_dot``'s contract for an lhs longer than its groups."""
    rng = np.random.default_rng(17)
    sizes, pad = [40, 0, 25, 7], 33
    E, H, F = len(sizes), 64, 48
    lhs = rng.standard_normal((sum(sizes) + pad, H)).astype(np.float32)
    rhs = rng.standard_normal((E, H, F)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs)))
    got = gm.grouped_matmul(_t(lhs), _t(rhs), _t(gs, torch.int32)).numpy()
    np.testing.assert_allclose(got, want, atol=GMM_TOL, rtol=GMM_TOL)
    assert not got[sum(sizes):].any()


def _mlp_inputs(rng, *, N=12, H=32, E=8, F=16, bias=False):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(2, N // 2, H)
    w = dict(router=f(H, E), we_gate=f(E, H, F) * 0.3, we_up=f(E, H, F) * 0.3,
             we_down=f(E, F, H) * 0.3)
    b = {}
    if bias:
        b = dict(router_b=f(E), bias_gate=f(E, F), bias_up=f(E, F), bias_down=f(E, H))
    return x, w, b


@pytest.mark.parametrize("method", ["dense", "ragged"])
@pytest.mark.parametrize("variant", ["qwen3", "gpt-oss"])
def test_moe_mlp_matches_jax(method, variant):
    rng = np.random.default_rng(3)
    oss = variant == "gpt-oss"
    x, w, b = _mlp_inputs(rng, bias=oss)
    act = "swiglu_oss" if oss else "silu"
    names = ("router", "we_gate", "we_up", "we_down")
    want = jax_moe_mlp(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in names), top_k=2,
        activation=act, method=method, **{k: jnp.asarray(v) for k, v in b.items()},
    )
    got = moe.moe_mlp(
        _t(x), *(_t(w[n]) for n in names), top_k=2, activation=act,
        method=method, **{k: _t(v) for k, v in b.items()},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MLP_TOL, rtol=MLP_TOL)


def _params(cfg, seed=0):
    """The JAX init -> numpy -> the port; zero-initialized biases and
    sinks are redrawn from a numpy seed so they matter."""
    p = jt.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
    rng = np.random.default_rng(seed)
    for name in ("sink", "router_b", "we_gate_b", "we_up_b", "we_down_b"):
        if name in tree["layers"]:
            x = tree["layers"][name]
            tree["layers"][name] = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    return tree, params_from_numpy(cfg, tree, "cpu", torch.float32)


@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_params_from_numpy_takes_the_moe_tree(name):
    cfg = MOE_CONFIGS[name]
    tree, tp = _params(cfg)
    assert set(tp["layers"]) == set(tree["layers"])
    for k, v in tree["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), v)
    g = torch.Generator().manual_seed(0)
    init = tt.init_params(cfg, g, torch.float32, "cpu")
    for k, v in tree["layers"].items():
        assert tuple(init["layers"][k].shape) == v.shape, k


@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_moe_forward_matches_jax(name):
    cfg = MOE_CONFIGS[name]
    tree, tparams = _params(cfg)
    rng = np.random.default_rng(1)
    B, T = 2, 11
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    valid = np.array([T, 7], np.int32)
    jl, _, (jk, _) = jt.forward(
        cfg, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(pos), jnp.asarray(valid),
    )
    tl, _, (tk, _) = tt.forward(
        cfg, tparams, torch.as_tensor(ids), torch.as_tensor(pos), torch.as_tensor(valid),
    )
    jl, jk = np.asarray(jl), np.asarray(jk)
    for b in range(B):  # padded tails are discarded by the engine
        n = int(valid[b])
        np.testing.assert_allclose(tl[b, :n].numpy(), jl[b, :n], atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(tk[:, b, :n].numpy(), jk[:, b, :n], atol=FWD_TOL,
                                   rtol=FWD_TOL)


ENGINE = dict(
    kv_page_size=8, max_pages_per_seq=16, decode_batch_size=4,
    max_model_len=128, param_dtype="float32", decode_multi_step=4,
    prefill_chunk=16,
)


def _run(sched_mod, runner, requests):
    res = {}
    b = sched_mod.ContinuousBatcher(runner, stop_ids=[1])
    assert b.run(requests, on_result=lambda r: res.__setitem__(r.row_id, r)) == "completed"
    return res


def _requests(sched_mod):
    rng = np.random.default_rng(0)
    return [
        sched_mod.GenRequest(
            row_id=i, prompt_ids=rng.integers(3, 500, n).astype(np.int32),
            max_new_tokens=8 + i, temperature=0.0,
        )
        for i, n in enumerate((5, 9, 40, 13, 2, 27))
    ]


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-moe-16e"])
def test_greedy_moe_engine_matches_jax(name):
    cfg = MOE_CONFIGS[name]
    p = jt.init_params(cfg, jax.random.PRNGKey(5), jnp.float32)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), p)
    jr = jax_runner.ModelRunner(cfg, JaxEngineConfig(use_pallas=False, **ENGINE), p)
    tr = t_runner.ModelRunner(
        cfg, EngineConfig(**ENGINE), params_from_numpy(cfg, tree, "cpu", torch.float32),
        device="cpu",
    )
    want = _run(jax_sched, jr, _requests(jax_sched))
    got = _run(t_sched, tr, _requests(t_sched))
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i].token_ids == want[i].token_ids, i
        assert got[i].finish_reason == want[i].finish_reason, i
        assert got[i].cumulative_logprob == pytest.approx(
            want[i].cumulative_logprob, abs=LOGP_TOL, rel=LOGP_TOL
        )


# ---------------------------------------------------------------------------
# the CUDA kernel vs its plain version (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,pad", [
    ([100, 28, 0, 128], 0), ([256, 0, 0, 0], 0), ([1, 2, 3, 250], 0),
    ([0, 0, 0, 0], 0), ([100, 28, 0, 60], 150), ([0, 0, 0, 0], 70),
])
def test_cuda_grouped_matmul_matches_plain(cuda_device, sizes, pad):
    g = torch.Generator(device=cuda_device).manual_seed(len(sizes))
    bf = dict(device=cuda_device, dtype=torch.bfloat16, generator=g)
    E, H, F = len(sizes), 136, 200   # H, F multiples of 8, not of the tiles
    lhs = torch.randn((sum(sizes) + pad, H), **bf)   # pad rows past the groups
    rhs = torch.randn((E, H, F), **bf) * H ** -0.5
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
    got = gm.grouped_matmul(lhs, rhs, gs)
    want = gm.grouped_matmul_plain(lhs, rhs, gs)
    torch.testing.assert_close(got.float(), want.float(), atol=CUDA_TOL, rtol=CUDA_TOL)
