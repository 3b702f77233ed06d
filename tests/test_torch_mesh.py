"""The port's device mesh against the JAX package's (CPU, gloo).

- ``parallel/mesh.py``: every rank's coordinates equal its device's
  place in the JAX ``make_mesh`` grid; ``make_mesh`` and the divisibility
  checks raise as JAX's do.
- ``parallel/sharding.py``: each leaf's spec equals JAX's
  ``param_shardings`` spec (int8 leaves too), and each rank's block from
  ``shard_params`` equals the shard that device holds after
  ``jax.device_put(params, param_shardings(...))`` on the 8 CPU devices
  of ``tests/conftest.py``; the pipeline's specs equal
  ``pp_param_shardings``.
- ``ops/moe_ep.py`` on (dp, ep, tp) = (1,2,1), (1,2,2), (1,4,1), with and
  without biases, and an odd batch: every rank's output equals JAX's
  single-device MoE (the JAX package runs its own ``moe_mlp_ep`` only in
  slow-marked tests), float32, atol = rtol = 1e-5.
- ``ops/ring_attention.py`` on sp in {2, 4} x tp in {1, 2}, with a
  window and sinks: equal to JAX's dense ``chunk_attention`` (and, for
  one case, to JAX's ``ring_self_attention`` on the fake devices) over
  the valid query rows, atol 1e-5.
- ``parallel/pipeline.py`` at pp=2 with 2 and 4 microbatches and at
  pp=2 x tp=2: ``pipeline_forward``'s logits and each stage's K/V, and
  ``pipeline_decode``'s logits over pages, equal JAX
  ``transformer.forward`` over the valid positions (atol 2e-4, the JAX
  package's own pipeline bound); each stage holds only its layers'
  weights and pages.

Each group of cases runs in one spawned world (tests/mesh_ranks.py),
ranks rendezvous on a file store under ``tmp_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sutro_tpu.models import transformer as jax_transformer
from sutro_tpu.models.configs import MODEL_CONFIGS
from sutro_tpu.ops.attention import chunk_attention as jax_chunk_attention
from sutro_tpu.ops.moe import moe_mlp as jax_moe
from sutro_tpu.ops.quant import quantize_params as jax_quantize
from sutro_tpu.ops.ring_attention import ring_self_attention as jax_ring
from sutro_tpu.parallel import mesh as jax_mesh
from sutro_tpu.parallel import sharding as jax_sharding
from sutro_tpu.parallel.pipeline import pp_param_shardings as jax_pp_shardings
from sutro_tpu_torch.ops.ring_attention import seq_chunk
from sutro_tpu_torch.parallel import mesh as t_mesh
from sutro_tpu_torch.parallel import pipeline as t_pipeline
from sutro_tpu_torch.parallel import sharding as t_sharding
from tests import mesh_ranks

SHAPES = [(1, 1, 1, 1, 8), (2, 1, 1, 2, 2), (1, 2, 2, 1, 2), (2, 2, 1, 1, 2), (1, 1, 4, 2, 1),
          (8, 1, 1, 1, 1)]


def _tree(params):
    return jax.tree_util.tree_map(lambda x: np.array(x), params)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dp,pp,sp,ep,tp", SHAPES)
def test_rank_coordinates_match_the_jax_grid(eight_devices, dp, pp, sp, ep, tp):
    jm = jax_mesh.make_mesh(dp, ep, tp, eight_devices, sp=sp, pp=pp)
    tm = t_mesh.make_mesh(dp, ep, tp, ["cpu"] * 8, sp=sp, pp=pp)
    assert t_mesh.mesh_shape(tm) == jax_mesh.mesh_shape(jm)
    assert tm.backend == "gloo"
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(tm.size):
        c = tm.coords(r)
        assert grid[tuple(c[a] for a in t_mesh.AXES)] == eight_devices[r].id
        # a group's members are the ranks along its axes, in grid order
        idx = tuple(slice(None) if a == "model" else c[a] for a in t_mesh.AXES)
        assert tm.members(("model",), r) == [
            eight_devices.index(d) for d in np.asarray(jm.devices)[idx].reshape(-1)
        ]


def test_make_mesh_raises_as_jax_does(eight_devices):
    with pytest.raises(ValueError, match="exceeds available devices"):
        jax_mesh.make_mesh(2, 2, 4, eight_devices)
    with pytest.raises(ValueError, match="exceeds available devices"):
        t_mesh.make_mesh(2, 2, 4, ["cpu"] * 8)
    assert t_mesh.backend_for([torch.device("cuda", 0)] * 2) == "gloo"   # a shared card
    assert t_mesh.backend_for([torch.device("cuda", i) for i in range(2)]) == "nccl"


@pytest.mark.parametrize("kvh,tp", [(2, 4), (3, 2)])
def test_tp_must_divide_kv_heads_as_in_jax(eight_devices, kvh, tp):
    jm = jax_mesh.make_mesh(1, 1, tp, eight_devices)
    tm = t_mesh.make_mesh(1, 1, tp, ["cpu"] * 8)
    with pytest.raises(ValueError, match="must divide num_kv_heads"):
        jax_sharding.cache_shardings(jm, kvh)
    with pytest.raises(ValueError, match="must divide num_kv_heads"):
        t_sharding.cache_shardings(tm, kvh)
    with pytest.raises(ValueError, match="must divide num_kv_heads"):
        t_pipeline.pp_cache_sharding(tm, kvh)


def test_indivisible_sequence_and_layers_raise():
    with pytest.raises(ValueError, match="not divisible by seq"):
        seq_chunk(t_mesh.make_mesh(1, 1, 1, ["cpu"] * 4, sp=4), 30)
    cfg = MODEL_CONFIGS["tiny-dense"]   # 2 layers
    tm = t_mesh.make_mesh(1, 1, 1, ["cpu"] * 4, pp=4)
    with pytest.raises(ValueError, match="not divisible by pipe"):
        t_pipeline.pipeline_forward(cfg, {}, torch.zeros((2, 4), dtype=torch.int32),
                                    None, None, tm)


@pytest.mark.parametrize("model", ["tiny-dense", "tiny-oss"])
@pytest.mark.parametrize("quantized", [False, True])
def test_specs_and_blocks_equal_jax_shards(eight_devices, model, quantized):
    cfg = MODEL_CONFIGS[model]
    params = jax_transformer.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    if quantized:
        params = jax_quantize(params)
    tree = _tree(params)
    for dp, pp, sp, ep, tp in [(1, 1, 1, 2, 2), (1, 1, 2, 1, 2), (2, 1, 1, 1, 2)]:
        jm = jax_mesh.make_mesh(dp, ep, tp, eight_devices[: dp * ep * tp * sp], sp=sp)
        tm = t_mesh.make_mesh(dp, ep, tp, ["cpu"] * (dp * ep * tp * sp), sp=sp)
        jspecs = jax_sharding.param_shardings(params, jm)
        tspecs = t_sharding.param_shardings(tree, tm)
        placed = jax.device_put(params, jspecs)
        for path, leaf in _leaves(tree):
            assert _get(tspecs, path) == tuple(_get(jspecs, path).spec), path
            for shard in _get(placed, path).addressable_shards:
                rank = eight_devices.index(shard.device)
                got = t_sharding.shard_params(tree, tm, rank=rank)
                np.testing.assert_array_equal(_get(got, path), np.asarray(shard.data))
    jm = jax_mesh.make_mesh(1, 1, 2, eight_devices[:4], pp=2)
    tm = t_mesh.make_mesh(1, 1, 2, ["cpu"] * 4, pp=2)
    jspecs = jax_pp_shardings(params, jm)
    tspecs = t_pipeline.pp_param_shardings(tree, tm)
    for path, leaf in _leaves(tree):
        assert _get(tspecs, path) == tuple(_get(jspecs, path).spec), path
        assert t_pipeline.pp_leaf_spec(path, leaf.shape) == _get(tspecs, path)


@pytest.mark.parametrize("axes", [dict(tp=2), dict(pp=2, tp=2), dict(ep=2)])
def test_an_int8_checkpoint_loads_each_block_quantized_whole(tmp_path, axes):
    """``load_checkpoint(mesh=, quantize=True)`` gives each rank the block
    of the JAX package's load quantized whole (a row-parallel leaf's
    per-channel scale is the full reduction's), reading one layer slice
    at a time; without a mesh, the whole quantized load."""
    from sutro_tpu.engine.config import EngineConfig as JaxEngineConfig
    from sutro_tpu.engine.weights import load_checkpoint as jax_load
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.weights import load_checkpoint
    from tests.test_torch_weights_loader import write_hf_checkpoint

    cfg = MODEL_CONFIGS["tiny-moe"]
    write_hf_checkpoint(cfg, 5, tmp_path)
    want = _tree(jax_quantize(jax_load(str(tmp_path), cfg,
                                       JaxEngineConfig(param_dtype="float32"))))
    ecfg = EngineConfig(param_dtype="float32")
    pp, ep, tp = axes.get("pp", 1), axes.get("ep", 1), axes.get("tp", 1)
    mesh = t_mesh.make_mesh(1, ep, tp, ["cpu"] * (pp * ep * tp), pp=pp)
    spec_fn = t_pipeline.pp_leaf_spec if pp > 1 else t_sharding.leaf_spec
    whole = load_checkpoint(str(tmp_path), cfg, ecfg, "cpu", quantize=True)
    for path, leaf in _leaves(want):
        np.testing.assert_array_equal(_get(whole, path).numpy(), leaf, err_msg=str(path))
    for rank in range(mesh.size):
        mesh.rank = rank
        got = load_checkpoint(str(tmp_path), cfg, ecfg, "cpu", mesh, spec_fn, quantize=True)
        for path, leaf in _leaves(want):
            sl = t_sharding.spec_slices(spec_fn(path, leaf.shape), leaf.shape, mesh)
            np.testing.assert_array_equal(_get(got, path).numpy(), leaf[sl],
                                          err_msg=f"rank {rank} {path}")


def test_ranks_sharing_a_card_each_take_a_share():
    """Each rank's allocator cap: its card's share less the margin when
    ranks share the card; none on a card of its own or on the CPU."""
    frac = t_mesh.shared_card_fraction
    margin = t_mesh.SHARED_CARD_MARGIN
    assert frac(["cuda:0", "cuda:0"], "cuda:0") == pytest.approx(0.5 - margin)
    assert frac(["cuda:0", "cuda:1"], "cuda:1") is None
    assert frac(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "cuda:1") == pytest.approx(0.5 - margin)
    assert frac(["cuda"] * 4, "cuda") == pytest.approx(0.25 - margin)
    assert frac(["cpu", "cpu"], "cpu") is None


def _moe_case(rng, B, T, with_bias, H=16, F=32, E=4):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = dict(x=f32(B, T, H), router=f32(H, E), we_gate=f32(E, H, F), we_up=f32(E, H, F),
             we_down=f32(E, F, H))
    if with_bias:
        a.update(router_b=f32(E), we_gate_b=f32(E, F) * 0.1, we_up_b=f32(E, F) * 0.1,
                 we_down_b=f32(E, H) * 0.1)
    kw = dict(top_k=2, activation="swiglu_oss" if with_bias else "silu")
    return a, kw


def test_moe_ep_equals_the_jax_moe(tmp_path):
    rng = np.random.default_rng(3)
    cases, want = [], {}
    for dp, ep, tp in [(1, 2, 1), (1, 2, 2), (1, 4, 1)]:
        for with_bias in (False, True):
            a, kw = _moe_case(rng, 2, 3, with_bias)
            name = f"{dp}{ep}{tp}{'b' if with_bias else ''}"
            cases.append((name, (dp, ep, tp), a, kw))
            jb = {} if not with_bias else dict(
                router_b=a["router_b"], bias_gate=a["we_gate_b"], bias_up=a["we_up_b"],
                bias_down=a["we_down_b"])
            want[name] = np.asarray(jax_moe(
                a["x"], a["router"], a["we_gate"], a["we_up"], a["we_down"], method="dense",
                **kw, **jb))
    a, kw = _moe_case(rng, 3, 2, False, H=8, F=16)    # an odd batch
    cases.append(("odd", (1, 2, 2), a, kw))
    want["odd"] = np.asarray(jax_moe(a["x"], a["router"], a["we_gate"], a["we_up"],
                                     a["we_down"], method="dense", **kw))
    got = mesh_ranks.spawn(4, mesh_ranks.moe_body, cases, tmp_path)
    for name, (dp, ep, tp), a, _ in cases:
        E, _, F = a["we_gate"].shape
        for r in range(dp * ep * tp):
            shape, out = got[r][name]
            assert shape == (E // ep, a["x"].shape[-1], F // tp)   # 1/(ep*tp) resident
            np.testing.assert_allclose(out, want[name], atol=1e-5, rtol=1e-5, err_msg=name)


def test_ring_attention_equals_jax_dense_attention(eight_devices, tmp_path):
    rng = np.random.default_rng(0)
    B, T, NH, KVH, Dh = 2, 32, 4, 2, 8
    a = dict(q=rng.standard_normal((B, T, NH, Dh)).astype(np.float32),
             k=rng.standard_normal((B, T, KVH, Dh)).astype(np.float32),
             v=rng.standard_normal((B, T, KVH, Dh)).astype(np.float32),
             pos=np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy(),
             valid=np.array([20, 32], np.int32))
    sinked = dict(a, sink=rng.standard_normal(NH).astype(np.float32))
    cases = [(f"s{sp}t{tp}", (sp, tp), a, 0) for sp in (2, 4) for tp in (1, 2)]
    cases += [("win_sink", (4, 2), sinked, 8), ("win", (2, 1), a, 8)]
    want = {}
    for name, _, x, window in cases:
        want[name] = np.asarray(jax_chunk_attention(
            x["q"], x["k"], x["v"], positions=x["pos"], valid_len=x["valid"],
            window=jnp.asarray(window, jnp.int32) if window else None,
            sink=None if x.get("sink") is None else jnp.asarray(x["sink"])))
    # one case also against JAX's own ring on the fake devices
    jm = jax_mesh.make_mesh(1, 1, 1, eight_devices[:2], sp=2)
    jring = np.asarray(jax_ring(jm, a["q"], a["k"], a["v"], positions=a["pos"],
                                valid_len=a["valid"]))
    got = mesh_ranks.spawn(8, mesh_ranks.ring_body, cases, tmp_path)
    for name, (sp, tp), x, _ in cases:
        for r in range(sp * tp):
            coords, out = got[r][name]
            hq = t_sharding.block(NH, tp, coords["model"])
            for b, n in enumerate(x["valid"]):
                np.testing.assert_allclose(out[b, :n], want[name][b, :n, hq], atol=1e-5,
                                           err_msg=name)
                if name == "s2t1":
                    np.testing.assert_allclose(out[b, :n], jring[b, :n], atol=1e-5)


def _pages(k, PS, NP):
    """[L, B, T, KVH, Dh] -> a fused pool [L, NP, PS, KVH*Dh] and each
    row's table (row b's tokens on pages 1 + b*MP ...)."""
    L, B, T, KVH, Dh = k.shape
    MP = -(-T // PS)
    pool = np.zeros((L, NP, PS, KVH * Dh), np.float32)
    table = np.zeros((B, MP), np.int32)
    for b in range(B):
        for p in range(MP):
            page = 1 + b * MP + p
            table[b, p] = page
            seg = k[:, b, p * PS:(p + 1) * PS].reshape(L, -1, KVH * Dh)
            pool[:, page, : seg.shape[1]] = seg
    return pool, table


@pytest.mark.parametrize("model", ["tiny-dense", "tiny-oss"])
def test_pipeline_equals_the_jax_forward(model, tmp_path):
    cfg = MODEL_CONFIGS[model]
    params = jax_transformer.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tree = _tree(params)
    B, T, PS = 4, 16, 8
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    vl = np.array([16, 9, 16, 3], np.int32)
    ref, _, (k_ref, v_ref) = jax_transformer.forward(cfg, params, ids, pos, vl)
    k_ref, v_ref = np.asarray(k_ref), np.asarray(v_ref)
    # one decode token per row over pages that hold its prompt
    k_pages, table = _pages(k_ref, PS, 1 + B * 2)
    v_pages, _ = _pages(v_ref, PS, 1 + B * 2)
    dec_ids = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    dec, _, _ = jax_transformer.forward(
        cfg, params, dec_ids, vl[:, None], np.ones(B, np.int32),
        paged_past=(k_pages, v_pages, table), past_len=vl)
    a = dict(ids=ids, pos=pos, vl=vl, k_pages=k_pages, v_pages=v_pages, table=table,
             dec_ids=dec_ids, dec_pos=vl[:, None].copy(), past=vl)
    cases = [(f"p{pp}t{tp}m{m}", model, (pp, tp, m), tree, a)
             for pp, tp, m in [(2, 1, 2), (2, 1, 4), (2, 2, 2)]]
    got = mesh_ranks.spawn(4, mesh_ranks.pipeline_body, cases, tmp_path)
    L, KVH = cfg.num_layers, cfg.num_kv_heads
    for name, _, (pp, tp, m), _, _ in cases:
        for r in range(pp * tp):
            g = got[r][name]
            c = g["coords"]
            lay = t_sharding.block(L, pp, c["pipe"])
            hk = t_sharding.block(KVH, tp, c["model"])
            assert g["layers"] == g["pool_layers"] == L // pp   # only its stage
            for b, n in enumerate(vl):   # padding positions are undefined
                np.testing.assert_allclose(g["logits"][b, :n], np.asarray(ref)[b, :n],
                                           atol=2e-4, err_msg=name)
                np.testing.assert_allclose(g["k"][:, b, :n], k_ref[lay][:, b, :n, hk],
                                           atol=2e-4)
                np.testing.assert_allclose(g["v"][:, b, :n], v_ref[lay][:, b, :n, hk],
                                           atol=2e-4)
            np.testing.assert_allclose(g["decode"], np.asarray(dec), atol=2e-4, err_msg=name)
