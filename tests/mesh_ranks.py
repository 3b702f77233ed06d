"""Rank bodies for the port's mesh tests, run in spawned processes.

Nothing here imports JAX: the test computes the JAX side first and
passes numpy arrays; each rank builds its mesh on a file store under the
test's ``tmp_path``, runs the port's function on its block, and writes
what it got to ``rank<r>.pkl`` there. Every rank uses one intra-op
thread, and every collective and join has a timeout.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 60.0


def spawn(world: int, body, payload, out_dir, timeout: float = 180.0) -> list:
    """Run ``body(rank, payload, out_dir)`` on ``world`` spawned ranks;
    returns their results in rank order, or raises with the failures."""
    out_dir = str(out_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(r, body, payload, out_dir), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            errors.append(open(path).read())
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    assert not hung and not errors, f"hung ranks {hung}:\n" + "\n".join(errors)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(rank, body, payload, out_dir) -> None:
    os.environ["SUTRO_MESH_TIMEOUT"] = str(TIMEOUT_S)
    torch.set_num_threads(1)
    try:
        got = body(rank, payload, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def connect(rank: int, out_dir: str, name: str, dp=1, ep=1, tp=1, sp=1, pp=1):
    """This rank's mesh of CPU ranks, or None when the rank is outside it."""
    from sutro_tpu_torch.parallel.mesh import file_store, make_mesh

    world = dp * ep * tp * sp * pp
    if rank >= world:
        return None
    mesh = make_mesh(dp, ep, tp, ["cpu"] * world, sp=sp, pp=pp)
    return mesh.connect(file_store(os.path.join(out_dir, f"store-{name}"), world), rank,
                        timeout=TIMEOUT_S)


def _t(x):
    return torch.from_numpy(np.array(x))


def moe_body(rank, cases, out_dir) -> dict:
    """ops/moe_ep.py on each case's mesh: the weights cut by the
    sharding rules (a one-layer tree), the output of every rank."""
    from sutro_tpu_torch.ops.moe_ep import moe_mlp_ep
    from sutro_tpu_torch.parallel.sharding import shard_params

    got = {}
    for name, (dp, ep, tp), arrays, kw in cases:
        mesh = connect(rank, out_dir, name, dp=dp, ep=ep, tp=tp)
        if mesh is None:
            continue
        layer = {k: _t(v)[None] for k, v in arrays.items() if k not in ("x", "router", "router_b")}
        local = {k: v[0] for k, v in shard_params({"layers": layer}, mesh)["layers"].items()}
        out = moe_mlp_ep(
            _t(arrays["x"]), _t(arrays["router"]), local["we_gate"], local["we_up"],
            local["we_down"], mesh=mesh,
            router_b=None if "router_b" not in arrays else _t(arrays["router_b"]),
            bias_gate=local.get("we_gate_b"), bias_up=local.get("we_up_b"),
            bias_down=local.get("we_down_b"), **kw,
        )
        got[name] = (tuple(local["we_gate"].shape), out.numpy())
        mesh.close()
    return got


def ring_body(rank, cases, out_dir) -> dict:
    """ops/ring_attention.py: each case's heads cut over ``model``, the
    whole sequence's output of every rank with its coordinates."""
    from sutro_tpu_torch.ops.ring_attention import ring_self_attention
    from sutro_tpu_torch.parallel.sharding import block

    got = {}
    for name, (sp, tp), a, window in cases:
        mesh = connect(rank, out_dir, name, tp=tp, sp=sp)
        if mesh is None:
            continue
        c = mesh.coords()["model"]
        NH, KVH = a["q"].shape[2], a["k"].shape[2]
        hq, hk = block(NH, tp, c), block(KVH, tp, c)
        sink = None if a.get("sink") is None else _t(a["sink"])[hq]
        out = ring_self_attention(
            mesh, _t(a["q"])[:, :, hq], _t(a["k"])[:, :, hk], _t(a["v"])[:, :, hk],
            positions=_t(a["pos"]), valid_len=_t(a["valid"]), window=window, sink=sink,
        )
        got[name] = (mesh.coords(), out.numpy())
        mesh.close()
    return got


def pipeline_body(rank, cases, out_dir) -> dict:
    """parallel/pipeline.py: ``pipeline_forward`` over a prompt, then
    ``pipeline_decode`` of one token over pages holding that prompt,
    each rank on its stage's layers and its heads' pages."""
    from sutro_tpu_torch.engine.weights import params_from_numpy
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    from sutro_tpu_torch.parallel import sharding
    from sutro_tpu_torch.parallel.pipeline import (
        pipeline_decode, pipeline_forward, pp_cache_sharding, pp_param_shardings,
    )

    got = {}
    for name, model, (pp, tp, m), tree, a in cases:
        mesh = connect(rank, out_dir, name, tp=tp, pp=pp)
        if mesh is None:
            continue
        cfg = MODEL_CONFIGS[model]
        full = params_from_numpy(cfg, tree, "cpu", torch.float32)
        params = sharding.shard_params(full, mesh, specs=pp_param_shardings(full, mesh))
        params = sharding.to_device(params, "cpu")
        logits, _, (k, v) = pipeline_forward(
            cfg, params, _t(a["ids"]), _t(a["pos"]), _t(a["vl"]), mesh, n_microbatches=m,
        )
        pool_spec = pp_cache_sharding(mesh, cfg.num_kv_heads)
        kp = _t(a["k_pages"])[sharding.spec_slices(pool_spec, a["k_pages"].shape, mesh)]
        vp = _t(a["v_pages"])[sharding.spec_slices(pool_spec, a["v_pages"].shape, mesh)]
        dec, _, _ = pipeline_decode(
            cfg, params, _t(a["dec_ids"]), _t(a["dec_pos"]), torch.ones(len(a["past"]),
                                                                       dtype=torch.int32),
            (kp.contiguous(), vp.contiguous(), _t(a["table"])), _t(a["past"]), mesh,
        )
        got[name] = dict(
            coords=mesh.coords(), logits=logits.numpy(), k=k.numpy(), v=v.numpy(),
            decode=dec.numpy(), layers=int(params["layers"]["wq"].shape[0]),
            pool_layers=int(kp.shape[0]),
        )
        mesh.close()
    return got


def resident_shapes(runner) -> dict:
    """An ``on_ranks`` body: the shapes of this rank's expert, router and
    embedding blocks and of its K pool."""
    layers = runner.params["layers"]
    out = {k: tuple(layers[k].shape) for k in ("we_gate", "we_down", "router") if k in layers}
    out["embed"] = tuple(runner.params["embed"].shape)
    out["pool"] = tuple(runner.cache.k_pages.shape)
    return out


def resident_sums(runner) -> dict:
    """An ``on_ranks`` body: a float64 sum of each of this rank's layer
    blocks."""
    return {k: float(v.double().sum()) for k, v in runner.params["layers"].items()}


def raise_alike(runner):
    """An ``on_ranks`` body that raises the same error on every rank."""
    raise ValueError("every rank refuses alike")


def raise_naming_the_rank(runner):
    """An ``on_ranks`` body whose error differs from rank to rank."""
    raise ValueError(f"rank {runner.mesh.rank} refuses")
