"""Sharding rules: which block of each parameter a rank holds.

Port of ``sutro_tpu/parallel/sharding.py``, with the same tables leaf
for leaf (Megatron TP over ``model``, experts over ``expert``):

- attention: the head axis of wq/wk/wv (and their biases, and the
  sinks) split over ``model``; wo split on its input (head) axis, so the
  block ends in one all-reduce;
- MLP: w_gate/w_up split on the FFN axis, w_down on its input, one
  all-reduce; MoE: the expert axis of we_* over ``expert`` and their FFN
  axis over ``model``, the router replicated;
- embed replicated; lm_head split over the vocabulary (logits gathered
  before sampling);
- KV pages split on the fused ``KVH*Dh`` axis over ``model`` in
  whole-KV-head blocks, matching the heads;
- no rule names ``data``: every data rank holds the same blocks and the
  same pool; only the MoE layers' tokens split over it
  (:func:`data_sharding`, ops/moe_ep.py).

A spec is a tuple of mesh-axis names or None per dimension, the
reference's ``PartitionSpec`` as a tuple. The reference hands the specs
to ``jax.device_put``; here :func:`shard_params` cuts each full leaf
down to this rank's block (``ceil(n / size)`` elements per block, the
blocks JAX lays out), and XLA's inserted collectives are written out in
models/transformer.py, ops/moe_ep.py, ops/ring_attention.py and
parallel/pipeline.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[str], ...]

# leaf name (within params["layers"] or top level) -> spec
_LAYER_RULES: Dict[str, Spec] = {
    "attn_norm": (),
    "mlp_norm": (),
    "post_attn_norm": (),
    "post_mlp_norm": (),
    "q_norm": (),
    "k_norm": (),
    "sink": (None, "model"),            # [L, NH]
    "wq": (None, None, "model"),        # [L, H, NHD]
    "wk": (None, None, "model"),
    "wv": (None, None, "model"),
    "bq": (None, "model"),
    "bk": (None, "model"),
    "bv": (None, "model"),
    "wo": (None, "model", None),        # [L, NHD, H]
    "bo": (),
    "w_gate": (None, None, "model"),    # [L, H, F]
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),    # [L, F, H]
    "router": (),                       # [L, H, E]
    "router_b": (),                     # [L, E]
    "we_gate": (None, "expert", None, "model"),  # [L, E, H, F]
    "we_up": (None, "expert", None, "model"),
    "we_down": (None, "expert", "model", None),  # [L, E, F, H]
    "we_gate_b": (None, "expert", "model"),      # [L, E, F]
    "we_up_b": (None, "expert", "model"),
    "we_down_b": (None, "expert", None),         # [L, E, H]
}

_TOP_RULES: Dict[str, Spec] = {
    "embed": (),                        # replicated
    "final_norm": (),
    "lm_head": (None, "model"),         # [H, V] vocab-parallel logits
}


def leaf_spec(path: Sequence[str], shape: Sequence[int]) -> Spec:
    """The rule for the leaf at ``path`` (its keys from the root):
    quantized ``qw``/``scale`` leaves take their weight's rule; a spec
    longer than the leaf is cut to its rank; size-1 dimensions are never
    split (``scale``'s collapsed reduction axis)."""
    names = list(path)
    name = names[-1]
    if name in ("qw", "scale") and len(names) >= 2:
        name = names[-2]
    rules = _LAYER_RULES if "layers" in names else _TOP_RULES
    spec = tuple(rules.get(name, ()))[: len(shape)]
    if any(d == 1 for d in shape) and spec:
        spec = tuple(None if shape[i] == 1 else ax for i, ax in enumerate(spec))
    return spec


def _map(params: Any, fn, path=()) -> Any:
    if isinstance(params, dict):
        return {k: _map(v, fn, (*path, k)) for k, v in params.items()}
    return fn(path, params)


def param_shardings(params: Any, mesh=None) -> Any:
    """The spec of every leaf of ``params`` (same tree)."""
    return _map(params, lambda path, x: leaf_spec(path, tuple(x.shape)))


def block(n: int, size: int, coord: int) -> slice:
    """The ``coord``-th of ``size`` blocks of ``n`` (``ceil(n/size)``
    each, the last one short when ``size`` does not divide ``n``)."""
    b = -(-n // size)
    return slice(min(coord * b, n), min((coord + 1) * b, n))


def spec_slices(spec: Spec, shape: Sequence[int], mesh, rank: Optional[int] = None):
    """Per-dimension slices of this rank's block under ``spec``."""
    c = mesh.coords(rank)
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        out.append(slice(None) if ax is None else block(n, mesh.shape[ax], c[ax]))
    return tuple(out)


def shard_params(params: Any, mesh, rank: Optional[int] = None, specs: Any = None) -> Any:
    """This rank's block of every full leaf of ``params`` (views; the
    caller moves them to the rank's device). ``specs`` defaults to
    :func:`param_shardings`; parallel/pipeline.py passes its own."""
    specs = param_shardings(params, mesh) if specs is None else specs

    def cut(path, x):
        node = specs
        for k in path:
            node = node[k]
        return x[spec_slices(node, tuple(x.shape), mesh, rank)]

    return _map(params, cut)


def check_tp_divides_kv_heads(mesh, kv_heads: Optional[int]) -> None:
    """The fused KV-pool trailing axis is KV-head-major, so splitting it
    over ``model`` splits whole KV heads only if the model-axis size
    divides the KV head count: a mid-head split would corrupt every
    shard's attention."""
    tp = int(mesh.shape.get("model", 1))
    if kv_heads is not None and kv_heads % max(tp, 1):
        raise ValueError(
            f"TP axis size {tp} must divide num_kv_heads {kv_heads}: the "
            "fused KV-pool axis shards in whole-head blocks"
        )


def cache_shardings(mesh, kv_heads: Optional[int] = None) -> Spec:
    """[L, NP, PS, KVH*Dh]: the fused trailing axis over ``model`` in
    whole-KV-head blocks."""
    check_tp_divides_kv_heads(mesh, kv_heads)
    return (None, None, None, "model")


def data_sharding(mesh=None) -> Spec:
    """Batch rows over ``data`` (ops/moe_ep.py cuts its tokens by it)."""
    return ("data",)


def replicated(mesh=None) -> Spec:
    return ()


def local_shape(shape: Sequence[int], spec: Spec, mesh, rank: Optional[int] = None):
    return tuple(
        len(range(*s.indices(n))) for s, n in zip(spec_slices(spec, shape, mesh, rank), shape)
    )


def to_device(params: Any, device) -> Any:
    """Every leaf moved to ``device`` as a contiguous tensor."""
    return _map(params, lambda _, x: torch.as_tensor(x).to(device).contiguous())
