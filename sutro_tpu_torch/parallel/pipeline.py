"""Pipeline parallelism: stage-sharded layers, a GPipe prefill and a
stage-sequential decode.

Port of ``sutro_tpu/parallel/pipeline.py``:

- the stacked ``[L, ...]`` layer axis is split over ``pipe``
  (:func:`pp_param_shardings`), so each rank holds a contiguous stage
  of ``L/pp`` layers (and their pages, :func:`pp_cache_sharding`); the
  checkpoint layout is the same for TP, EP and PP;
- :func:`pipeline_forward` runs GPipe over ``n_microbatches``
  (default ``min(pp, B)``): microbatch activations go stage to stage by
  send/recv, the bubble is ``(pp-1)/(M+pp-1)``;
- :func:`pipeline_decode` is stage-sequential: each stage runs ONLY its
  layers over its own pages, so a rank reads ``1/pp`` of the weights
  and the pool in a step (the ``(pp-1)/pp`` bubble of one batch in
  flight is inherent);
- the embedding runs on every stage (replicated, cheap), the last
  stage's output is broadcast over ``pipe``, and the head runs on every
  rank (TP-split as usual), so every rank returns the same logits.

Both return ``transformer.forward``'s ``(out, hidden, (k, v))``, with
the K/V of the rank's own layers only (``[L/pp, B, T, KVH, Dh]``), which
the runner writes into its own pages. TP and EP compose inside a stage
(models/transformer.py, ops/moe_ep.py); the ring (sp) does not, as in
the reference.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from ..models import transformer
from ..models.configs import ModelConfig
from .sharding import Spec, _map, check_tp_divides_kv_heads, leaf_spec


def pp_leaf_spec(path: Sequence[str], shape: Sequence[int]) -> Spec:
    """``leaf_spec`` with the stacked layer axis over ``pipe``."""
    spec = leaf_spec(path, shape)
    if "layers" not in path:
        return spec
    spec = list(spec) or [None]
    spec[0] = "pipe"
    return tuple(spec)


def pp_param_shardings(params: Any, mesh=None) -> Any:
    """TP/EP rules with the layers' leading axis over ``pipe`` (embed,
    head and final norm keep their top-level rules)."""
    return _map(params, lambda path, x: pp_leaf_spec(path, tuple(x.shape)))


def pp_cache_sharding(mesh, kv_heads: Optional[int] = None) -> Spec:
    """KV pages [L, NP, PS, KVH*Dh]: layers over ``pipe``, the fused
    trailing axis over ``model`` in whole-KV-head blocks."""
    check_tp_divides_kv_heads(mesh, kv_heads)
    return ("pipe", None, None, "model")


def _stage(cfg: ModelConfig, mesh) -> Tuple[int, int, range]:
    S = int(mesh.shape["pipe"])
    L = cfg.num_layers
    if L % S:
        raise ValueError(f"layers {L} not divisible by pipe size {S}")
    s = mesh.coords()["pipe"]
    Lb = L // S
    return S, s, range(s * Lb, (s + 1) * Lb)


def _finish(cfg, params, h, valid_len, mesh, S, s, head_index):
    """The last stage's hidden states to every stage, then the head."""
    pipe = mesh.group("pipe")
    if pipe is not None:
        pipe.broadcast(h, S - 1)
    if head_index is not None and cfg.head == "lm":
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, head_index.long()][:, None]
    return transformer.head_apply(cfg, params, h, valid_len, mesh)


def pipeline_forward(
    cfg: ModelConfig,
    params: Any,             # this stage's layers, the whole embed/head
    ids: torch.Tensor,       # [B, T] int
    positions: torch.Tensor,  # [B, T]
    valid_len: torch.Tensor,  # [B]
    mesh,
    *,
    n_microbatches: Optional[int] = None,
    head_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """GPipe-scheduled trunk forward (prefill; no KV past). ``B`` must
    divide into ``n_microbatches`` and ``L`` into ``pp``."""
    S, s, layers = _stage(cfg, mesh)
    B, T = ids.shape
    H = cfg.hidden_size
    M = n_microbatches or min(S, B)
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    mb = B // M
    pipe = mesh.group("pipe")
    h0 = transformer.embed_tokens(cfg, params, ids)
    out = torch.empty_like(h0)
    ks, vs = [None] * M, [None] * M
    for t in range(M + S - 1):
        m = t - s                      # the microbatch at this stage now
        if not 0 <= m < M:
            continue
        rows = slice(m * mb, (m + 1) * mb)
        x = h0[rows] if s == 0 else pipe.recv(
            torch.empty((mb, T, H), dtype=h0.dtype, device=h0.device), s - 1, tag=m)
        y, k_l, v_l = transformer.run_layers(
            cfg, params, x, layers, positions[rows], valid_len[rows], mesh=mesh,
        )
        ks[m], vs[m] = torch.stack(k_l), torch.stack(v_l)
        if s < S - 1:
            pipe.send(y, s + 1, tag=m)
        else:
            out[rows] = y
    logits, h = _finish(cfg, params, out, valid_len, mesh, S, s, head_index)
    return logits, h, (torch.cat(ks, 1), torch.cat(vs, 1))


def pipeline_decode(
    cfg: ModelConfig,
    params: Any,
    ids: torch.Tensor,          # [B, T] (decode: T == 1)
    positions: torch.Tensor,    # [B, T]
    valid_len: torch.Tensor,    # [B]
    paged_past: tuple,          # this stage's pools (engine/kvcache.py)
    past_len: torch.Tensor,     # [B]
    mesh,
    *,
    window_past: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
    head_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Stage-local step over the paged past under ``pipe > 1``: the
    activation hops stage to stage and each rank runs only its own
    layers over its own pages and window buffers."""
    S, s, layers = _stage(cfg, mesh)
    pipe = mesh.group("pipe")
    h = transformer.embed_tokens(cfg, params, ids)
    if s > 0:
        h = pipe.recv(torch.empty_like(h), s - 1)
    h, ks, vs = transformer.run_layers(
        cfg, params, h, layers, positions, valid_len, paged_past, past_len,
        window_past, mesh=mesh,
    )
    if s < S - 1:
        pipe.send(h, s + 1)
    logits, h = _finish(cfg, params, h, valid_len, mesh, S, s, head_index)
    return logits, h, (torch.stack(ks), torch.stack(vs))
