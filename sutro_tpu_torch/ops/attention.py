"""Attention ops.

``chunk_attention`` is the single attention entry point for both prefill
(T=chunk, no past) and decode (T=1 over the paged KV cache), with the
signature of ``sutro_tpu/ops/attention.py``. It dispatches by case, on
any device:

- T == 1 over pages -> the paged-decode kernel (ops/paged_decode.py);
  with shared-prefix groups, first one prefix-carry kernel per group
  (ops/prefix_carry.py), whose carry the paged-decode kernel starts from;
- no past, any T -> the flash-prefill kernel (ops/flash_prefill.py);
- T > 1 over paged past (chunked long prompts, suffix prefill) -> one
  layer's pages gathered into a contiguous view, then the dense path
  below, exactly as the reference does (that case has no kernel there).

Over an int8 pool (``past_k_scale``/``past_v_scale``) the T == 1 case
takes the paged-decode kernel's int8 option (and, with shared-prefix
groups, the reference's XLA carry with the scales), and T > 1
dequantizes the gathered pages into the compute dtype.

Each kernel wrapper launches its CUDA kernel on a CUDA tensor and runs
its plain PyTorch version on a CPU tensor, so the CPU tests drive the
same dispatch, shapes and layouts as the card.

Semantics handled here, uniformly: GQA head grouping (query head n reads
KV head n // G), causal masking within the chunk, past-length masking,
per-layer sliding windows, and learnable attention sinks (an extra
per-head softmax logit with no value row). Masked scores are -1e30.

With ``ring_mesh`` (a mesh whose ``seq`` axis is > 1) and no past,
``T > 1`` takes the ring path (ops/ring_attention.py), as the reference
does: the caller (models/transformer.py) holds this rank's contiguous
chunk of the sequence, and the K/V chunks go around the ``seq`` ring.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_prefill import flash_prefill
from .paged_decode import paged_decode_attention
from .prefix_carry import prefix_attention_carry

NEG_INF = -1e30


def chunk_attention(
    q: torch.Tensor,                        # [B, T, NH, Dh]
    k: torch.Tensor,                        # [B, T, KVH, Dh] (chunk, post-RoPE)
    v: torch.Tensor,                        # [B, T, KVH, Dh]
    *,
    positions: torch.Tensor,                # [B, T] global positions of queries
    valid_len: torch.Tensor,                # [B] valid tokens in the chunk
    past_k: Optional[torch.Tensor] = None,  # [B, CTX, KVH, Dh]
    past_v: Optional[torch.Tensor] = None,
    past_len: Optional[torch.Tensor] = None,  # [B]
    # paged past: one layer's FUSED [NP, PS, KVH*Dh] pools + table;
    # mutually exclusive with past_k/past_v
    past_k_pages: Optional[torch.Tensor] = None,
    past_v_pages: Optional[torch.Tensor] = None,
    # int8 KV mode: per-token dequantization scales of this layer's pages
    past_k_scale: Optional[torch.Tensor] = None,  # [NP, PS] f32
    past_v_scale: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,  # [B, MP] int32
    window: int = 0,                        # 0 => full attention
    sink: Optional[torch.Tensor] = None,    # [NH] attention-sink logits
    # fused-decode window buffer: K/V of tokens sampled earlier in the
    # window, not yet in the pool; [B, W, KVH*Dh], valid while
    # slot < win_len, positions past_len + slot
    win_k: Optional[torch.Tensor] = None,
    win_v: Optional[torch.Tensor] = None,
    win_len: int = 0,
    # shared-prefix (Hydragen-style) decode: ((pages [Pp] int32, pfx_len
    # [B] int32), ...), one per group; member rows' tables START with
    # the group's pages (pfx_len 0: not a member; groups are disjoint).
    # T == 1 only: T > 1 ignores them (the tables still hold the prefix
    # pages, so the gather computes the same function).
    pfx_groups: Optional[tuple] = None,
    # a mesh with ``seq`` > 1: q/k/v/positions are this rank's chunk of
    # a no-past prefill, ``valid_len`` counts the whole sequence's
    ring_mesh=None,
) -> torch.Tensor:
    """Returns [B, T, NH, Dh]."""
    B, T, NH, Dh = q.shape
    KVH = k.shape[2]
    window = int(window or 0)
    if ring_mesh is not None and past_k is None and past_k_pages is None:
        from .ring_attention import ring_attention_local

        kv_valid = positions.long() < valid_len.long()[:, None]
        return ring_attention_local(
            q, k, v, positions, positions, kv_valid, window, sink,
            group=ring_mesh.group("seq"),
        )
    if past_k_pages is not None:
        if T == 1:
            carry = {}
            if pfx_groups:
                carry = _prefix_carry(
                    q[:, 0], past_k_pages, past_v_pages, pfx_groups,
                    past_len + int(win_len), window, past_k_scale, past_v_scale,
                )
            out = paged_decode_attention(
                q[:, 0], past_k_pages, past_v_pages, page_table, past_len,
                k[:, 0], v[:, 0], window, sink,
                win_k=win_k, win_v=win_v, win_len=win_len,
                k_scale=past_k_scale, v_scale=past_v_scale, **carry,
            )
            return out[:, None]
        from ..engine.kvcache import gather_kv_layer

        past_k, past_v = gather_kv_layer(
            past_k_pages, past_v_pages, page_table, KVH,
            past_k_scale, past_v_scale, out_dtype=q.dtype,
        )
    elif past_k is None:
        # no past: query/key positions are [0, T) (the runner's prefill
        # guarantees it, as the reference's flash path assumes)
        return flash_prefill(q, k, v, window=window, sink=sink)

    G = NH // KVH
    scale = Dh ** -0.5
    dev = q.device
    ctx = past_k.shape[1]
    ar_ctx = torch.arange(ctx, device=dev)
    ar_t = torch.arange(T, device=dev)
    key_segs = [past_k, k]
    val_segs = [past_v, v]
    pos_segs = [ar_ctx[None].expand(B, ctx), positions.long()]
    valid_segs = [
        ar_ctx[None] < past_len.long()[:, None],
        ar_t[None] < valid_len.long()[:, None],
    ]
    if win_k is not None and win_k.shape[1] > 0:
        W = win_k.shape[1]
        slot = torch.arange(W, device=dev)
        key_segs.insert(1, win_k.reshape(B, W, KVH, Dh))
        val_segs.insert(1, win_v.reshape(B, W, KVH, Dh))
        pos_segs.insert(1, past_len.long()[:, None] + slot[None])
        valid_segs.insert(1, (slot < int(win_len))[None].expand(B, W))
    keys = torch.cat([x.float() for x in key_segs], 1)
    vals = torch.cat([x.float() for x in val_segs], 1)
    key_pos = torch.cat(pos_segs, 1)
    key_valid = torch.cat(valid_segs, 1)

    S = keys.shape[1]
    qg = q.float().reshape(B, T, KVH, G, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, keys) * scale

    qp = positions.long()[:, :, None]                 # [B, T, 1]
    kp = key_pos[:, None, :]                          # [B, 1, S]
    allowed = (kp <= qp) & key_valid[:, None, :]
    if window > 0:
        allowed = allowed & (qp - kp < window)
    scores = torch.where(
        allowed[:, None, None], scores, torch.full_like(scores, NEG_INF)
    )
    if sink is not None:
        col = sink.float().reshape(1, KVH, G, 1, 1).expand(B, KVH, G, T, 1)
        weights = torch.softmax(torch.cat([scores, col], -1), -1)[..., :S]
    else:
        weights = torch.softmax(scores, -1)
    out = torch.einsum("bkgts,bskd->btkgd", weights, vals)
    return out.reshape(B, T, NH, Dh).to(q.dtype)


def _prefix_carry(
    q, k_pages, v_pages, pfx_groups, q_pos, window, k_scale=None, v_scale=None,
) -> dict:
    """The paged-decode kernel's carry operands for ``pfx_groups``: one
    carry per group, combined by max/sum/sum (member sets are disjoint
    and a non-member's carry is the cold (-1e30, 0, 0), so the
    combination is exact), and ``pfx_cnt`` = the shared pages each row
    skips. Over an int8 pool each carry is the reference's XLA function
    with the scales (ops/prefix_carry.py): no TPU kernel computes it."""
    PS = k_pages.shape[1]
    m0 = l0 = acc0 = pfx_cnt = None
    for pages, pfx_len in pfx_groups:
        mg, lg, ag = prefix_attention_carry(
            q, k_pages, v_pages, pages, pfx_len, q_pos, window, k_scale, v_scale
        )
        cnt = torch.div(pfx_len, PS, rounding_mode="floor")
        if m0 is None:
            m0, l0, acc0, pfx_cnt = mg, lg, ag, cnt
        else:
            m0 = torch.maximum(m0, mg)
            l0 = l0 + lg
            acc0 = acc0 + ag
            pfx_cnt = pfx_cnt + cnt
    return dict(pfx_cnt=pfx_cnt.to(torch.int32), m0=m0, l0=l0, acc0=acc0)
