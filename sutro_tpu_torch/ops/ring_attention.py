"""Ring attention over the ``seq`` mesh axis (sequence parallelism for
long prompts).

Port of ``sutro_tpu/ops/ring_attention.py``:

- each ``seq`` rank keeps its contiguous chunk of the sequence's Q, K
  and V (``[B, T/S, ...]``);
- K/V chunks (with their global positions and validity) go once around
  the ring, one neighbour exchange a step (``Group.shift``: sends and
  receives posted together, the reference's ``ppermute``);
- each step folds its block into a float32 online softmax (running max
  ``m``, denominator ``l``, numerator ``acc``), so the result is exact
  attention up to float32 summation order;
- causality, padding, sliding windows and gpt-oss sinks are masks on
  GLOBAL positions, so the result does not depend on the rotation
  order;
- heads keep their ``model`` split (attention is per head), so a ring
  step moves ``1/tp`` of the K/V.

The reference's body is ``jnp.einsum``, not a Pallas kernel; plain
torch einsums are its counterpart here, on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _ring_body(qg, q_pos, scale, window, k_c, v_c, kp_c, kval_c, m, l, acc):
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_c.float()) * scale
    qp = q_pos.long()[:, :, None]                 # [B, Tq, 1]
    kp = kp_c.long()[:, None, :]                  # [B, 1, S]
    allowed = (kp <= qp) & kval_c[:, None, :]
    if window > 0:
        allowed = allowed & ((qp - kp) < window)
    mask = allowed[:, None, None]                 # [B, 1, 1, Tq, S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m_new = torch.maximum(m, scores.amax(-1))
    p = torch.exp(scores - m_new[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))  # exact zeros when masked
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bkgts,bskd->bkgtd", p, v_c.float())
    return m_new, l, acc


def ring_attention_local(
    q: torch.Tensor,         # [B, Tq, NH_local, Dh] this rank's Q chunk
    k: torch.Tensor,         # [B, Tc, KVH_local, Dh] this rank's K chunk
    v: torch.Tensor,
    q_pos: torch.Tensor,     # [B, Tq] global positions
    kv_pos: torch.Tensor,    # [B, Tc] global positions of the K/V chunk
    kv_valid: torch.Tensor,  # [B, Tc] bool: real (non-pad) K/V tokens
    window: int,             # 0 = full
    sink: Optional[torch.Tensor],  # [NH_local] or None
    *,
    group,                   # the seq axis's Group (None: a ring of one)
) -> torch.Tensor:
    """One rank's share of ring attention. Returns [B, Tq, NH, Dh]."""
    B, Tq, NH, Dh = q.shape
    KVH = k.shape[2]
    G = NH // KVH
    scale = Dh ** -0.5
    qg = q.float().reshape(B, Tq, KVH, G, Dh)
    dev = q.device
    m = torch.full((B, KVH, G, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, Tq, Dh), dtype=torch.float32, device=dev)
    ring = 1 if group is None else group.size
    k_c, v_c, kp_c, kval_c = k, v, kv_pos, kv_valid
    for i in range(ring):
        m, l, acc = _ring_body(qg, q_pos, scale, int(window or 0),
                               k_c, v_c, kp_c, kval_c, m, l, acc)
        if i < ring - 1:   # the last rotation would go unused
            k_c, v_c, kp_c, kval_c = group.shift([k_c, v_c, kp_c, kval_c])
    if sink is not None:
        sk = sink.float().reshape(KVH, G)
        l = l + torch.exp(sk[None, :, :, None] - m)
    out = acc / l[..., None].clamp(min=1e-30)
    # [B, KVH, G, Tq, Dh] -> [B, Tq, NH, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, NH, Dh).to(q.dtype)


def seq_chunk(mesh, T: int) -> slice:
    """This rank's contiguous chunk of ``T`` positions over ``seq``;
    raises when ``T`` does not divide by the axis size."""
    S = int(mesh.shape["seq"])
    if T % S:
        raise ValueError(f"T={T} not divisible by seq axis size {S}")
    c = T // S
    i = mesh.coords()["seq"]
    return slice(i * c, (i + 1) * c)


def ring_self_attention(
    mesh,
    q: torch.Tensor,              # [B, T, NH_local, Dh] (the whole sequence)
    k: torch.Tensor,              # [B, T, KVH_local, Dh]
    v: torch.Tensor,
    *,
    positions: torch.Tensor,      # [B, T]
    valid_len: torch.Tensor,      # [B]
    window: Optional[int] = None,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel causal self-attention with no past over whole
    ``[B, T, ...]`` tensors that every ``seq`` rank holds: each rank runs
    its chunk around the ring and the chunks are gathered back. ``T``
    must divide by the ``seq`` size."""
    T = q.shape[1]
    sl = seq_chunk(mesh, T)
    kv_valid = torch.arange(T, device=q.device)[None, :] < valid_len.long()[:, None]
    group = mesh.group("seq")
    out = ring_attention_local(
        q[:, sl], k[:, sl], v[:, sl], positions[:, sl], positions[:, sl],
        kv_valid[:, sl], int(window or 0), sink, group=group,
    )
    return out if group is None else group.all_gather(out, 1)
