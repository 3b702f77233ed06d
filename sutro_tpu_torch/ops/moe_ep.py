"""Expert-parallel MoE MLP over a mesh (experts over ``expert``, their
FFN axis over ``model``).

Port of ``sutro_tpu/ops/moe_ep.py``, with its exact partitioning. Each
rank holds ``[E/ep, H, F/tp]`` of every expert weight
(parallel/sharding.py) and the whole (replicated) router, and:

- routes every token through the shared ``_route`` (ops/moe.py);
- sorts the ``N * top_k`` expanded rows so the rows owned by ITS
  experts come first, grouped by local expert, stably; unowned rows are
  zero-masked into the last group, so no token is ever dropped and the
  shapes are static (no capacity factor);
- runs the three grouped GEMMs on its expert slice through the port's
  grouped-GEMM kernel (ops/grouped_matmul.py, ``csrc/grouped_matmul.cu``
  on the card);
- divides ``bias_down`` by the ``model`` size (every model rank would
  add it, and the reduction sums them);
- combines each token's ``top_k`` rows in a fixed order in float32, as
  ops/moe.py does, then ONE all-reduce over ``("expert", "model")``
  merges the expert contributions and the TP partial sums.

The mesh's ``data`` axis splits the tokens, as the reference's
``in_specs`` do: when ``dp`` divides the batch each rank takes its data
coordinate's ``B/dp`` rows (``sharding.data_sharding``), runs the body on
them, and after the expert all-reduce one all-gather over ``data``
restores the batch in rank order. An odd batch is replicated: every data
rank runs every token, as in the reference.

Under sp or pp the reference falls back to XLA's own partitioning of
the plain MoE; the port runs this same body there (it computes the same
function).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import sharding
from . import moe
from .grouped_matmul import grouped_matmul


def moe_mlp_ep(
    x: torch.Tensor,          # [B, T, H]
    router: torch.Tensor,     # [H, E] (replicated)
    we_gate: torch.Tensor,    # [E/ep, H, F/tp] this rank's block
    we_up: torch.Tensor,
    we_down: torch.Tensor,    # [E/ep, F/tp, H]
    *,
    mesh,
    top_k: int,
    activation: str = "silu",
    router_b: Optional[torch.Tensor] = None,   # [E]
    bias_gate: Optional[torch.Tensor] = None,  # [E/ep, F/tp]
    bias_up: Optional[torch.Tensor] = None,    # [E/ep, F/tp]
    bias_down: Optional[torch.Tensor] = None,  # [E/ep, H]
) -> torch.Tensor:
    E = router.shape[-1]
    dp = int(mesh.shape.get("data", 1))
    split = dp > 1 and x.shape[0] % dp == 0
    if split:   # this data rank's rows; otherwise every rank runs them all
        x = x[sharding.spec_slices(sharding.data_sharding(mesh), x.shape, mesh)]
    B, T, H = x.shape
    ep = int(mesh.shape.get("expert", 1))
    tp = int(mesh.shape.get("model", 1))
    if E % max(ep, 1):
        raise ValueError(f"expert axis {ep} must divide num_experts {E}")
    El = we_gate.shape[0]
    if El * ep != E:
        raise ValueError(f"expert block {El} x {ep} ranks != num_experts {E}")
    N = B * T
    K = top_k
    xt = x.reshape(N, H)
    _, _, flat_expert, flat_token, flat_prob = moe._route(xt, router, router_b, K)
    loc = flat_expert - mesh.coords()["expert"] * El            # local id
    owned = (loc >= 0) & (loc < El)
    # owned rows first, grouped by local expert; unowned pushed to a
    # trailing pseudo-group El (the stable sort keeps token order)
    key = torch.where(owned, loc, torch.full_like(loc, El))
    order = torch.argsort(key, stable=True)
    s_key = key[order]
    s_token = flat_token[order]
    s_weight = torch.where(owned, flat_prob, torch.zeros_like(flat_prob))[order]
    counts = torch.zeros((El + 1,), dtype=torch.int32, device=x.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    # the unowned tail rides the last real group with zeroed inputs
    group_sizes = counts[:El].clone()
    group_sizes[El - 1] += counts[El]
    s_eidx = s_key.clamp(max=El - 1)                          # bias index

    lhs = (xt[s_token] * (s_weight > 0)[:, None].to(xt.dtype)).contiguous()
    g = grouped_matmul(lhs, we_gate, group_sizes)             # [M, F/tp]
    u = grouped_matmul(lhs, we_up, group_sizes)
    if bias_gate is not None:
        g = g + bias_gate[s_eidx].to(g.dtype)
        u = u + bias_up[s_eidx].to(u.dtype)
    a, u = moe._act(g, u, activation)
    y = grouped_matmul((a * u).contiguous(), we_down, group_sizes)   # [M, H]
    if bias_down is not None:
        # bias_down lands on the unsplit H output: every model rank would
        # add it, so each adds 1/tp of it and the reduction restores it
        y = y + (bias_down[s_eidx] / tp).to(y.dtype)
    y = y * s_weight[:, None].to(y.dtype)
    # unsort to (token, k) order, then sum each token's k rows in float32
    # in a fixed order (a reproducible run, as ops/moe.py)
    y_flat = torch.empty_like(y)
    y_flat[order] = y
    out = y_flat.float().reshape(N, K, H).sum(1).to(y.dtype)
    group = mesh.group("expert", "model")
    if group is not None:
        group.all_reduce(out)
    out = out.reshape(B, T, H)
    return mesh.group("data").all_gather(out, 0) if split else out
