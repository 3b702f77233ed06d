"""Mixture-of-experts MLP.

Port of ``sutro_tpu/ops/moe.py`` (Qwen3-MoE and gpt-oss). Routing takes
float32 router logits, the top-k experts of each token and a softmax
over those k logits. Two paths compute the same function:

- ``dense``: every expert for every token, combined with the gate
  matrix; for small expert counts (the tiny test models);
- ``ragged``: the ``N * top_k`` (token, expert) pairs are stably sorted
  by expert and run through three grouped GEMMs (ops/grouped_matmul.py,
  the CUDA kernel on the card), then unsorted and summed per token in a
  fixed order, so a run is reproducible on the card.

``method="auto"`` takes ``dense`` when ``E <= 8``, as the reference
does. Nothing here waits for the card: the group sizes are counted on
the device with ``index_add_`` (``torch.bincount`` would sync to size
its output) and handed to the kernel as a device tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .grouped_matmul import grouped_matmul

METHODS = ("auto", "dense", "ragged")


def _route(
    xt: torch.Tensor,                  # [N, H]
    router: torch.Tensor,              # [H, E]
    router_b: Optional[torch.Tensor],  # [E]
    top_k: int,
) -> Tuple[torch.Tensor, ...]:
    """float32 logits -> top-k -> softmax over the k, plus the flat
    ``[N * top_k]`` (expert, token, prob) expansion."""
    N = xt.shape[0]
    logits = xt.float() @ router.float()                      # [N, E]
    if router_b is not None:
        logits = logits + router_b.float()
    top_logits, top_idx = torch.topk(logits, top_k, dim=-1)   # [N, K]
    probs = torch.softmax(top_logits, dim=-1)
    M = N * top_k
    flat_expert = top_idx.reshape(M)
    flat_token = torch.arange(M, device=xt.device) // top_k
    flat_prob = probs.reshape(M)
    return top_idx, probs, flat_expert, flat_token, flat_prob


def _act(gate: torch.Tensor, up: torch.Tensor, activation: str):
    if activation == "gelu":
        a = F.gelu(gate.float(), approximate="tanh")
        return a.to(gate.dtype), up
    if activation == "swiglu_oss":
        g = gate.float().clamp(max=7.0)
        a = (g * torch.sigmoid(1.702 * g)).to(gate.dtype)
        u = up.float().clamp(-7.0, 7.0).to(up.dtype) + 1.0
        return a, u
    return F.silu(gate.float()).to(gate.dtype), up


def moe_mlp(
    x: torch.Tensor,         # [B, T, H]
    router: torch.Tensor,    # [H, E]
    we_gate: torch.Tensor,   # [E, H, F]
    we_up: torch.Tensor,     # [E, H, F]
    we_down: torch.Tensor,   # [E, F, H]
    *,
    top_k: int,
    activation: str = "silu",
    method: str = "auto",
    router_b: Optional[torch.Tensor] = None,   # [E]
    bias_gate: Optional[torch.Tensor] = None,  # [E, F] (gpt-oss)
    bias_up: Optional[torch.Tensor] = None,    # [E, F]
    bias_down: Optional[torch.Tensor] = None,  # [E, H]
) -> torch.Tensor:
    if method not in METHODS:
        raise ValueError(f"moe_mlp: method {method!r} not in {METHODS}")
    B, T, H = x.shape
    E = router.shape[-1]
    N = B * T
    xt = x.reshape(N, H)
    top_idx, probs, flat_expert, flat_token, flat_prob = _route(
        xt, router, router_b, top_k
    )
    if method == "auto":
        method = "dense" if E <= 8 else "ragged"

    if method == "dense":
        gates = torch.zeros((N, E), dtype=torch.float32, device=x.device)
        gates.scatter_add_(1, top_idx, probs)
        g = torch.einsum("nh,ehf->nef", xt, we_gate)
        u = torch.einsum("nh,ehf->nef", xt, we_up)
        if bias_gate is not None:
            g = g + bias_gate[None].to(g.dtype)
            u = u + bias_up[None].to(u.dtype)
        a, u = _act(g, u, activation)
        y = torch.einsum("nef,efh->neh", a * u, we_down)
        if bias_down is not None:
            y = y + bias_down[None].to(y.dtype)
        out = torch.einsum("ne,neh->nh", gates.to(y.dtype), y)
        return out.reshape(B, T, H)

    # ragged: rows sorted by expert through three grouped GEMMs
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_prob = flat_prob[order]
    group_sizes = torch.zeros((E,), dtype=torch.int32, device=x.device)
    group_sizes.index_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32)
    )
    lhs = xt[sorted_token]                                  # [M, H]
    g = grouped_matmul(lhs, we_gate, group_sizes)           # [M, F]
    u = grouped_matmul(lhs, we_up, group_sizes)
    if bias_gate is not None:
        g = g + bias_gate[sorted_expert].to(g.dtype)
        u = u + bias_up[sorted_expert].to(u.dtype)
    a, u = _act(g, u, activation)
    y = grouped_matmul(a * u, we_down, group_sizes)         # [M, H]
    if bias_down is not None:
        y = y + bias_down[sorted_expert].to(y.dtype)
    y = y * sorted_prob[:, None].to(y.dtype)
    # unsort back to (token, k) order and sum the top_k contributions of
    # a token in float32, in a fixed order: a scatter-add's atomics
    # would make a run's rounding, and so its routing downstream, vary
    # from run to run
    y_flat = torch.empty_like(y)
    y_flat[order] = y
    out = y_flat.float().reshape(N, top_k, H).sum(1)
    return out.to(y.dtype).reshape(B, T, H)
