"""A plain Qwen3 forward (dense, and Qwen3-MoE) in float32.

Written from the published architecture (Hugging Face ``Qwen3`` and
``Qwen3Moe``): RMSNorm before attention and before the MLP, per-head
RMSNorm on queries and keys before rotate-half RoPE, grouped-query
causal attention scaled by ``head_dim ** -0.5``, a SwiGLU MLP or, in
MoE layers, a softmax router whose top ``num_experts_per_tok`` weights
are renormalised (``norm_topk_prob``), and a final RMSNorm before the
output head. No cache, no kernels, no batching across sequences: each
sequence is one causal forward over all its positions.

It runs layer by layer over all the sequences it is given, drawing each
layer's weights from the seed (:mod:`portbench.weights`) and dropping
them after, so it fits beside nothing else on one card. The precision
of the linear layers is a :class:`Precision`:

- ``served``: the weights as the configuration serves them: its bf16
  draws, or their int8 round trip where the configuration quantizes
  weights to int8 (:mod:`portbench.reference.quant`); activations stay
  float32;
- ``int4`` and ``fp8``: the controls, one step below what the
  configuration states (int4 weights for int8; fp8 e4m3 weights and
  activations for bf16).

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

from . import quant

PRECISIONS = ("served", "int4", "fp8")


def full_fp32() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """How a linear layer's weight and input are held."""

    def __init__(self, mode: str, weight_quant: str):
        if mode not in PRECISIONS:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.weight_quant = weight_quant   # "int8" or "" (bf16), the configuration's

    def weight(self, w: torch.Tensor, head: bool = False) -> torch.Tensor:
        """``w [..., out, in]`` as float32 values."""
        if self.mode == "fp8":
            return w.float() if head else quant.fp8_round_trip(w)
        if self.mode == "int4":
            return quant.int_round_trip(w, bits=4)
        if self.weight_quant == "int8":
            return quant.int_round_trip(w, bits=8)
        return w.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return quant.fp8_round_trip(x) if self.mode == "fp8" else x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over ``x [T, heads, Dh]`` at positions 0..T-1."""
    T, Dh = x.shape[0], x.shape[-1]
    half = Dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) * 2 / Dh)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal GQA attention: ``q [T, NH, Dh]``, ``k, v [T, KVH, Dh]``."""
    T, NH, Dh = q.shape
    rep = NH // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # [NH, T, Dh]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) * Dh ** -0.5
    out = torch.empty_like(q)
    for a in range(0, T, block):
        b = min(T, a + block)
        s = q[:, a:b] @ k[:, :b].transpose(1, 2)           # [NH, b-a, b]
        mask = torch.arange(b, device=q.device)[None] > torch.arange(a, b, device=q.device)[:, None]
        s.masked_fill_(mask[None], -math.inf)
        out[:, a:b] = torch.softmax(s, -1) @ v[:, :b]
    return out.transpose(0, 1)                              # [T, NH, Dh]


def _linear(x, w, prec: Precision):
    return prec.act(x) @ w.T


def mlp(m: Dict, lw: Dict, x: torch.Tensor, prec: Precision, block: int = 4096) -> torch.Tensor:
    """The MLP (or MoE) of one layer over the rows of ``x [N, H]``."""
    act = torch.nn.functional.silu
    if not m.get("num_experts"):
        g, u, d = (prec.weight(lw[f"mlp.{p}_proj.weight"]) for p in ("gate", "up", "down"))
        out = torch.empty_like(x)
        for a in range(0, x.shape[0], block):
            xb = x[a : a + block]
            out[a : a + block] = _linear(act(_linear(xb, g, prec)) * _linear(xb, u, prec), d, prec)
        return out
    K = m["num_experts_per_tok"]
    probs = torch.softmax(x @ lw["mlp.gate.weight"].float().T, -1)   # router in float32
    top_p, top_e = probs.topk(K, dim=-1)
    if m.get("norm_topk_prob", True):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    g_all, u_all, d_all = (lw[f"mlp.experts.{p}_proj.weight"] for p in ("gate", "up", "down"))
    for e in range(m["num_experts"]):
        rows, slot = (top_e == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        g, u, d = (prec.weight(w[e]) for w in (g_all, u_all, d_all))
        xe = x[rows]
        y = _linear(act(_linear(xe, g, prec)) * _linear(xe, u, prec), d, prec)
        out.index_add_(0, rows, y * top_p[rows, slot][:, None])
    return out


def layer(m: Dict, lw: Dict, hs: List[torch.Tensor], prec: Precision) -> List[torch.Tensor]:
    eps, theta = m.get("rms_norm_eps", 1e-6), float(m.get("rope_theta", 1e6))
    H, NH, KVH = m["hidden_size"], m["num_attention_heads"], m["num_key_value_heads"]
    Dh = m.get("head_dim") or H // NH
    wq, wk, wv, wo = (prec.weight(lw[f"self_attn.{p}_proj.weight"]) for p in "qkvo")
    mid = []
    for h in hs:
        x = rms_norm(h, lw["input_layernorm.weight"], eps)
        T = x.shape[0]
        q = rms_norm(_linear(x, wq, prec).view(T, NH, Dh), lw["self_attn.q_norm.weight"], eps)
        k = rms_norm(_linear(x, wk, prec).view(T, KVH, Dh), lw["self_attn.k_norm.weight"], eps)
        v = _linear(x, wv, prec).view(T, KVH, Dh)
        a = attention(rope(q, theta), rope(k, theta), v).reshape(T, NH * Dh)
        mid.append(h + _linear(a, wo, prec))
    del wq, wk, wv, wo
    flat = torch.cat(mid)
    flat = flat + mlp(m, lw, rms_norm(flat, lw["post_attention_layernorm.weight"], eps), prec)
    return list(flat.split([t.shape[0] for t in mid]))


def forward(
    m: Dict,
    weights,
    seqs: Sequence[torch.Tensor],
    read_from: Sequence[int],
    prec: Precision,
    on_logits: Callable[[int, int, torch.Tensor], None],
    block: int = 256,
) -> None:
    """Run every sequence of ids (``seqs``, 1-D on the weights' device)
    through the model and hand the float32 logits of positions
    ``read_from[s]`` .. end to ``on_logits(s, first_position, logits
    [n, V])``, a block of positions at a time."""
    emb = weights.get("model.embed_tokens.weight")
    hs = [emb[s.long()].float() for s in seqs]
    del emb
    for i in range(m["num_hidden_layers"]):
        lw = weights.layer(i)
        hs = layer(m, lw, hs, prec)
        del lw
    # a tied head is the embedding, which no configuration quantizes
    if m.get("tie_word_embeddings", False):
        head = weights.get("model.embed_tokens.weight").float()
    else:
        head = prec.weight(weights.get("lm_head.weight"), head=True)
    fnorm = weights.get("model.norm.weight")
    eps = m.get("rms_norm_eps", 1e-6)
    for s, h in enumerate(hs):
        for a in range(read_from[s], h.shape[0], block):
            x = rms_norm(h[a : a + block], fnorm, eps)
            on_logits(s, a, x @ head.T)
