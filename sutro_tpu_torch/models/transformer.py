"""Config-driven decoder-only transformer in PyTorch.

Port of ``sutro_tpu/models/transformer.py``; one code path covers the
Qwen3 (dense and MoE) / Llama 3 / Gemma 3 / gpt-oss families through
``ModelConfig`` flags (QK-norm, sliding windows, attention sinks, post
norms, projection biases, YaRN RoPE, MoE layers through ops/moe.py).

- Parameters are plain dicts of tensors with every per-layer tensor
  stacked on a leading layer axis, the reference's ``[L, ...]`` layout,
  so a JAX parameter tree maps onto them one to one
  (engine/weights.py). Projections keep the ``x @ w`` orientation.
- The reference's ``lax.scan`` over layers is a Python loop; each
  layer's window and RoPE base are Python numbers, so the attention
  dispatch (ops/attention.py) needs no device round trip.
- Norms, RoPE and softmax run in float32; matmuls in the parameter
  dtype (bfloat16 on the card); logits are float32.

The forward returns the chunk's per-layer K/V; the caller
(engine/runner.py) writes them into the paged cache.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import chunk_attention
from ..ops.moe import moe_mlp
from ..ops.quant import (
    QUANT_LEAVES, materialize, quantize_into, quantize_weight, quantized_empty,
)
from .configs import ModelConfig

Params = Dict[str, Any]


def _w(lp: Dict[str, Any], name: str, dtype: torch.dtype) -> torch.Tensor:
    """Possibly-int8 weight leaf -> matmul-ready tensor (ops/quant.py)."""
    return materialize(lp[name], dtype)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's layout: ``name -> (shape, init)`` with
    ``init`` either ``("normal", fan_in)`` or ``("const", value)``, and
    the per-layer entries under ``"layers"``. The same tree as the
    reference's ``init_params``."""
    H, L = cfg.hidden_size, cfg.num_layers
    NHD, KVD = cfg.q_size, cfg.kv_size
    F_, Dh = cfg.intermediate_size, cfg.head_dim
    one = ("const", 0.0 if cfg.norm_zero_centered else 1.0)
    zero = ("const", 0.0)
    layers: Dict[str, Any] = {
        "attn_norm": ((L, H), one),
        "wq": ((L, H, NHD), ("normal", H)),
        "wk": ((L, H, KVD), ("normal", H)),
        "wv": ((L, H, KVD), ("normal", H)),
        "wo": ((L, NHD, H), ("normal", NHD)),
        "mlp_norm": ((L, H), one),
    }
    if cfg.attn_bias:
        layers["bq"] = ((L, NHD), zero)
        layers["bk"] = ((L, KVD), zero)
        layers["bv"] = ((L, KVD), zero)
        layers["bo"] = ((L, H), zero)
    if cfg.qk_norm:
        layers["q_norm"] = ((L, Dh), one)
        layers["k_norm"] = ((L, Dh), one)
    if cfg.attention_sink:
        layers["sink"] = ((L, cfg.num_heads), zero)
    if cfg.post_norms:
        layers["post_attn_norm"] = ((L, H), one)
        layers["post_mlp_norm"] = ((L, H), one)
    if cfg.moe_experts:
        E, Fm = cfg.moe_experts, cfg.moe_intermediate_size
        layers["router"] = ((L, H, E), ("normal", H))
        layers["we_gate"] = ((L, E, H, Fm), ("normal", H))
        layers["we_up"] = ((L, E, H, Fm), ("normal", H))
        layers["we_down"] = ((L, E, Fm, H), ("normal", Fm))
        if cfg.moe_bias:
            layers["router_b"] = ((L, E), zero)
            layers["we_gate_b"] = ((L, E, Fm), zero)
            layers["we_up_b"] = ((L, E, Fm), zero)
            layers["we_down_b"] = ((L, E, H), zero)
    else:
        layers["w_gate"] = ((L, H, F_), ("normal", H))
        layers["w_up"] = ((L, H, F_), ("normal", H))
        layers["w_down"] = ((L, F_, H), ("normal", F_))
    spec: Dict[str, Any] = {
        "embed": ((cfg.vocab_size, H), ("normal", H)),
        "final_norm": ((H,), one),
        "layers": layers,
    }
    if not cfg.tie_embeddings and cfg.head == "lm":
        spec["lm_head"] = ((H, cfg.vocab_size), ("normal", H))
    return spec


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    quantize: bool = False,
) -> Params:
    """Random init in the :func:`param_spec` layout. Normal draws
    (scaled by ``fan_in ** -0.5``) come from ``generator``, which must
    live on ``device``, one leading-axis slice at a time (one layer's
    ``[E, H, F]`` experts), so a full-size model never holds a float32
    copy of a whole tensor.

    With ``quantize`` the ``QUANT_LEAVES`` come back int8
    (ops/quant.py), each layer's slice quantized as soon as it is drawn
    in ``dtype``, so the full-precision model is never resident; the
    draws and the result equal ``quantize_params`` of the unquantized
    init."""

    def draw(shape, fan_in):
        return (
            torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            * (fan_in ** -0.5)
        ).to(dtype)

    def make(name, shape, init):
        kind, arg = init
        if kind == "const":
            return torch.full(shape, arg, dtype=dtype, device=device)
        if quantize and name in QUANT_LEAVES and len(shape) > 2:
            out = quantized_empty(shape, device)
            for i in range(shape[0]):
                quantize_into(draw(shape[1:], arg),
                              {"qw": out["qw"][i], "scale": out["scale"][i]})
            return out
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = draw(shape[1:], arg)
        if quantize and name in QUANT_LEAVES:   # a 2-D leaf (lm_head)
            return quantize_weight(out)
        return out

    return {
        k: (
            {n: make(n, *s) for n, s in v.items()} if k == "layers" else make(k, *v)
        )
        for k, v in param_spec(cfg).items()
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, w: torch.Tensor, eps: float, zero_centered: bool
) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if zero_centered else w.float()
    return (x32 * scale).to(dt)


def _yarn_inv_freq(cfg: ModelConfig, half: int) -> Tuple[np.ndarray, float]:
    """Static YaRN-scaled inverse frequencies + attention scaling
    (gpt-oss ships factor-32 YaRN over a 4096-token original window).
    NTK-by-parts: low dims extrapolate, high dims interpolate by
    ``factor``, with a linear ramp between the beta_fast/beta_slow
    wavelength cutoffs; cos/sin are scaled by ``0.1 ln(factor) + 1``."""
    base = cfg.rope_theta
    factor = cfg.rope_scaling_factor
    orig = max(cfg.rope_original_max, 1)
    dim = 2 * half
    pos_freqs = base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (factor * pos_freqs)

    def find_dim(n_rot: float) -> float:
        return (
            dim * np.log(orig / (n_rot * 2 * np.pi))
        ) / (2 * np.log(base))

    low = np.floor(find_dim(cfg.rope_beta_fast))
    high = np.ceil(find_dim(cfg.rope_beta_slow))
    rng = np.arange(half, dtype=np.float64)
    ramp = np.clip((rng - low) / max(high - low, 1e-3), 0.0, 1.0)
    extrap_factor = 1.0 - ramp
    inv_freq = interp * (1 - extrap_factor) + extrap * extrap_factor
    attn_scale = 0.1 * float(np.log(factor)) + 1.0
    return inv_freq.astype(np.float32), attn_scale


def rope_tables(
    positions: torch.Tensor,
    theta: float,
    cfg: Optional[ModelConfig],
    half: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` tables ``[B, T, 1, half]`` (float32, YaRN-scaled)
    of rotate-half RoPE at ``positions``. The base is filled on the
    device, so building them never waits for the card; the forward
    builds them once per distinct base and shares them across layers."""
    dev = positions.device
    scale = 1.0
    if cfg is not None and cfg.rope_scaling_factor:
        if cfg.local_rope_theta:
            raise NotImplementedError(
                "YaRN rope_scaling with local_rope_theta is unsupported"
            )
        freq_np, scale = _yarn_inv_freq(cfg, half)
        freq = torch.from_numpy(freq_np).to(dev)
    else:
        exps = -torch.arange(0, half, dtype=torch.float32, device=dev) / half
        freq = torch.full((), theta, dtype=torch.float32, device=dev) ** exps
    ang = positions.float()[..., None] * freq              # [B, T, half]
    return (
        torch.cos(ang)[:, :, None, :] * scale,
        torch.sin(ang)[:, :, None, :] * scale,
    )


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    cfg: Optional[ModelConfig] = None,
) -> torch.Tensor:
    """rotate-half RoPE. x: [B, T, N, Dh]; positions: [B, T]."""
    return _rotate(x, *rope_tables(positions, theta, cfg, x.shape[-1] // 2))


def _mlp(cfg: ModelConfig, lp: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if cfg.moe_experts:
        return moe_mlp(
            x, lp["router"], _w(lp, "we_gate", x.dtype), _w(lp, "we_up", x.dtype),
            _w(lp, "we_down", x.dtype),
            top_k=cfg.moe_top_k, activation=cfg.activation,
            router_b=lp.get("router_b"), bias_gate=lp.get("we_gate_b"),
            bias_up=lp.get("we_up_b"), bias_down=lp.get("we_down_b"),
        )
    gate = x @ _w(lp, "w_gate", x.dtype)
    up = x @ _w(lp, "w_up", x.dtype)
    if cfg.activation == "gelu":
        act = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    elif cfg.activation == "swiglu_oss":
        g = gate.float().clamp(max=7.0)
        act = (g * torch.sigmoid(1.702 * g)).to(x.dtype)
        up = up.float().clamp(-7.0, 7.0).to(x.dtype) + 1.0
    else:
        act = F.silu(gate.float()).to(x.dtype)
    return (act * up) @ _w(lp, "w_down", x.dtype)


def layer_apply(
    cfg: ModelConfig,
    lp: Dict[str, Any],            # one layer's params (no L axis)
    h: torch.Tensor,               # [B, T, H]
    *,
    positions: torch.Tensor,       # [B, T]
    valid_len: torch.Tensor,       # [B]
    window: int,
    theta: float,
    kp_l: Optional[torch.Tensor] = None,   # this layer's K page pool
    vp_l: Optional[torch.Tensor] = None,
    ks_l: Optional[torch.Tensor] = None,   # this layer's int8-KV scales
    vs_l: Optional[torch.Tensor] = None,   # [NP, PS] f32
    page_table: Optional[torch.Tensor] = None,
    past_len: Optional[torch.Tensor] = None,
    wk_l: Optional[torch.Tensor] = None,   # this layer's window buffer
    wv_l: Optional[torch.Tensor] = None,   # [B, W, KVH*Dh]
    win_len: int = 0,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # rope_tables
    pfx_groups: Optional[tuple] = None,  # shared-prefix decode groups
    #                                      (ops/attention.py)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder block. Returns ``(h, (k_chunk, v_chunk))``."""
    B, T = h.shape[:2]
    resid = h
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    q = x @ _w(lp, "wq", x.dtype)
    k = x @ _w(lp, "wk", x.dtype)
    v = x @ _w(lp, "wv", x.dtype)
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps, cfg.norm_zero_centered)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    if rope is None:
        rope = rope_tables(positions, theta, cfg, cfg.head_dim // 2)
    q = _rotate(q, *rope)
    k = _rotate(k, *rope)
    sink = lp.get("sink") if cfg.attention_sink else None
    attn = chunk_attention(
        q, k, v,
        positions=positions,
        valid_len=valid_len,
        past_k_pages=kp_l, past_v_pages=vp_l,
        past_k_scale=ks_l, past_v_scale=vs_l,
        page_table=page_table, past_len=past_len,
        window=window, sink=sink,
        win_k=wk_l, win_v=wv_l, win_len=win_len,
        pfx_groups=pfx_groups,
    )
    attn = attn.reshape(B, T, cfg.q_size) @ _w(lp, "wo", h.dtype)
    if cfg.attn_bias:
        attn = attn + lp["bo"]
    if cfg.post_norms:
        attn = rms_norm(
            attn, lp["post_attn_norm"], cfg.norm_eps, cfg.norm_zero_centered
        )
    h = resid + attn
    resid = h
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    x = _mlp(cfg, lp, x)
    if cfg.post_norms:
        x = rms_norm(x, lp["post_mlp_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    h = resid + x
    return h, (k, v)


def rope_thetas(cfg: ModelConfig) -> List[float]:
    """Per-layer RoPE base frequencies (local layers may differ)."""
    return [
        (
            cfg.local_rope_theta
            if (w > 0 and cfg.local_rope_theta)
            else cfg.rope_theta
        )
        for w in cfg.window_array()
    ]


def embed_tokens(cfg: ModelConfig, params: Params, ids: torch.Tensor) -> torch.Tensor:
    h = params["embed"][ids.long()]  # [B, T, H] gather
    if cfg.embed_scale:
        h = (h.float() * (cfg.hidden_size ** 0.5)).to(h.dtype)
    return h


def head_apply(
    cfg: ModelConfig, params: Params, h: torch.Tensor, valid_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """final norm + lm/embedding head. h: [B, T, H].

    Returns ``(out, h_normed)``: float32 logits ``[B, T, V]`` (or
    normalized pooled embeddings ``[B, H]``) plus the post-final-norm
    hidden states."""
    T = h.shape[1]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    if cfg.head == "embedding":
        if cfg.pooling == "last":
            last = (valid_len.long() - 1).clamp(min=0)
            pooled = h.float()[torch.arange(h.shape[0], device=h.device), last]
        else:
            mask = (
                torch.arange(T, device=h.device)[None] < valid_len[:, None]
            ).float()
            pooled = (h.float() * mask[..., None]).sum(1)
            pooled = pooled / mask.sum(1, keepdim=True).clamp(min=1.0)
        emb = pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp(
            min=1e-9
        )
        return emb, h
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["embed"].T
    return (h @ materialize(lm_head, h.dtype).to(h.dtype)).float(), h


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(
    cfg: ModelConfig,
    params: Params,
    ids: torch.Tensor,                 # [B, T] int
    positions: torch.Tensor,           # [B, T] global positions
    valid_len: torch.Tensor,           # [B] real tokens of the chunk
    paged_past: Optional[Tuple[torch.Tensor, ...]] = None,
    # paged_past: (k_pages, v_pages, page_table), pools [L, NP, PS,
    # KVH*Dh] (fused, engine/kvcache.py), table [B, MP] int32; or with
    # an int8 KV cache (k_pages, v_pages, k_scale, v_scale, page_table),
    # scales [L, NP, PS] f32
    past_len: Optional[torch.Tensor] = None,   # [B] valid past tokens
    # fused-decode window buffer: (win_k [L, B, W, KVH*Dh], win_v,
    # win_len int) — K/V of window tokens not yet in the page pool
    window_past: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
    head_index: Optional[torch.Tensor] = None,  # [B] positions to keep
    # shared-prefix split decode: ((pages [Pp] int32, pfx_len [B] int32),
    # ...) on the device, one per group (ops/attention.py)
    pfx_groups: Optional[tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the trunk over a chunk.

    Returns ``(logits_or_emb, final_hidden, (k_chunk, v_chunk))`` with
    the chunk K/V stacked ``[L, B, T, KVH, Dh]`` (post-RoPE, ready for
    the cache write).

    ``head_index`` (lm head only) keeps one position per row before the
    head, so logits come back ``[B, 1, V]``. The head is position-wise,
    so these are the same logits as the full ``[B, T, V]`` at those
    positions; a long prefill chunk never materializes the full float32
    logits (32768 tokens x 151,936 vocab would be ~20 GB)."""
    h = embed_tokens(cfg, params, ids)
    windows = cfg.window_array()
    thetas = rope_thetas(cfg)
    k_pages = v_pages = k_scale = v_scale = page_table = None
    if paged_past is not None and len(paged_past) == 5:
        k_pages, v_pages, k_scale, v_scale, page_table = paged_past
    elif paged_past is not None:
        k_pages, v_pages, page_table = paged_past
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    tables: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
    for layer in range(cfg.num_layers):
        theta = thetas[layer]
        if theta not in tables:
            tables[theta] = rope_tables(positions, theta, cfg, cfg.head_dim // 2)
        lp = {
            name: ({n: x[layer] for n, x in t.items()} if isinstance(t, dict)
                   else t[layer])
            for name, t in params["layers"].items()
        }
        kw: Dict[str, Any] = {}
        if paged_past is not None:
            kw = dict(
                kp_l=k_pages[layer], vp_l=v_pages[layer],
                page_table=page_table, past_len=past_len,
                pfx_groups=pfx_groups,
            )
            if k_scale is not None:
                kw.update(ks_l=k_scale[layer], vs_l=v_scale[layer])
            if window_past is not None:
                kw.update(
                    wk_l=window_past[0][layer], wv_l=window_past[1][layer],
                    win_len=int(window_past[2]),
                )
        h, (k, v) = layer_apply(
            cfg, lp, h,
            positions=positions, valid_len=valid_len,
            window=windows[layer], theta=theta, rope=tables[theta], **kw,
        )
        ks.append(k)
        vs.append(v)
    if head_index is not None and cfg.head == "lm":
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, head_index.long()][:, None]
    out, h = head_apply(cfg, params, h, valid_len)
    return out, h, (torch.stack(ks), torch.stack(vs))

