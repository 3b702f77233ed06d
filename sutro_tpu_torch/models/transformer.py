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
    QUANT_LEAVES, materialize, quantize_weight, quantized_empty,
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
    mesh=None,
    spec_fn=None,
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
    init.

    With a ``mesh`` (parallel/mesh.py) each leaf comes back as this
    rank's block under ``spec_fn(path, shape)`` (default
    ``parallel.sharding.leaf_spec``): the rank draws the single engine's
    whole stream in the single engine's order and keeps its block of
    each slice (quantized before it is cut, so a row-parallel leaf's
    per-channel scale is the full reduction's), so the blocks are bit
    for bit slices of the single-device init."""
    from ..parallel import sharding

    spec_fn = spec_fn or sharding.leaf_spec

    def draw(shape, fan_in):
        return (
            torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            * (fan_in ** -0.5)
        ).to(dtype)

    def cut(path, shape):
        """(rows kept of the leading axis, the block of the rest)."""
        if mesh is None:
            return range(shape[0]), (slice(None),) * (len(shape) - 1)
        sl = sharding.spec_slices(spec_fn(path, shape), shape, mesh)
        return range(*sl[0].indices(shape[0])), sl[1:]

    def local(path, shape):
        if mesh is None:
            return tuple(shape)
        return sharding.local_shape(shape, spec_fn(path, shape), mesh)

    def make(path, shape, init):
        name = path[-1]
        kind, arg = init
        if kind == "const":
            return torch.full(local(path, shape), arg, dtype=dtype, device=device)
        rows, rest = cut(path, shape)
        if quantize and name in QUANT_LEAVES:
            scale_full = (*shape[:-2], 1, shape[-1])
            if len(shape) > 2:
                qrows, qrest = cut((*path, "qw"), shape)
                srows, srest = cut((*path, "scale"), scale_full)
                out = quantized_empty(local((*path, "qw"), shape), device)
                for i in range(shape[0]):
                    full = quantize_weight(draw(shape[1:], arg))   # the full slice
                    if i in qrows:
                        out["qw"][i - qrows.start] = full["qw"][qrest]
                    if i in srows:
                        out["scale"][i - srows.start] = full["scale"][srest]
                return out
            # a 2-D leaf (lm_head): quantized whole, then cut
            w = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                w[i] = draw(shape[1:], arg)
            q = quantize_weight(w)
            del w
            if mesh is None:
                return q
            return {
                k: q[k][sharding.spec_slices(spec_fn((*path, k), tuple(q[k].shape)),
                                             tuple(q[k].shape), mesh)].contiguous()
                for k in ("qw", "scale")
            }
        out = torch.empty(local(path, shape), dtype=dtype, device=device)
        for i in range(shape[0]):
            x = draw(shape[1:], arg)
            if i in rows:
                out[i - rows.start] = x[rest]
        return out

    return {
        k: (
            {n: make((k, n), *s) for n, s in v.items()} if k == "layers"
            else make((k,), *v)
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


def _ep_mesh(cfg: ModelConfig, mesh):
    """The mesh when MoE layers run expert/tensor-parallel
    (ops/moe_ep.py), else None."""
    if mesh is None or not cfg.moe_experts:
        return None
    return mesh if mesh.shape["expert"] * mesh.shape["model"] > 1 else None


def _tp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The all-reduce over ``model`` that ends a row-parallel product
    (XLA inserts it in the reference from the sharding rules)."""
    group = None if mesh is None else mesh.group("model")
    return x if group is None else group.all_reduce(x)


def _mlp(
    cfg: ModelConfig, lp: Dict[str, Any], x: torch.Tensor, mesh=None, ep_mesh=None,
) -> torch.Tensor:
    if cfg.moe_experts:
        args = (x, lp["router"], _w(lp, "we_gate", x.dtype), _w(lp, "we_up", x.dtype),
                _w(lp, "we_down", x.dtype))
        kw = dict(
            top_k=cfg.moe_top_k, activation=cfg.activation,
            router_b=lp.get("router_b"), bias_gate=lp.get("we_gate_b"),
            bias_up=lp.get("we_up_b"), bias_down=lp.get("we_down_b"),
        )
        if ep_mesh is not None:
            # experts stay resident at 1/(ep*tp) a rank, one all-reduce
            from ..ops.moe_ep import moe_mlp_ep

            return moe_mlp_ep(*args, mesh=ep_mesh, **kw)
        return moe_mlp(*args, **kw)
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
    return _tp_reduce((act * up) @ _w(lp, "w_down", x.dtype), mesh)


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
    mesh=None,       # parallel/mesh.py: TP all-reduces over ``model``
    ring_mesh=None,  # mesh with ``seq`` > 1: ring attention (no past)
    ep_mesh=None,    # mesh for the expert-parallel MoE (ops/moe_ep.py)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder block. Shared by :func:`forward` and the pipeline
    stages (parallel/pipeline.py). Returns ``(h, (k_chunk, v_chunk))``.

    Under a mesh each rank holds its heads' and its FFN columns' blocks
    (parallel/sharding.py), so head counts come from the tensors; the
    attention output projection and the MLP end in an all-reduce over
    ``model``, and ``bo`` and the post norms act after it."""
    B, T = h.shape[:2]
    resid = h
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    q = x @ _w(lp, "wq", x.dtype)
    k = x @ _w(lp, "wk", x.dtype)
    v = x @ _w(lp, "wv", x.dtype)
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, T, -1, cfg.head_dim)
    k = k.reshape(B, T, -1, cfg.head_dim)
    v = v.reshape(B, T, -1, cfg.head_dim)
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
        pfx_groups=pfx_groups, ring_mesh=ring_mesh,
    )
    attn = _tp_reduce(attn.reshape(B, T, -1) @ _w(lp, "wo", h.dtype), mesh)
    if cfg.attn_bias:
        attn = attn + lp["bo"]
    if cfg.post_norms:
        attn = rms_norm(
            attn, lp["post_attn_norm"], cfg.norm_eps, cfg.norm_zero_centered
        )
    h = resid + attn
    resid = h
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps, cfg.norm_zero_centered)
    x = _mlp(cfg, lp, x, mesh=mesh, ep_mesh=ep_mesh)
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
    cfg: ModelConfig, params: Params, h: torch.Tensor, valid_len: torch.Tensor,
    mesh=None,
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
        # tied: the replicated embedding gives every rank whole logits
        return (h @ params["embed"].T.to(h.dtype)).float(), h
    logits = (h @ materialize(lm_head, h.dtype).to(h.dtype)).float()
    group = None if mesh is None else mesh.group("model")
    if group is not None:
        # the vocabulary-parallel head: every rank gets the same bits,
        # so each rank's row-seeded sampler draws the same tokens
        logits = group.all_gather(logits, -1)
    return logits, h


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def layer_params(params: Params, i: int) -> Dict[str, Any]:
    """Layer ``i`` (of the rank's stacked layers) without the L axis."""
    return {
        name: ({n: x[i] for n, x in t.items()} if isinstance(t, dict) else t[i])
        for name, t in params["layers"].items()
    }


def run_layers(
    cfg: ModelConfig,
    params: Params,
    h: torch.Tensor,
    layers: range,                      # global layer indices to run
    positions: torch.Tensor,
    valid_len: torch.Tensor,
    paged_past: Optional[Tuple[torch.Tensor, ...]] = None,
    past_len: Optional[torch.Tensor] = None,
    window_past: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
    pfx_groups: Optional[tuple] = None,
    *,
    mesh=None,
    ring_mesh=None,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The layer step over ``layers`` (the reference's scanned
    ``layer_step``; a pipeline stage runs its own range). ``params``,
    the page pools and the window buffers hold exactly these layers,
    indexed from 0. Returns ``(h, ks, vs)``, one K/V per layer."""
    windows = cfg.window_array()
    thetas = rope_thetas(cfg)
    k_pages = v_pages = k_scale = v_scale = page_table = None
    if paged_past is not None and len(paged_past) == 5:
        k_pages, v_pages, k_scale, v_scale, page_table = paged_past
    elif paged_past is not None:
        k_pages, v_pages, page_table = paged_past
    ep_mesh = _ep_mesh(cfg, mesh)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    tables: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}
    for i, layer in enumerate(layers):
        theta = thetas[layer]
        if theta not in tables:
            tables[theta] = rope_tables(positions, theta, cfg, cfg.head_dim // 2)
        kw: Dict[str, Any] = {}
        if paged_past is not None:
            kw = dict(
                kp_l=k_pages[i], vp_l=v_pages[i],
                page_table=page_table, past_len=past_len,
                pfx_groups=pfx_groups,
            )
            if k_scale is not None:
                kw.update(ks_l=k_scale[i], vs_l=v_scale[i])
            if window_past is not None:
                kw.update(
                    wk_l=window_past[0][i], wv_l=window_past[1][i],
                    win_len=int(window_past[2]),
                )
        h, (k, v) = layer_apply(
            cfg, layer_params(params, i), h,
            positions=positions, valid_len=valid_len,
            window=windows[layer], theta=theta, rope=tables[theta],
            mesh=mesh, ring_mesh=ring_mesh, ep_mesh=ep_mesh, **kw,
        )
        ks.append(k)
        vs.append(v)
    return h, ks, vs


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
    *,
    mesh=None,       # parallel/mesh.py (TP and EP collectives)
    ring_mesh=None,  # mesh with ``seq`` > 1: ring prefill (no past)
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the trunk over a chunk.

    Returns ``(logits_or_emb, final_hidden, (k_chunk, v_chunk))`` with
    the chunk K/V stacked ``[L, B, T, KVH, Dh]`` (post-RoPE, ready for
    the cache write).

    ``head_index`` (lm head only) keeps one position per row before the
    head, so logits come back ``[B, 1, V]``. The head is position-wise,
    so these are the same logits as the full ``[B, T, V]`` at those
    positions; a long prefill chunk never materializes the full float32
    logits (32768 tokens x 151,936 vocab would be ~20 GB).

    With ``ring_mesh`` and no past each ``seq`` rank runs the layers on
    its contiguous chunk of the sequence (ops/ring_attention.py); the
    chunks' hidden states and K/V are gathered after the last layer."""
    h = embed_tokens(cfg, params, ids)
    if paged_past is not None:
        ring_mesh = None
    seq = None if ring_mesh is None else ring_mesh.group("seq")
    pos = positions
    if seq is not None:
        from ..ops.ring_attention import seq_chunk

        sl = seq_chunk(ring_mesh, ids.shape[1])
        h, pos = h[:, sl], positions[:, sl]
    h, ks, vs = run_layers(
        cfg, params, h, range(cfg.num_layers), pos, valid_len, paged_past,
        past_len, window_past, pfx_groups, mesh=mesh,
        ring_mesh=None if seq is None else ring_mesh,
    )
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if seq is not None:
        h = seq.all_gather(h, 1)
        k_all, v_all = seq.all_gather(k_all, 2), seq.all_gather(v_all, 2)
    if head_index is not None and cfg.head == "lm":
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, head_index.long()][:, None]
    out, h = head_apply(cfg, params, h, valid_len, mesh)
    return out, h, (k_all, v_all)
