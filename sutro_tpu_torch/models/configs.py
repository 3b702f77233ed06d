"""Model architecture configs for the engine's model catalog.

The reference ships no model code — its catalog is a list of names sent to a
remote fleet (reference SDK sutro/common.py:20-45). Here each catalog name
maps to a full architecture spec for the in-tree TPU engine. One
config-driven decoder-only transformer (models/transformer.py) covers all
four families:

- Qwen3 dense (0.6b..32b): GQA + QK-RMSNorm, SwiGLU, RoPE
- Qwen3 MoE (30b-a3b, 235b-a22b): + top-k softmax router, no shared expert
- Llama 3.x: GQA, SwiGLU, RoPE (no QK-norm)
- Gemma 3: GQA + QK-norm, GeGLU-ish gated MLP, pre+post norms, 5:1
  local:global sliding-window attention, embedding scaling
- gpt-oss (20b/120b): MoE + attention sinks + alternating sliding window

Hyperparameters follow the public model cards; exactness matters only when
loading real checkpoints (engine/weights.py validates shapes against these).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    qk_norm: bool = False                 # Qwen3 / Gemma3
    tie_embeddings: bool = True
    # MoE (0 experts => dense MLP)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_intermediate_size: int = 0
    # gpt-oss: router + per-expert projection biases
    moe_bias: bool = False
    # Sliding window attention: 0 => full attention everywhere.
    sliding_window: int = 0
    # "none" | "alternate" (gpt-oss: even layers sliding) |
    # "gemma" (5 local : 1 global)
    sliding_pattern: str = "none"
    # gpt-oss learnable attention sinks
    attention_sink: bool = False
    # qkv/o projection biases (gpt-oss)
    attn_bias: bool = False
    # Gemma-style zero-centered RMSNorm weights (out = x * (1 + w))
    norm_zero_centered: bool = False
    # Gemma3 extras
    post_norms: bool = False              # post-attn/post-mlp RMSNorm
    embed_scale: bool = False             # embeddings * sqrt(hidden)
    local_rope_theta: Optional[float] = None  # gemma local layers use 10k
    # YaRN RoPE scaling (gpt-oss ships with factor 32 over a 4096-token
    # original window). 0 disables.
    rope_scaling_factor: float = 0.0
    rope_original_max: int = 0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    # activation: "silu" (SwiGLU) | "gelu" (GeGLU) | "swiglu_oss" (clamped)
    activation: str = "silu"
    # head: "lm" | "embedding" (pooled, normalized)
    head: str = "lm"
    # embedding pooling: "mean" | "last" (Qwen3-Embedding pools the
    # final valid token's hidden state, not the mean)
    pooling: str = "mean"
    # chat template key for engine/tokenizer.render_chat
    chat_template: str = "chatml"

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def window_for_layer(self, layer: int) -> int:
        """Per-layer attention window (0 = full); SURVEY §5.7 long-context."""
        if self.sliding_window <= 0 or self.sliding_pattern == "none":
            return 0
        if self.sliding_pattern == "alternate":
            return self.sliding_window if layer % 2 == 0 else 0
        if self.sliding_pattern == "gemma":
            return 0 if (layer + 1) % 6 == 0 else self.sliding_window
        return 0

    def window_array(self) -> Tuple[int, ...]:
        return tuple(self.window_for_layer(i) for i in range(self.num_layers))


def _qwen3(name: str, h: int, l: int, nh: int, nkv: int, inter: int,
           hd: int = 128, tie: bool = True, head: str = "lm",
           vocab: int = 151_936) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=vocab, hidden_size=h, num_layers=l,
        num_heads=nh, num_kv_heads=nkv, head_dim=hd,
        intermediate_size=inter, qk_norm=True, tie_embeddings=tie,
        rope_theta=1_000_000.0, head=head, chat_template="chatml",
        # Qwen3-Embedding pools the last valid token (model card), not
        # the mean
        pooling="last" if head == "embedding" else "mean",
    )


def _qwen3_moe(name: str, h: int, l: int, nh: int, nkv: int,
               experts: int, top_k: int, moe_inter: int,
               vocab: int = 151_936) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=vocab, hidden_size=h, num_layers=l,
        num_heads=nh, num_kv_heads=nkv, head_dim=128,
        intermediate_size=moe_inter, qk_norm=True, tie_embeddings=False,
        moe_experts=experts, moe_top_k=top_k,
        moe_intermediate_size=moe_inter, rope_theta=1_000_000.0,
        chat_template="chatml",
    )


def _llama(name: str, h: int, l: int, nh: int, nkv: int, inter: int,
           vocab: int = 128_256, tie: bool = False) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=vocab, hidden_size=h, num_layers=l,
        num_heads=nh, num_kv_heads=nkv, head_dim=h // nh,
        intermediate_size=inter, qk_norm=False, tie_embeddings=tie,
        rope_theta=500_000.0, norm_eps=1e-5, chat_template="llama3",
    )


def _gemma3(name: str, h: int, l: int, nh: int, nkv: int, inter: int,
            hd: int, vocab: int = 262_208) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=vocab, hidden_size=h, num_layers=l,
        num_heads=nh, num_kv_heads=nkv, head_dim=hd,
        intermediate_size=inter, qk_norm=True, tie_embeddings=True,
        rope_theta=1_000_000.0, local_rope_theta=10_000.0,
        sliding_window=1024, sliding_pattern="gemma", post_norms=True,
        embed_scale=True, activation="gelu", chat_template="gemma",
        norm_zero_centered=True,
    )


def _gpt_oss(name: str, h: int, l: int, nh: int, nkv: int,
             experts: int, top_k: int, moe_inter: int) -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=201_088, hidden_size=h, num_layers=l,
        num_heads=nh, num_kv_heads=nkv, head_dim=64,
        intermediate_size=moe_inter, qk_norm=False, tie_embeddings=False,
        moe_experts=experts, moe_top_k=top_k,
        moe_intermediate_size=moe_inter, rope_theta=150_000.0,
        sliding_window=128, sliding_pattern="alternate",
        attention_sink=True, attn_bias=True, moe_bias=True,
        activation="swiglu_oss",
        chat_template="chatml",
        rope_scaling_factor=32.0, rope_original_max=4096,
    )


MODEL_CONFIGS: Dict[str, ModelConfig] = {
    # Qwen3 dense
    "qwen3-0.6b": _qwen3("qwen3-0.6b", 1024, 28, 16, 8, 3072),
    "qwen3-4b": _qwen3("qwen3-4b", 2560, 36, 32, 8, 9728),
    "qwen3-8b": _qwen3("qwen3-8b", 4096, 36, 32, 8, 12288, tie=False),
    "qwen3-14b": _qwen3("qwen3-14b", 5120, 40, 40, 8, 17408, tie=False),
    "qwen3-32b": _qwen3("qwen3-32b", 5120, 64, 64, 8, 25600, tie=False),
    # Qwen3 MoE
    "qwen3-30b-a3b": _qwen3_moe("qwen3-30b-a3b", 2048, 48, 32, 4, 128, 8, 768),
    "qwen3-235b-a22b": _qwen3_moe("qwen3-235b-a22b", 4096, 94, 64, 4, 128, 8, 1536),
    # Llama
    "llama-3.2-3b": _llama("llama-3.2-3b", 3072, 28, 24, 8, 8192, tie=True),
    "llama-3.1-8b": _llama("llama-3.1-8b", 4096, 32, 32, 8, 14336),
    "llama-3.3-70b": _llama("llama-3.3-70b", 8192, 80, 64, 8, 28672),
    # Gemma 3
    "gemma3-4b": _gemma3("gemma3-4b", 2560, 34, 8, 4, 10240, 256),
    "gemma3-12b": _gemma3("gemma3-12b", 3840, 48, 16, 8, 15360, 256),
    "gemma3-27b": _gemma3("gemma3-27b", 5376, 62, 32, 16, 21504, 128),
    # gpt-oss
    "gpt-oss-20b": _gpt_oss("gpt-oss-20b", 2880, 24, 64, 8, 32, 4, 2880),
    "gpt-oss-120b": _gpt_oss("gpt-oss-120b", 2880, 36, 64, 8, 128, 4, 2880),
    # Embeddings (Qwen3 trunk + last-token-pool head)
    "qwen3-emb-0.6b": _qwen3("qwen3-emb-0.6b", 1024, 28, 16, 8, 3072, head="embedding"),
    "qwen3-emb-6b": _qwen3("qwen3-emb-6b", 4096, 36, 32, 8, 12288, tie=False, head="embedding"),
    "qwen3-emb-8b": _qwen3("qwen3-emb-8b", 4096, 36, 32, 8, 12288, tie=False, head="embedding"),
    # Tiny configs for tests / CI (CPU-friendly; byte-level vocab)
    "tiny-dense": ModelConfig(
        name="tiny-dense", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        qk_norm=True, chat_template="plain",
    ),
    "tiny-moe": ModelConfig(
        name="tiny-moe", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        moe_experts=4, moe_top_k=2, moe_intermediate_size=128,
        qk_norm=True, tie_embeddings=False, chat_template="plain",
    ),
    "tiny-oss": ModelConfig(
        name="tiny-oss", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        moe_experts=4, moe_top_k=2, moe_intermediate_size=128,
        moe_bias=True,
        attention_sink=True, sliding_window=8, sliding_pattern="alternate",
        tie_embeddings=False, activation="swiglu_oss", chat_template="plain",
    ),
    "tiny-emb": ModelConfig(
        name="tiny-emb", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        qk_norm=True, head="embedding", chat_template="plain",
    ),
}
