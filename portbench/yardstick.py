"""The yardstick: the chip's peaks and the operations and bytes that a
piece of work needs, from the configuration's widths and the shapes of
the calls, whatever the program does to compute it.

Peaks: NVIDIA's H100 SXM data sheet (dense bf16, no sparsity; at the
card's 700 W limit). Bytes: each input read once and each output
written once. Weights are bytes at rest: int8 values and one float32
scale an output channel where the configuration quantizes weights; KV
entries at the pool's width (int8 values and a float32 scale a token
and layer for each of K and V where the configuration quantizes them).

The arithmetic of decode bytes a step follows
``sutro_tpu_torch/engine/roofline.py`` (``decode_bytes_per_step``),
corrected for MoE: only the experts a step routes to are read.
Operations count attention (QK and PV over each token's context), which
that module's prefill grade leaves out, and only the active parameters
of an MoE layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

# device name substring (lower case) -> (HBM bytes/s, bf16 FLOP/s)
PEAKS: Dict[str, Tuple[float, float]] = {"h100": (3.35e12, 989e12)}


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    kind = (device_name or "").lower()
    return next((v for k, v in PEAKS.items() if k in kind), None)


@dataclass(frozen=True)
class Model:
    H: int
    L: int
    NH: int
    KVH: int
    Dh: int
    V: int
    F: int          # dense MLP width (0 with experts)
    E: int          # experts (0: dense)
    K: int          # experts a token
    Fm: int         # expert width
    w_int8: bool
    kv_int8: bool

    @classmethod
    def of(cls, cfg: Dict) -> "Model":
        m, eng = cfg["model"], cfg["engine"]
        E = int(m.get("num_experts") or 0)
        return cls(
            H=m["hidden_size"], L=m["num_hidden_layers"], NH=m["num_attention_heads"],
            KVH=m["num_key_value_heads"],
            Dh=m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"],
            V=m["vocab_size"], F=0 if E else m["intermediate_size"], E=E,
            K=int(m.get("num_experts_per_tok") or 0), Fm=int(m.get("moe_intermediate_size") or 0),
            w_int8=eng.get("quantize") == "int8", kv_int8=eng.get("kv_quantize") == "int8",
        )

    # -- sizes ------------------------------------------------------------

    def weight_bytes(self, n_in: int, n_out: int) -> float:
        return n_in * n_out * (1 if self.w_int8 else 2) + (n_out * 4 if self.w_int8 else 0)

    def attn_params(self) -> int:
        return self.H * self.Dh * (2 * self.NH + 2 * self.KVH)

    def attn_weight_bytes(self) -> float:
        H, q, kv = self.H, self.NH * self.Dh, self.KVH * self.Dh
        return (self.weight_bytes(H, q) + 2 * self.weight_bytes(H, kv)
                + self.weight_bytes(q, H))

    def kv_token_bytes(self) -> float:
        """One token's K and V in one layer's pool."""
        return 2 * self.KVH * self.Dh * (1 if self.kv_int8 else 2) + (8 if self.kv_int8 else 0)

    def mlp_params_active(self) -> int:
        if self.E:
            return self.H * self.E + self.K * 3 * self.H * self.Fm
        return 3 * self.H * self.F

    # -- whole-model work -------------------------------------------------

    def token_flops(self, ctx: float, logits: bool) -> float:
        """One token through every layer with ``ctx`` positions of context
        (its own included), plus the output head when it makes logits."""
        per_layer = 2 * (self.attn_params() + self.mlp_params_active()) + 4 * self.NH * self.Dh * ctx
        return self.L * per_layer + (2 * self.H * self.V if logits else 0)

    def decode_step_bytes(self, ctx: Sequence[float], experts: Optional[Sequence[int]] = None) -> float:
        """Bytes one decode step needs: every weight read once (for an MoE
        layer the router and the ``experts[l]`` experts that step routes
        to), the output head, and each active row's KV read and its new
        token's written."""
        if self.E:
            ex = experts if experts is not None else [self.E] * self.L
            mlp = sum(self.H * self.E * 2 + e * 3 * self.weight_bytes(self.H, self.Fm) for e in ex)
        else:
            mlp = self.L * (2 * self.weight_bytes(self.H, self.F) + self.weight_bytes(self.F, self.H))
        weights = self.L * self.attn_weight_bytes() + mlp + self.weight_bytes(self.H, self.V)
        kv = self.L * self.kv_token_bytes() * (sum(ctx) + len(ctx))
        return weights + kv


# -- one kernel's work (operations, bytes), summed over calls ---------------

def paged_decode(m: Model, positions: float, queries: int) -> Tuple[float, float]:
    """Decode attention of one layer: ``queries`` row-steps attending to
    ``positions`` positions in all (in the rows' own pages and window)."""
    flops = 4.0 * m.NH * m.Dh * positions
    nbytes = positions * m.kv_token_bytes() + queries * 2 * m.NH * m.Dh * 2
    return flops, nbytes


def prefix_carry(m: Model, shared_tokens: int, members: int) -> Tuple[float, float]:
    """One group's shared prefix in one layer-step: its KV read once, each
    member's query read and its partial (max, sum, accumulator, f32)
    written."""
    flops = 4.0 * m.NH * m.Dh * shared_tokens * members
    nbytes = (shared_tokens * m.kv_token_bytes() + members * m.NH * m.Dh * 2
              + members * m.NH * (m.Dh + 2) * 4)
    return flops, nbytes


def flash_prefill(m: Model, rows: Iterable[int]) -> Tuple[float, float]:
    """Causal attention of one layer over prompts with no past."""
    rows = list(rows)
    flops = sum(4.0 * m.NH * m.Dh * t * (t + 1) / 2 for t in rows)
    nbytes = sum(t * (2 * m.NH + 2 * m.KVH) * m.Dh * 2 for t in rows)
    return flops, nbytes


def kv_write(m: Model, tokens: int) -> Tuple[float, float]:
    """One layer's new K and V (bf16) read and written into the pool."""
    return 0.0, tokens * (2 * m.KVH * m.Dh * 2 + m.kv_token_bytes())


def grouped_matmul(M: int, K: int, N: int, experts: int) -> Tuple[float, float]:
    """``M`` routed rows by the ``[K, N]`` weights of ``experts`` experts."""
    return 2.0 * M * K * N, experts * K * N * 2 + M * K * 2 + M * N * 2


def share(flops: float, nbytes: float, seconds: float, pk: Tuple[float, float]) -> Optional[float]:
    """Percent of the roofline: the least time (bytes over bandwidth or
    operations over peak, whichever is longer) over the time taken."""
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    bound = max(nbytes / pk[0], flops / pk[1])
    return 100.0 * bound / seconds
