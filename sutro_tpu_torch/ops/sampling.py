"""Token sampling with optional constrained-decoding masks.

Port of ``sutro_tpu/ops/sampling.py``: temperature / top_p / top_k over
float32 logits, greedy as the ``temperature == 0`` case, sampling
penalties, and per-row seeded draws.

Random keys are plain integers instead of JAX PRNG keys:
:func:`split_key` and :func:`fold_in` derive new keys by a 64-bit mix,
and each draw comes from an explicit ``torch.Generator`` seeded from
its key on the logits' device. A row-seeded row draws from its own
generator, seeded from ``(key, row_seed)``, so its stream does not
depend on what else is in the batch. The two frameworks give different
numbers from the same seed; tests compare distributions.

The reference's ``approx_max_k`` was a TPU workaround for a slow exact
top-k; here the nucleus head is an exact ``torch.topk``, which keeps the
same contract. Greedy is an exact argmax.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30
# widest nucleus/top-k head considered for sampling (see sample())
NUCLEUS_CAP = 256

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer, reduced to a non-negative 63-bit seed."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (the jax.random.fold_in role)."""
    return _mix(_mix(int(key)) ^ (int(data) & _M64))


def split_key(key: int) -> Tuple[int, int]:
    """``(next_key, subkey)`` (the jax.random.split role)."""
    return fold_in(key, 0x5EED), fold_in(key, 0xD12A)


def _generator(key: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


def _gumbel(shape, key: int, device) -> torch.Tensor:
    """Standard Gumbel noise in float32 from the generator of ``key``.
    Uniforms are clamped away from 0, so every value is finite."""
    u = torch.rand(shape, generator=_generator(key, device), device=device)
    return -torch.log(-torch.log(u.clamp_(min=1e-20)))


def apply_penalties(
    logits: torch.Tensor,      # [B, V] float32 (raw, pre-temperature)
    seen_rep: torch.Tensor,    # [B, V] bool — prompt + generated tokens
    pen_ids: torch.Tensor,     # [B, K] int32, -1 padded — distinct GENERATED ids
    pen_cnt: torch.Tensor,     # [B, K] float32 — their counts
    presence: torch.Tensor,    # [B] float32; 0 disables
    frequency: torch.Tensor,   # [B] float32; 0 disables
    repetition: torch.Tensor,  # [B] float32; 1 disables
) -> torch.Tensor:
    """Repetition divides positive / multiplies negative logits of tokens
    in ``seen_rep``; presence subtracts a flat bias and frequency a
    count-proportional bias from GENERATED tokens only."""
    B, V = logits.shape
    dt = logits.dtype
    rep = repetition[:, None].to(dt)
    rep_l = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen_rep, rep_l, logits)
    ids = pen_ids.long().clamp(0, V - 1)
    add = torch.where(pen_ids >= 0, pen_cnt.float(), torch.zeros_like(pen_cnt, dtype=torch.float32))
    counts = torch.zeros((B, V), dtype=torch.float32, device=logits.device)
    counts.scatter_add_(1, ids, add)
    logits = logits - (presence[:, None] * (counts > 0)).to(dt)
    return logits - (frequency[:, None] * counts).to(dt)


def sample(
    logits: torch.Tensor,                 # [B, V] float32
    key: int,
    *,
    temperature,                          # scalar or [B]
    top_p,                                # scalar or [B]; 1.0 disables
    top_k=0,                              # scalar or [B]; 0 disables
    allowed: Optional[torch.Tensor] = None,  # [B, V] bool — constrained decoding
    row_seeds: Optional[Sequence[int]] = None,  # [B] host ints — per-row keys
) -> torch.Tensor:
    """Returns sampled token ids ``[B]`` int32.

    Filtered rows (``top_k > 0`` or ``top_p < 1``) sample from the top
    ``NUCLEUS_CAP`` logits, normalized against the exact full-vocab
    logsumexp; unfiltered rows sample the full vocabulary (gumbel-max
    categorical). ``row_seeds`` gives each row its own generator derived
    from ``(key, row_seed)`` (the reference's ``random_seed_per_input``).
    No step here waits for the device."""
    B, V = logits.shape
    dev = logits.device
    if allowed is not None:
        logits = torch.where(allowed, logits, torch.full_like(logits, NEG_INF))

    def per_row(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(B)

    temperature = per_row(temperature, torch.float32)
    top_p = per_row(top_p, torch.float32)
    top_k = per_row(top_k, torch.int64)

    scaled = logits / temperature.clamp(min=1e-6)[:, None].to(logits.dtype)
    K = min(NUCLEUS_CAP, V)
    top_vals, top_idx = torch.topk(scaled, K, dim=-1)    # sorted, exact
    greedy_tok = torch.argmax(scaled, dim=-1)

    lse = torch.logsumexp(scaled.float(), dim=-1, keepdim=True)
    top_vals = top_vals.float()
    probs = torch.exp(top_vals - lse)                    # exact probabilities

    ranks = torch.arange(K, device=dev)[None, :]
    k_active = top_k > 0
    # top_k beyond the cap clamps to the cap-wide head, never disables
    k_eff = torch.where(k_active, top_k.clamp(max=K), torch.full_like(top_k, K))
    keep_k = ranks < k_eff[:, None]
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]              # always keeps rank 0
    vals = torch.where(keep_k & keep_p, top_vals, torch.full_like(top_vals, NEG_INF))

    filtered = k_active | (top_p < 1.0)
    if row_seeds is not None:
        keys = [fold_in(key, int(s)) for s in row_seeds]
        g_head = torch.stack([_gumbel((K,), k, dev) for k in keys])
        g_full = torch.stack([_gumbel((V,), fold_in(k, 1), dev) for k in keys])
    else:
        g_head = _gumbel((B, K), key, dev)
        g_full = _gumbel((B, V), fold_in(key, 1), dev)
    choice = torch.argmax(vals + g_head, dim=-1)
    full_tok = torch.argmax(scaled.float() + g_full, dim=-1)
    head_tok = top_idx.gather(1, choice[:, None])[:, 0]
    sampled = torch.where(filtered, head_tok, full_tok)
    return torch.where(temperature <= 0.0, greedy_tok, sampled).to(torch.int32)


def cumulative_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Per-step logprob of the chosen token. Gather-then-logsumexp so the
    full [B, V] log_softmax is never materialized."""
    chosen = logits.gather(1, token.long()[:, None])[:, 0].float()
    return chosen - torch.logsumexp(logits.float(), dim=-1)
