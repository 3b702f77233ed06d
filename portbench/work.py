"""The window's work, summed from the harness's spans, for the per-layer
metric readers: decode and prefill calls opened inside the window, by the
yardstick's arithmetic (:mod:`portbench.yardstick`)."""

from __future__ import annotations

from typing import Optional, Tuple

from . import yardstick as ys


def decode_tokens(view) -> int:
    return sum(steps * len(past) for _, _, steps, past, _, _ in view.decode_calls())


def has_groups(view) -> bool:
    return any(g for *_, g in view.decode_calls())


def paged_decode(view) -> Tuple[float, float]:
    """Every layer-step's decode attention over the rows' own pages and
    window (context ``own + s + 1`` at step ``s``)."""
    m = view.model
    flops = nbytes = 0.0
    for _, _, steps, _, own, _ in view.decode_calls():
        n = len(own)
        f, b = ys.paged_decode(m, steps * float(own.sum()) + n * steps * (steps + 1) / 2,
                               n * steps)
        flops += f
        nbytes += b
    return flops * m.L, nbytes * m.L


def prefix_carry(view) -> Tuple[float, float]:
    m = view.model
    flops = nbytes = 0.0
    for _, _, steps, _, _, groups in view.decode_calls():
        for shared, members in groups:
            f, b = ys.prefix_carry(m, shared, members)
            flops += steps * f
            nbytes += steps * b
    return flops * m.L, nbytes * m.L


def prefill_rows(view, past: Optional[bool] = None):
    return [(t, s) for _, _, rows, p, in view.prefill_calls() if past is None or p == past
            for t, s in rows]


def flash_prefill(view) -> Tuple[float, float]:
    f, b = ys.flash_prefill(view.model, [t for t, _ in prefill_rows(view, past=False)])
    return f * view.model.L, b * view.model.L


def kv_write(view) -> Tuple[float, float]:
    tokens = decode_tokens(view) + sum(t for t, _ in prefill_rows(view))
    f, b = ys.kv_write(view.model, tokens)
    return f, b * view.model.L


def grouped_matmul(view) -> Tuple[float, float]:
    flops = nbytes = 0.0
    for _, M, K, N, experts in view.gemm:
        f, b = ys.grouped_matmul(M, K, N, experts)
        flops += f
        nbytes += b
    return flops, nbytes


def model_flops(view) -> float:
    """The model's operations over the window's tokens: each decode token
    at its context with its logits, each prefilled position at its
    context, and the logits of each prefilled row's last position."""
    m = view.model
    a = m.token_flops(0, logits=False)
    per_ctx = m.token_flops(1, logits=False) - a
    head = m.token_flops(0, logits=True) - a
    total = 0.0
    for _, _, steps, past, _, _ in view.decode_calls():
        n = len(past)
        ctx = steps * float(past.sum()) + n * steps * (steps + 1) / 2
        total += n * steps * (a + head) + per_ctx * ctx
    for t, s in prefill_rows(view):
        total += t * a + per_ctx * (t * s + t * (t + 1) / 2) + head
    return total


def decode_bytes(view) -> float:
    """Bytes the window's decode steps need (``Model.decode_step_bytes``),
    an MoE step reading the experts its grouped GEMMs were given rows for."""
    m = view.model
    total = 0.0
    for t0, t1, steps, past, _, _ in view.decode_calls():
        experts = None
        if m.E:
            touched = [e for t, _, _, _, e in view.gemm if t0 <= t <= t1]
            if touched:
                experts = [sum(touched) / len(touched)] * m.L
        for s in range(steps):
            total += m.decode_step_bytes(list(past + s), experts)
    return total


def roofline(view, work, match) -> Optional[float]:
    if view.peaks is None:
        return None
    seconds = view.kernel_seconds(match)
    if not seconds:
        return None
    flops, nbytes = work(view)
    return ys.share(flops, nbytes, seconds, view.peaks)
