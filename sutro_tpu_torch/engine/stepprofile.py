"""Where a decode step's time goes on the card.

    python -m sutro_tpu_torch.engine.stepprofile [--model qwen3-8b|qwen3-30b-a3b|qwen3-32b|qwen3-emb-0.6b|gpt-oss-20b]

Builds one of the five engines of ``chip_smoke.py``'s serve phases
(:data:`ENGINES`, which the smoke test builds its engines from) with
random weights from a seed and fills its pool, then times and profiles
its phases:

- ``qwen3-8b`` (the default): B=64 slots, 64-token pages, 32 pages per
  row; 64 rows of 16-500 tokens prefilled; ``prefill`` is one
  ``prefill_batch`` of 8 rows x 500 tokens;
- ``qwen3-30b-a3b``: the templated job of serve 2, B=64 slots, 24
  pages per row, ``prefix_split`` on: a 1,024-token template prefilled
  once into pages 1..16 and 64 rows' 16-256-token suffixes after it;
  the decode phases carry the template as one prefix group;
  ``prefill`` is one ``prefill_batch_at`` of 8 suffixes x 256 tokens
  over the template;
- ``qwen3-32b``: int8 weights and int8 KV pages, otherwise as
  ``qwen3-8b`` (B=64 slots, 64-token pages, 32 pages per row, 64 rows
  of 16-500 tokens, ``prefill`` 8 rows x 500 tokens);
- ``qwen3-emb-0.6b``: the embedding model of serve 6 at ``qwen3-8b``'s
  geometry; its one phase, ``embed``, is one ``embed_batch`` of 64 rows
  x 512 tokens (every layer's attention through flash prefill, then the
  pooled head);
- ``gpt-oss-20b``: the stage-graph engine of serve 8 (Dh 64, a sink and
  a 128-token window on every other layer, 32 experts top-4 at
  H = F = 2,880), at ``qwen3-8b``'s geometry with ``prefix_split`` and
  a 1,024-token template as ``qwen3-30b-a3b``'s (serve 8's critique
  prompt); the window cuts the template on the windowed layers.

The phases, in this order, each after a warm-up call:

- ``window``: one ``decode_multi`` window of 8 fused steps (plain rows:
  the pipelined path);
- for a MoE model, ``window_spread_routing``: the same window with each
  token routed to ``top_k`` distinct experts drawn uniformly (weighted
  by the softmax of the router's logits for them). Random weights route
  a step's tokens to few experts; a trained router spreads them over
  nearly all, and the expert GEMMs then read nearly every expert's
  weights. This phase measures the window at that spread;
- with a template, ``window_no_split``: the same window without the
  prefix groups (every row walks the template's pages itself), so the
  split's device and host costs can be read side by side;
- with int8 weights, ``dequantize``: every int8 leaf dequantized once
  (``ops/quant.materialize``), as each forward does: the per-step
  dequantization cost on its own line;
- ``seeded_step``: one ``decode_step`` with per-row seeds (the path a
  batch takes while any row carries ``row_seed``);
- ``prefill`` as above.

For each it prints one JSON line: host wall time (the median of 5
calls, each ending in a device synchronize), device busy time (the
union of CUDA kernel intervals in the ``torch.profiler`` trace of one
more call), the device's idle share of the median wall time, the
kernel launch count, and the top kernels by device time. For a MoE
model two last lines count the experts that receive rows in each
grouped-GEMM call of one more decode step, with the model's routing
and with the spread one (the bytes the expert GEMMs must read depend
on it).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.configs import MODEL_CONFIGS
from .config import EngineConfig
from .runner import ModelRunner


def _busy_us(spans) -> float:
    """Union of the device kernel intervals ``(start, end)`` (us):
    overlapping kernels on several streams count once. The intervals of
    a profiler's events, or of a Chrome trace's kernel events (``ts``,
    ``ts + dur``)."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_phase(name: str, fn: Callable[[], None], repeats: int = 5) -> Dict:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: allocator, kernel libraries, cuBLAS heuristics
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = _busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
    by_name: Dict[str, List[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    return {
        "phase": name,
        "wall_ms": wall_ms,
        "wall_ms_min_max": [min(walls), max(walls)],
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches": len(kernels),
        "top_kernels": [
            {"name": n[:90], "count": len(ts), "ms": sum(ts) / 1e3}
            for n, ts in top
        ],
    }


# chip_smoke.py's serve engines, by model: the EngineConfig fields
# and the length in tokens of the template every request shares
ENGINES = {
    "qwen3-8b": (
        dict(kv_page_size=64, max_pages_per_seq=32, decode_batch_size=64,
             max_model_len=2048, decode_multi_step=8),
        0,      # no shared template
    ),
    "qwen3-30b-a3b": (
        dict(kv_page_size=64, max_pages_per_seq=24, decode_batch_size=64,
             max_model_len=1536, prefill_chunk=2048, decode_multi_step=8,
             prefix_split=True),
        1024,   # a shared 1,024-token template
    ),
    # int8 weights and int8 KV pages: the one way a 32B dense model
    # serves on one 80 GB card (33.6 GB of weights, 17.3 GB of pool)
    "qwen3-32b": (
        dict(kv_page_size=64, max_pages_per_seq=32, decode_batch_size=64,
             max_model_len=2048, prefill_chunk=512, decode_multi_step=8,
             quantize="int8", kv_quantize="int8"),
        0,
    ),
    # the embedding model at serve 1's geometry: batches of 64 rows
    "qwen3-emb-0.6b": (
        dict(kv_page_size=64, max_pages_per_seq=32, decode_batch_size=64,
             max_model_len=2048, decode_multi_step=8),
        0,
    ),
    # the SDK's default model (serve 8's stage graphs): ~41.8 GB of bf16
    # weights and a 6.4 GB pool; rows admit against what the pool holds
    # (a shared prompt's pages count once there, not once a row)
    "gpt-oss-20b": (
        dict(kv_page_size=64, max_pages_per_seq=32, decode_batch_size=64,
             max_model_len=2048, decode_multi_step=8, prefix_split=True,
             max_batch_tokens=64 * 2048),
        1024,   # serve 8's critique system prompt
    ),
}


def experts_used(name: str, fn: Callable[[], None]) -> Dict:
    """Experts with rows in each grouped-GEMM call of one ``fn()``."""
    from ..ops import moe

    real = moe.grouped_matmul
    used: List[int] = []

    def counting(lhs, rhs, group_sizes):
        used.append(int((group_sizes > 0).sum()))
        return real(lhs, rhs, group_sizes)

    moe.grouped_matmul = counting
    try:
        fn()
    finally:
        moe.grouped_matmul = real
    return {"phase": name, "grouped_gemm_calls": len(used),
            "mean": float(np.mean(used)), "min": min(used), "max": max(used)}


@contextlib.contextmanager
def spread_routing(seed: int = 0):
    """Route each token to ``top_k`` distinct experts drawn uniformly on
    the device, weighted by the softmax of the router's logits for
    them; everything after the routing runs as it does."""
    from ..ops import moe

    real = moe._route
    gens: Dict[torch.device, torch.Generator] = {}

    def route(xt, router, router_b, top_k):
        N, E = xt.shape[0], router.shape[-1]
        if xt.device not in gens:
            gens[xt.device] = torch.Generator(device=xt.device).manual_seed(seed)
        g = gens[xt.device]
        logits = xt.float() @ router.float()
        if router_b is not None:
            logits = logits + router_b.float()
        draw = torch.rand((N, E), generator=g, device=xt.device)
        top_idx = torch.topk(draw, top_k, dim=-1).indices
        probs = torch.softmax(logits.gather(1, top_idx), dim=-1)
        M = N * top_k
        return (top_idx, probs, top_idx.reshape(M),
                torch.arange(M, device=xt.device) // top_k, probs.reshape(M))

    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def dequantize_all(params, dtype: torch.dtype) -> None:
    """Materialize every int8 leaf once, as one forward does."""
    from ..ops.quant import is_quantized, materialize

    for leaf in [*params["layers"].values(), params.get("lm_head")]:
        if not is_quantized(leaf):
            continue
        if leaf["qw"].dim() == 2:   # lm_head
            materialize(leaf, dtype)
            continue
        for i in range(leaf["qw"].shape[0]):   # one layer's slice per forward
            materialize({"qw": leaf["qw"][i], "scale": leaf["scale"][i]}, dtype)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(ENGINES), default="qwen3-8b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stepprofile: needs a CUDA device")

    mcfg = MODEL_CONFIGS[args.model]
    fields, n_tpl = ENGINES[args.model]
    ecfg = EngineConfig(**fields)
    runner = ModelRunner(mcfg, ecfg)
    B, MP, PS = ecfg.decode_batch_size, ecfg.max_pages_per_seq, ecfg.kv_page_size
    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(3, mcfg.vocab_size, n).astype(np.int32)  # noqa: E731
    if mcfg.head == "embedding":
        rows = [tok(512) for _ in range(B)]
        print(json.dumps({"card": torch.cuda.get_device_name(0), "model": mcfg.name,
                          "batch": B, "tokens_per_row": 512}), flush=True)
        print(json.dumps(profile_phase("embed", lambda: runner.embed_batch(rows))),
              flush=True)
        return 0
    n_head = n_tpl // PS
    tables = np.zeros((B, MP), np.int32)
    tables[:, :n_head] = np.arange(1, 1 + n_head)
    for b in range(B):
        tables[b, n_head:] = np.arange(1 + n_head + b * (MP - n_head),
                                       1 + n_head + (b + 1) * (MP - n_head))
    pfx = None
    if n_tpl:
        runner.prefill(tok(n_tpl), tables[0])
        lens = rng.integers(16, 257, B)
        rows = [tok(n) for n in lens]
        for i in range(0, B, 8):
            runner.prefill_batch_at(rows[i : i + 8], tables[i : i + 8], [n_tpl] * 8)
        past = (n_tpl + lens).astype(np.int32)
        pfx = ((np.arange(1, 1 + n_head, dtype=np.int32), np.full(B, n_tpl, np.int32)),)
        prefill = lambda: runner.prefill_batch_at(  # noqa: E731
            [tok(256) for _ in range(8)], tables[:8], [n_tpl] * 8)
    else:
        lens = rng.integers(16, 501, B)
        rows = [tok(n) for n in lens]
        for i in range(0, B, 8):
            runner.prefill_batch(rows[i : i + 8], tables[i : i + 8])
        past = lens.astype(np.int32)
        prefill = lambda: runner.prefill_batch(  # noqa: E731
            [tok(500) for _ in range(8)], tables[:8])
    last = tok(B)
    temp = np.full(B, 0.7, np.float32)
    top_p = np.full(B, 0.95, np.float32)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "model": mcfg.name, "batch": B,
        "avg_past": float(past.mean()), "shared_template": n_tpl,
    }), flush=True)

    def window(pfx=pfx):
        runner.decode_multi(last, past, tables, 1, temp, top_p, ecfg.decode_multi_step,
                            pfx=pfx)

    def window_spread():
        with spread_routing():
            window()

    # the windows first and side by side: host speed drifts over a run
    phases = {"window": window}
    if mcfg.moe_experts:
        phases["window_spread_routing"] = window_spread
    if pfx is not None:
        phases["window_no_split"] = lambda: window(pfx=None)
    if ecfg.quantize:
        phases["dequantize"] = lambda: dequantize_all(runner.params, runner.dtype)
    phases["seeded_step"] = lambda: runner.decode_step(
        last, past, tables, 1, temp, top_p,
        row_seeds=np.arange(B, dtype=np.int64), pfx=pfx)
    phases["prefill"] = prefill
    for name, fn in phases.items():
        print(json.dumps(profile_phase(name, fn)), flush=True)
    if mcfg.moe_experts:
        step = phases["seeded_step"]

        def step_spread():
            with spread_routing():
                step()
        print(json.dumps(experts_used("experts_used", step)), flush=True)
        print(json.dumps(experts_used("experts_used_spread_routing", step_spread)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
