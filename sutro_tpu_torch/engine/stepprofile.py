"""Where a decode step's time goes on the card.

    python -m sutro_tpu_torch.engine.stepprofile

Builds the chip smoke's engine (``qwen3-8b``, random weights from a
seed, B=64 slots, 64-token pages, 32 pages per row), prefills 64 rows
of 16-500 tokens into the pool, then times and profiles, each after a
warm-up call:

- ``window``: one ``decode_multi`` window of 8 fused steps (plain rows:
  the pipelined path);
- ``seeded_step``: one ``decode_step`` with per-row seeds (the path a
  batch takes while any row carries ``row_seed``);
- ``prefill``: one ``prefill_batch`` of 8 rows x 500 tokens.

For each it prints one JSON line: host wall time (the median of 5
calls, each ending in a device synchronize), device busy time (the
union of CUDA kernel intervals in the ``torch.profiler`` trace of one
more call), the device's idle share of the median wall time, the
kernel launch count, and the top kernels by device time.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..models.configs import MODEL_CONFIGS
from .config import EngineConfig
from .runner import ModelRunner


def _busy_us(events) -> float:
    """Union of the device kernel intervals (us): overlapping kernels on
    several streams count once."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
    )
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
    busy_ms = _busy_us(kernels) / 1e3
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stepprofile: needs a CUDA device")

    mcfg = MODEL_CONFIGS["qwen3-8b"]
    ecfg = EngineConfig(kv_page_size=64, max_pages_per_seq=32, decode_batch_size=64,
                        max_model_len=2048, decode_multi_step=8)
    runner = ModelRunner(mcfg, ecfg)
    B, MP = ecfg.decode_batch_size, ecfg.max_pages_per_seq
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 501, B)
    tables = np.zeros((B, MP), np.int32)
    for b in range(B):
        tables[b] = np.arange(1 + b * MP, 1 + (b + 1) * MP)
    rows = [rng.integers(3, mcfg.vocab_size, n).astype(np.int32) for n in lens]
    for i in range(0, B, 8):
        runner.prefill_batch(rows[i : i + 8], tables[i : i + 8])
    past = lens.astype(np.int32)
    last = rng.integers(3, mcfg.vocab_size, B).astype(np.int32)
    temp = np.full(B, 0.7, np.float32)
    top_p = np.full(B, 0.95, np.float32)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "model": mcfg.name, "batch": B,
        "avg_past": float(past.mean()),
    }), flush=True)

    phases = {
        "window": lambda: runner.decode_multi(
            last, past, tables, 1, temp, top_p, ecfg.decode_multi_step),
        "seeded_step": lambda: runner.decode_step(
            last, past, tables, 1, temp, top_p,
            row_seeds=np.arange(B, dtype=np.int64)),
        "prefill": lambda: runner.prefill_batch(
            [rng.integers(3, mcfg.vocab_size, 500).astype(np.int32) for _ in range(8)],
            tables[:8]),
    }
    for name, fn in phases.items():
        print(json.dumps(profile_phase(name, fn)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
