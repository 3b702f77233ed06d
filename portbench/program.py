"""Everything the benchmark takes from the program, ``sutro_tpu_torch``.

- the entry the window drives: ``engine.api.LocalEngine`` (submit a job,
  stream its progress, read its rows), built from the configuration's
  engine settings;
- the model's widths (``models.configs.MODEL_CONFIGS``), checked
  against the configuration file before anything runs;
- the weights go in through the program's checkpoint loader
  (``engine.weights.load_checkpoint``), whose reader of checkpoint files
  is replaced by :class:`portbench.weights.SeededIndex`: the program maps
  and quantizes the drawn tensors as it would a checkpoint's;
- its hand-written kernels (``ops.cuda_build.CudaKernel``), built in
  set-up;
- spans around its runner's entry points (``engine.runner.ModelRunner``)
  and its grouped GEMM (``ops.moe.grouped_matmul``), recorded by
  :class:`Spans`.

Nothing else of the program is read.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import pkgutil
import threading
import time
from typing import Dict, List

import numpy as np

PACKAGE = "sutro_tpu_torch"

# configuration file key -> the program's ModelConfig field
WIDTHS = {
    "hidden_size": "hidden_size", "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "vocab_size": "vocab_size",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
    "num_experts": "moe_experts", "num_experts_per_tok": "moe_top_k",
    "moe_intermediate_size": "moe_intermediate_size",
}


def _mod(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


def check_model(cfg: Dict) -> None:
    """Raise unless the program's model under ``cfg["engine_key"]`` has
    the configuration's widths."""
    mc = _mod("models.configs").MODEL_CONFIGS[cfg["engine_key"]]
    m = cfg["model"]
    want = {f: m[k] for k, f in WIDTHS.items() if k in m}
    if not m.get("num_experts"):
        want["intermediate_size"] = m["intermediate_size"]
    want["tie_embeddings"] = bool(m.get("tie_word_embeddings", False))
    want["chat_template"] = cfg["chat_template"]
    got = {f: getattr(mc, f) for f in want}
    bad = {f: (got[f], want[f]) for f in want if got[f] != want[f]}
    if bad:
        raise SystemExit(f"portbench: {cfg['engine_key']} differs from its configuration "
                         f"file (program, file): {bad}")


def install_weights(seeded) -> None:
    """The program's checkpoint loader reads ``seeded``'s tensors."""
    from .weights import SeededIndex

    _mod("engine.weights")._ShardIndex = lambda _dir: SeededIndex(seeded)


def kernels() -> list:
    """Every hand-written kernel of the program (its ``CudaKernel``s)."""
    cb = _mod("ops.cuda_build")
    ops = _mod("ops")
    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for v in vars(mod).values():
            if isinstance(v, cb.CudaKernel):
                found[id(v)] = v
    return list(found.values())


def build_kernels() -> None:
    _mod("ops.cuda_build").build(kernels())


def make_engine(settings: Dict, weights_root: str, seed: int, device: str = "cuda"):
    api, config = _mod("engine.api"), _mod("engine.config")
    ecfg = config.EngineConfig(**settings, weights_dir=weights_root,
                               seed=int(seed) & ((1 << 63) - 1))
    return api.LocalEngine(ecfg, device=device)


def close_engine(eng, job_ids) -> None:
    """Cancel the jobs that still run, stop the engine's worker, and end
    every job's progress stream (a job cancelled while queued never ends
    its own, and a stream left open keeps the engine and its weights)."""
    for jid in job_ids:
        eng.cancel_job(jid)
    if not eng.close(timeout=60.0):
        raise RuntimeError("the engine's worker did not stop")
    for jid in job_ids:
        eng.metrics.job(jid).finish()


class Spans:
    """Host spans around the runner's entry points, and the grouped
    GEMM's calls. ``decode`` holds ``(t0, t1, steps, past, own, groups)``
    a call: ``past`` each active row's past tokens, ``own`` those of them
    in the row's own pages (past less its shared prefix), ``groups``
    ``[(shared prefix tokens, member rows)]``;
    ``prefill`` holds ``(t0, t1, rows, past)``: ``rows`` ``[(tokens,
    start)]``, ``past`` whether the call attends over paged past.
    ``gemm`` holds ``(t, M, K, N, group_sizes)`` with the group sizes
    left on the device until :meth:`experts_touched` reads them."""

    def __init__(self, page_size: int, prefill_chunk: int, record_gemm: bool):
        self.PS, self.C = page_size, prefill_chunk
        self.decode: List[tuple] = []
        self.prefill: List[tuple] = []
        self.gemm: List[tuple] = []
        self.last_active = 0
        self._depth = threading.local()
        self._undo = []
        runner = _mod("engine.runner").ModelRunner
        for name in ("decode_step", "decode_multi_async", "decode_multi"):
            self._wrap(runner, name, self._on_decode)
        for name in ("prefill", "prefill_batch", "prefill_batch_at"):
            self._wrap(runner, name, self._on_prefill)
        if record_gemm:
            moe = _mod("ops.moe")
            real = moe.grouped_matmul

            def gemm(lhs, rhs, group_sizes, *a, **kw):
                self.gemm.append((time.perf_counter(), lhs.shape[0], rhs.shape[-2],
                                  rhs.shape[-1], group_sizes))
                return real(lhs, rhs, group_sizes, *a, **kw)

            moe.grouped_matmul = gemm
            self._undo.append(lambda: setattr(moe, "grouped_matmul", real))

    def _wrap(self, cls, name, record) -> None:
        real = getattr(cls, name)
        sig = inspect.signature(real)

        @functools.wraps(real)
        def wrapper(runner, *a, **kw):
            depth = getattr(self._depth, "n", 0)
            self._depth.n = depth + 1
            t0 = time.perf_counter()
            try:
                return real(runner, *a, **kw)
            finally:
                self._depth.n = depth
                if depth == 0:   # the outermost entry only
                    args = sig.bind(runner, *a, **kw)
                    args.apply_defaults()
                    record(name, t0, time.perf_counter(), args.arguments)

        setattr(cls, name, wrapper)
        self._undo.append(lambda: setattr(cls, name, real))

    def _on_decode(self, name, t0, t1, a) -> None:
        table = np.asarray(a["page_table"])
        past = np.asarray(a["past_len"]).astype(np.int64)
        active = table[:, 0] != 0
        steps = int(a.get("steps", 1) or 1)
        own = past.copy()
        groups = []
        for pages, pfx_len in a.get("pfx") or ():
            pl = np.asarray(pfx_len).astype(np.int64)
            members = (pl > 0) & active
            own[members] -= pl[members]
            groups.append((len(pages) * self.PS, int(members.sum())))
        self.last_active = int(active.sum())
        self.decode.append((t0, t1, steps, past[active], own[active], groups))

    def _on_prefill(self, name, t0, t1, a) -> None:
        if name == "prefill":
            n, start = len(a["token_ids"]), int(a["start"])
            rows, past = [(n, start)], start > 0 or n > self.C
        else:
            starts = a.get("starts")
            rows = [(len(r), int(starts[i]) if starts is not None else 0)
                    for i, r in enumerate(a["rows"])]
            past = name == "prefill_batch_at"
        self.prefill.append((t0, t1, rows, past))

    def experts_touched(self, t0: float, t1: float) -> List[tuple]:
        """``(t, M, K, N, experts with rows)`` of the GEMM calls in ``[t0, t1]``."""
        return [(t, M, K, N, int((gs > 0).sum())) for t, M, K, N, gs in self.gemm
                if t0 <= t <= t1]

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        self.gemm.clear()
