"""Model runner: prefill / decode steps over the paged KV cache.

Port of ``sutro_tpu/engine/runner.py``: the device-side half of the
engine, with the same methods and host-side contract (numpy in, numpy
out, page tables built by the scheduler).

- ``prefill*``: causal attention over a prompt chunk (the flash-prefill
  kernel when there is no past), K/V written into the pages (the
  KV-write kernel), last-position logits back to the host.
- ``decode_step`` / ``decode_multi*``: one token, or a fused window of
  ``steps`` tokens, for every slot of the fixed-size decode batch
  (the paged-decode kernel in every layer), sampling on the device.
  With shared-prefix groups (``pfx``, EngineConfig.prefix_split) each
  layer-step first computes every group's prefix carry once for the
  batch (the prefix-carry kernel) and the paged-decode kernel starts
  each member row after the shared pages.

PyTorch runs eagerly, so the reference's ``jax.jit`` programs are plain
methods and its power-of-two shape buckets (there to bound compile
counts) are gone: a batch is padded to its longest row only. The card
still runs asynchronously: uploads go through pinned buffers without
waiting, and results cross to the host only where the reference fetched
them (``decode_multi_async`` returns device tensors the scheduler chains
the next window from).

- ``decode_window`` / ``commit_window``: a fused window that leaves
  the pages alone, so the scheduler can verify constrained rows'
  tokens against their FSMs and commit each row's accepted prefix
  (``allowed0`` FSM-masks the first step of rows that need it).
- ``verify_greedy`` / ``verify_candidates``: one forward over each
  row's last token and its draft against the paged past (n-gram
  speculation, FSM fast-forward), greedy or candidate-restricted
  choices per position back to the host.

int8 (``EngineConfig.quantize`` / ``kv_quantize``, as in the
reference): weight-only int8 projections (ops/quant.py, dequantized
before each product) and int8 KV pages with per-token scales
(engine/kvcache.py), read by the paged-decode kernel's int8 option.

Device meshes (``EngineConfig.dp/tp/ep/sp/pp`` > 1, parallel/): ``device``
is then a list of devices, one rank per entry (a single ``"cuda"`` means
``cuda:0..W-1``, ``"cpu"`` means W CPU ranks). This runner is rank 0 and
starts the other ranks itself (parallel/ranks.py); each holds its block
of the weights (parallel/sharding.py, pipeline.py) and of the pool
``[L/pp, NP, PS, KVH/tp*Dh]``, and runs every entry point rank 0 runs.
TP and EP collectives are in models/transformer.py and ops/moe_ep.py;
sp > 1 prefills without a past through the ring (ops/ring_attention.py);
pp > 1 prefills by GPipe and decodes stage by stage
(parallel/pipeline.py). As in the reference, int8 KV is ignored under pp
(with a warning) and a suffix or chunked prefill over a paged past is
refused under sp/pp. The mesh's ``data`` axis partitions as the
reference's does: weights and pool replicated over it, the runner's
batch unsplit, and only the MoE layers' tokens split over it
(ops/moe_ep.py); every rank of every data group samples the same tokens
(``token_mismatches``). Engine-level data parallelism, one engine a
rank, is engine/dphost.py.

The reference's ``kv_chunk`` (TPU DMA chunking) has no counterpart, so
``alloc_pages == num_pages``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models import transformer
from ..models.configs import ModelConfig
from ..ops.quant import is_quantized, params_bytes, quantize_params, tensors
from ..ops.sampling import (
    NEG_INF,
    apply_penalties,
    cumulative_logprob,
    fold_in,
    sample,
)
from ..parallel import sharding
from ..parallel.mesh import make_mesh, mesh_timeout, shared_card_fraction
from ..parallel.ranks import RankPool, entry
from ..telemetry import devicetime
from . import faults
from .config import EngineConfig
from .kvcache import alloc_cache, write_kv
from .kvtier import dequantize_payload

def next_bucket(n: int, lo: int = 16, hi: int = 1 << 20) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


def set_matmul_precision() -> None:
    """Full float32 matmuls and convolutions (no TF32) on the card, so a
    float32 run means float32 arithmetic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class WindowHandle:
    """A ``decode_window`` handle: the runner (every rank of a mesh)
    keeps the window's K/V under this number until its commit."""
    seq: int


def rank_report(runner: "ModelRunner") -> dict:
    """One rank's mesh figures: its device, seconds from its start to
    its runner built, peak device bytes, the collectives it issued and
    the host seconds they took, its token checks."""
    cuda = runner.device.type == "cuda"
    groups = [g for g in runner.mesh.groups.values() if g is not None]
    return {
        "rank": runner.mesh.rank,
        "device": str(runner.device),
        "ready_s": runner.ready_s,
        "peak_bytes": torch.cuda.max_memory_allocated(runner.device) if cuda else 0,
        "collectives": sum(g.calls for g in groups),
        "collective_s": sum(g.seconds for g in groups),
        "token_checks": runner.token_checks,
        "token_mismatches": runner.token_mismatches(),
    }


class ModelRunner:
    # the scheduler builds shared-prefix groups (``pfx``) for the decode
    # entry points only when the runner takes split decode
    split_prefix_decode = True

    def __init__(
        self,
        mcfg: ModelConfig,
        ecfg: EngineConfig,
        params: Optional[Any] = None,
        *,
        num_pages: Optional[int] = None,
        device="cuda",
        checkpoint: Optional[str] = None,
        _rank: Optional[tuple] = None,   # (rank, store or its path, start time): a worker
    ):
        t0 = time.time() if _rank is None else _rank[2]
        self.mcfg = mcfg
        self._entry = threading.local()
        self._capped = None
        if ecfg.quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode {ecfg.quantize!r} (only 'int8')")
        devices = self._mesh_devices(ecfg, device)
        self.mesh = self._pool = None
        self.sp = self.pp = 1
        if len(devices) > 1:
            ecfg = self._connect(mcfg, ecfg, params, num_pages, devices, checkpoint, _rank, t0)
        self.ecfg = ecfg
        self.device = self.mesh.device if self.mesh is not None else devices[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelRunner: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"ModelRunner: unsupported device {self.device}")
        set_matmul_precision()
        # the source of the scheduler's device timing: events on this
        # device's stream (rank 0's on a mesh); none on the CPU
        self.device_events = (
            devicetime.CudaEvents(self.device) if self.device.type == "cuda" else None
        )
        quantize = ecfg.quantize == "int8"
        self.dtype = getattr(torch, ecfg.param_dtype)
        mesh = self.mesh
        spec_fn = None
        if mesh is not None and self.pp > 1:
            from ..parallel.pipeline import pp_leaf_spec

            spec_fn = pp_leaf_spec
        if params is not None:
            if quantize and not any(
                is_quantized(t)
                for t in (*params["layers"].values(), params.get("lm_head"))
            ):
                # quantized whole, then cut: a row-parallel leaf's
                # per-channel scale reduces over the axis that is split
                params = quantize_params(params)
            if mesh is not None:
                specs = None
                if spec_fn is not None:
                    from ..parallel.pipeline import pp_param_shardings

                    specs = pp_param_shardings(params, mesh)
                params = sharding.to_device(
                    sharding.shard_params(params, mesh, specs=specs), self.device
                )
        elif checkpoint is not None:
            from .weights import load_checkpoint

            # int8: each layer's slice is read whole and quantized, then
            # cut to this rank's block
            params = load_checkpoint(checkpoint, mcfg, ecfg, self.device, mesh, spec_fn,
                                     quantize=quantize)
        else:
            # int8: each layer's slice is quantized as it is drawn, so the
            # full-precision model is never resident; under a mesh each
            # rank draws the whole stream and keeps its block
            gen = torch.Generator(device=self.device)
            gen.manual_seed(ecfg.seed)
            params = transformer.init_params(
                mcfg, gen, self.dtype, self.device, quantize=quantize,
                mesh=mesh, spec_fn=spec_fn,
            )
        self.params = params
        if num_pages is None:
            num_pages = 1 + ecfg.decode_batch_size * ecfg.max_pages_per_seq
        self.num_pages = num_pages
        self.alloc_pages = num_pages
        layers = kv_heads = None
        self._amax_group = None
        if mesh is not None:
            layers = mcfg.num_layers // self.pp
            kv_heads = mcfg.num_kv_heads // mesh.shape["model"]
            if ecfg.kv_quantize == "int8":
                self._amax_group = mesh.group("model")
        self.cache = alloc_cache(
            mcfg, ecfg, num_pages, self.dtype, self.device, layers=layers, kv_heads=kv_heads,
        )
        self._handles: dict = {}
        self._window_seq = 0
        self.token_checks = 0
        self._token_mismatch = None
        self.ready_s = time.time() - t0
        if mesh is not None:
            # every rank built: a worker that failed makes this raise
            with self._guard():
                mesh.ctrl.all_reduce(torch.ones(1))

    @staticmethod
    def _mesh_devices(ecfg: EngineConfig, device) -> list:
        """One device per rank of the mesh ``ecfg`` asks for: ``device``
        as a list (its first ``dp*pp*sp*ep*tp``), ``"cuda"`` ->
        ``cuda:0..W-1`` (raises when the machine has fewer cards, as the
        reference's ``make_mesh``), ``"cpu"`` -> W CPU ranks."""
        if isinstance(device, (list, tuple)):
            devices = [torch.device(d) for d in device]
            return devices[: int(np.prod(ecfg.resolved_mesh(len(devices))))]
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            world = int(np.prod(ecfg.resolved_mesh(max(torch.cuda.device_count(), 1))))
            return [torch.device("cuda", i) for i in range(world)] if world > 1 else [d]
        world = int(np.prod([x or 1 for x in (ecfg.dp, ecfg.pp, ecfg.sp, ecfg.ep, ecfg.tp)]))
        if d.type == "cpu":
            return [d] * world
        if world > 1:
            raise ValueError(
                f"a mesh of {world} ranks needs one device per rank, not {d}: "
                "pass device as a list"
            )
        return [d]

    def _connect(self, mcfg, ecfg, params, num_pages, devices, checkpoint, rank, t0):
        """Build this rank's mesh (rank 0 first starts the workers) and
        resolve the engine config against it as the reference does."""
        dp, pp, sp, ep, tp = ecfg.resolved_mesh(len(devices))
        mesh = make_mesh(dp, ep, tp, devices, sp=sp, pp=pp)
        sharding.check_tp_divides_kv_heads(mesh, mcfg.num_kv_heads)
        if mcfg.num_heads % tp:
            raise ValueError(f"TP axis size {tp} must divide num_heads {mcfg.num_heads}")
        if mcfg.num_layers % pp:
            raise ValueError(f"layers {mcfg.num_layers} not divisible by pipe size {pp}")
        if mcfg.moe_experts and mcfg.moe_experts % ep:
            raise ValueError(f"expert axis {ep} must divide num_experts {mcfg.moe_experts}")
        if pp > 1 and ecfg.kv_quantize:
            # as the reference: the pipeline decode carries bare pools
            warnings.warn(
                "kv_quantize is not supported under pipeline "
                "parallelism; ignoring it for this pp mesh"
            )
            ecfg = dataclasses.replace(ecfg, kv_quantize=None)
        if rank is None:
            host = None
            if params is not None:   # shipped to the workers on the host
                host = sharding._map(params, lambda _, x: torch.as_tensor(x).detach().cpu())
            self._pool = RankPool(dict(
                mcfg=mcfg, ecfg=ecfg, params=host, num_pages=num_pages,
                devices=[str(d) for d in devices], checkpoint=checkpoint, t0=t0,
            ), mesh.size)
            store, r = self._pool.store(), 0
        else:   # a worker: the spawned ranks' file store, or torchrun's
            from ..parallel.mesh import file_store

            r = rank[0]
            store = file_store(rank[1], mesh.size) if isinstance(rank[1], str) else rank[1]
        mesh.rank = r
        frac = shared_card_fraction(devices, mesh.device)
        if frac is not None:
            # ranks sharing a card: each caching allocator takes its share
            # (rank 0's cap is lifted again by close)
            torch.cuda.set_per_process_memory_fraction(frac, mesh.device)
            self._capped = mesh.device
        if self._pool is not None:
            self._pool.attach(mesh)
            self._pool.wait_up(store, mesh_timeout())
        else:
            store.set(f"up/{r}", "1")
        with self._guard():
            mesh.connect(store, r)
        self.mesh = mesh
        self.sp, self.pp = sp, pp
        return ecfg

    def _guard(self):
        """Rank 0: a failed worker's broken connection -> RankFailure."""
        return self._pool.guard() if self._pool is not None else contextlib.nullcontext()

    def _entry_depth(self) -> int:
        """Entry points this thread is inside (parallel/ranks.py)."""
        return getattr(self._entry, "depth", 0)

    @contextlib.contextmanager
    def _entry_scope(self):
        self._entry.depth = self._entry_depth() + 1
        try:
            yield
        finally:
            self._entry.depth -= 1

    def close(self) -> None:
        """Stop the worker ranks of a mesh runner (also done when the
        runner is garbage-collected and at exit), and lift the cap that
        sharing a card put on this process's allocator."""
        if self._pool is not None:
            self._pool.close()
        if self._capped is not None:
            torch.cuda.set_per_process_memory_fraction(1.0, self._capped)
            self._capped = None

    @entry()
    def on_ranks(self, fn, *args):
        """``fn(runner, *args)`` on every rank (``fn`` importable by its
        module path); returns the list of results, one per rank. A
        single-device runner returns ``[fn(self, *args)]``."""
        got = fn(self, *args)
        if self.mesh is None:
            return [got]
        return self.mesh.ctrl.gather_objects(got)

    def mesh_report(self) -> list:
        """Each rank's mesh figures (:func:`rank_report`)."""
        return self.on_ranks(rank_report)

    def _record_tokens(self, toks: torch.Tensor) -> None:
        """On a mesh, every rank's sampled tokens are compared (each
        rank samples its own copy of the same logits); differences are
        counted on the device and read by ``token_mismatches``."""
        if self.mesh is None:
            return
        got = self.mesh.world.all_gather(toks.to(torch.int32).reshape(1, -1), 0)
        bad = (got != got[:1]).any().to(torch.int64)
        self._token_mismatch = bad if self._token_mismatch is None else self._token_mismatch + bad
        self.token_checks += 1

    def token_mismatches(self) -> int:
        """Sampling calls whose tokens differed between ranks."""
        return 0 if self._token_mismatch is None else int(self._token_mismatch)

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    def _up(self, x, dtype: torch.dtype) -> torch.Tensor:
        """Host array -> device tensor without waiting on the card: a
        pinned staging copy and a non-blocking transfer on CUDA. Device
        tensors pass through (cast if needed)."""
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=dtype)
        t = torch.tensor(np.asarray(x), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _pfx_up(self, pfx) -> Optional[tuple]:
        """Shared-prefix groups ``((pages [Pp], pfx_len [B]), ...)`` ->
        int32 device tensors, uploaded once per decode call."""
        if not pfx:
            return None
        return tuple(
            (self._up(p, torch.int32), self._up(n, torch.int32)) for p, n in pfx
        )

    @staticmethod
    def _host(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    def _paged(self, page_table: torch.Tensor) -> tuple:
        """The ``paged_past`` tuple for transformer.forward: 3 elements
        for a bf16 cache, 5 (with the per-token scales) for int8."""
        c = self.cache
        if c.quantized:
            return (c.k_pages, c.v_pages, c.k_scale, c.v_scale, page_table)
        return (c.k_pages, c.v_pages, page_table)

    def device_info(self) -> dict:
        """Device + model facts the bottleneck doctor grades decode
        windows against. Computed once per runner."""
        cached = getattr(self, "_device_info", None)
        if cached is not None:
            return cached
        cuda = self.device.type == "cuda"
        info = {
            "device_kind": (
                torch.cuda.get_device_name(self.device) if cuda else "cpu"
            ),
            "n_devices": (
                self.mesh.size if self.mesh is not None
                else torch.cuda.device_count() if cuda else 1
            ),
            # int8 leaves and their scales count at their own widths
            "param_bytes": params_bytes(self.params),
            "n_params": int(sum(t.numel() for t in tensors(self.params))),
            "num_layers": int(self.mcfg.num_layers),
            "kv_heads": int(self.mcfg.num_kv_heads),
            "head_dim": int(self.mcfg.head_dim),
            "kv_dtype_bytes": self.cache.k_pages.element_size(),
        }
        self._device_info = info
        return info

    # ------------------------------------------------------------------
    # tiered-KV page migration
    # ------------------------------------------------------------------

    @entry()
    def read_pages(self, page_ids) -> dict:
        """Host copies of ``page_ids``'s K/V payloads, ``k``/``v``
        ``[L, n, PS, KD]``: float32 for a bfloat16 pool (exact; numpy has
        no bfloat16), int8 plus the per-token scales ``ks``/``vs`` ``[L,
        n, PS]`` for an int8 pool. Fetched synchronously, so the caller
        may free the pages the moment this returns. On a mesh the ranks'
        blocks are gathered into the full ``KVH*Dh`` rows of every layer
        (the int8 scales are the same on every ``model`` rank)."""
        ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)
        c = self.cache
        if c.quantized:
            out = {"k": c.k_pages[:, ids], "v": c.v_pages[:, ids],
                   "ks": c.k_scale[:, ids], "vs": c.v_scale[:, ids]}
        else:
            out = {"k": c.k_pages[:, ids].float(), "v": c.v_pages[:, ids].float()}
        if self.mesh is not None:
            model, pipe = self.mesh.group("model"), self.mesh.group("pipe")
            for key, x in out.items():
                if model is not None and key in ("k", "v"):
                    x = model.all_gather(x, -1)
                if pipe is not None:
                    x = pipe.all_gather(x, 0)
                out[key] = x
        return {key: self._host(x) for key, x in out.items()}

    def _block(self, x, key: str):
        """This rank's block of a full-pool payload array."""
        if self.mesh is None:
            return x
        x = np.asarray(x)
        c = self.mesh.coords()
        L = self.cache.k_pages.shape[0]
        x = x[c["pipe"] * L : (c["pipe"] + 1) * L]
        if key in ("k", "v"):
            KD = self.cache.k_pages.shape[-1]
            x = x[..., c["model"] * KD : (c["model"] + 1) * KD]
        return x

    @entry()
    def write_pages(self, page_ids, payload: dict) -> None:
        """Upload a payload into freshly allocated pages: a raw-dtype
        one from ``read_pages``, or the tier's int8 form (values plus
        per-token scales). An int8 payload promotes into a bfloat16 pool
        by dequantizing on the way up, as in the reference. On a mesh
        every rank receives the whole payload and writes its block."""
        ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)
        c = self.cache
        if c.quantized:
            c.k_pages[:, ids] = self._up(self._block(payload["k"], "k"), torch.int8)
            c.v_pages[:, ids] = self._up(self._block(payload["v"], "v"), torch.int8)
            c.k_scale[:, ids] = self._up(self._block(payload["ks"], "ks"), torch.float32)
            c.v_scale[:, ids] = self._up(self._block(payload["vs"], "vs"), torch.float32)
            return
        if np.asarray(payload["k"]).dtype == np.int8:
            payload = dequantize_payload(payload, np.float32)
        dt = c.k_pages.dtype
        c.k_pages[:, ids] = self._up(self._block(payload["k"], "k"), dt)
        c.v_pages[:, ids] = self._up(self._block(payload["v"], "v"), dt)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _forward(self, ids, positions, valid_len, head_index=None, **kw):
        """The trunk on this runner's mesh: the plain forward (TP and EP
        collectives inside, the ring over ``seq`` with no past), or the
        pipeline schedule under ``pipe > 1``."""
        if self.pp > 1:
            from ..parallel import pipeline

            if kw.get("paged_past") is None:
                B = ids.shape[0]
                return pipeline.pipeline_forward(
                    self.mcfg, self.params, ids, positions, valid_len, self.mesh,
                    n_microbatches=min(self.ecfg.pp_microbatches or self.pp, B),
                    head_index=head_index,
                )
            if ids.shape[1] > 1:
                raise NotImplementedError(
                    "a forward over a paged past with T > 1 (suffix or chunked "
                    "prefill, verify) is unsupported under pp, as in the reference"
                )
            return pipeline.pipeline_decode(
                self.mcfg, self.params, ids, positions, valid_len, kw["paged_past"],
                kw["past_len"], self.mesh, window_past=kw.get("window_past"),
                head_index=head_index,
            )
        return transformer.forward(
            self.mcfg, self.params, ids, positions, valid_len, head_index=head_index,
            mesh=self.mesh, ring_mesh=self.mesh if self.sp > 1 else None, **kw,
        )

    def _write(self, k, v, table, start, valid_len) -> None:
        write_kv(self.cache, k, v, table, start, valid_len, amax_group=self._amax_group)

    def _prefill(self, ids, valid_len, page_table, start, with_past: bool):
        """One padded chunk ``ids [B, T]``: trunk forward (over the paged
        past when ``with_past``), K/V written into the pages, and the
        logits at each row's last valid position ``[B, V]`` (the head
        runs on those positions only, see transformer.forward). Under sp
        ``T`` is padded to a multiple of the ``seq`` size; under pp ``B``
        to a multiple of the microbatches (padding rows write page 0)."""
        n = ids.shape[0]
        if not with_past and (self.sp > 1 or self.pp > 1):
            T = -(-ids.shape[1] // self.sp) * self.sp
            M = min(self.ecfg.pp_microbatches or self.pp, n)
            B = -(-n // M) * M
            if (B, T) != ids.shape:
                pad = np.zeros((B, T), np.int32)
                pad[:n, : ids.shape[1]] = ids
                tables = np.zeros((B, np.asarray(page_table).shape[1]), np.int32)
                tables[:n] = page_table
                ids, page_table = pad, tables
                valid_len = np.concatenate([np.asarray(valid_len, np.int32),
                                            np.zeros(B - n, np.int32)])
                start = np.zeros(B, np.int32)
        T = ids.shape[1]
        ids = self._up(ids, torch.int32)
        valid_len = self._up(valid_len, torch.int32)
        table = self._up(page_table, torch.int32)
        start = self._up(start, torch.int32)
        positions = start[:, None] + torch.arange(
            T, device=self.device, dtype=torch.int32
        )[None, :]
        last = (valid_len - 1).clamp(min=0)
        kw = {}
        if with_past:
            kw = dict(paged_past=self._paged(table), past_len=start)
        logits, _, (k, v) = self._forward(ids, positions, valid_len, head_index=last, **kw)
        self._write(k, v, table, start, valid_len)
        return logits[:n, 0]

    def prefill(
        self, token_ids: np.ndarray, page_table: np.ndarray, start: int = 0,
    ) -> np.ndarray:
        """One prompt ([T] int32) -> last-position logits [V].
        ``page_table`` is the slot's [MP] row. Prompts longer than
        ``prefill_chunk`` run in fixed-size chunks over the pages the
        earlier chunks wrote. ``start`` > 0 prefills a SUFFIX attending
        over pages that already hold positions < start."""
        if faults.ACTIVE is not None:
            faults.inject("runner.prefill")
        n = len(token_ids)
        if start > 0 and (self.sp > 1 or self.pp > 1):
            # the chunked paged path has no ring or pipeline schedule
            raise ValueError("suffix prefill is unsupported under sp/pp")
        if start > 0 and n <= self.ecfg.prefill_chunk:
            return self.prefill_batch_at(
                [token_ids], page_table[None, :], [start]
            )[0]
        return self._prefill_one(token_ids, page_table, start)

    @entry()
    def _prefill_one(self, token_ids, page_table, start: int) -> np.ndarray:
        """``prefill``'s chunked path (a suffix, or more than
        ``prefill_chunk`` tokens, on one ``seq`` and ``pipe`` rank) or its
        one forward with no past."""
        n = len(token_ids)
        C = self.ecfg.prefill_chunk
        if (start > 0 or n > C) and self.sp == 1 and self.pp == 1:
            table = page_table[None, :]
            for off in range(0, n, C):
                seg = token_ids[off : off + C]
                ids = np.zeros((1, C), np.int32)
                ids[0, : len(seg)] = seg
                logits = self._prefill(
                    ids, [len(seg)], table, [start + off], with_past=True
                )
            return self._host(logits[0])
        ids = np.zeros((1, max(n, 1)), np.int32)
        ids[0, :n] = token_ids
        logits = self._prefill(ids, [n], page_table[None, :], [0], with_past=False)
        return self._host(logits[0])

    def _pack(self, rows: list, page_tables: np.ndarray):
        n = len(rows)
        T = max([len(r) for r in rows] + [1])
        ids = np.zeros((n, T), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            lens[i] = len(r)
        return ids, lens, np.asarray(page_tables[:n], np.int32)

    @entry("runner.prefill")
    def prefill_batch(self, rows: list, page_tables: np.ndarray) -> np.ndarray:
        """Batched prefill with no past: N prompts in one forward ->
        last-position logits [N, V]. ``page_tables`` is [N, MP]."""
        ids, lens, tables = self._pack(rows, page_tables)
        logits = self._prefill(
            ids, lens, tables, np.zeros((len(rows),), np.int32), with_past=False
        )
        return self._host(logits)

    def _refuse_paged_chunk(self, *args, **kwargs) -> None:
        """A forward of T > 1 over a paged past has no pipeline schedule
        (as in the reference): refused before the call is sent."""
        if self.pp > 1:
            raise NotImplementedError(
                "a forward over a paged past with T > 1 (suffix or chunked "
                "prefill, verify) is unsupported under pp, as in the reference"
            )

    @entry("runner.prefill", check=_refuse_paged_chunk)
    def prefill_batch_at(
        self, rows: list, page_tables: np.ndarray, starts
    ) -> np.ndarray:
        """Batched SUFFIX prefill: row i begins at global position
        ``starts[i]`` and attends over pages that already hold its
        earlier positions."""
        ids, lens, tables = self._pack(rows, page_tables)
        logits = self._prefill(
            ids, lens, tables, np.asarray(starts, np.int32), with_past=True
        )
        return self._host(logits)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _trunk_decode(
        self, ids, positions, past_len, table, window_past=None, pfx=None,
    ):
        B = ids.shape[0]
        kw = dict(paged_past=self._paged(table), past_len=past_len,
                  window_past=window_past)
        if pfx is not None:
            kw["pfx_groups"] = pfx
        return self._forward(
            ids, positions, torch.ones((B,), dtype=torch.int32, device=self.device), **kw
        )

    def _sampling_args(self, temperature, top_p, top_k, B):
        if top_k is None:
            top_k = np.zeros((B,), np.int32)
        return dict(
            temperature=self._up(temperature, torch.float32),
            top_p=self._up(top_p, torch.float32),
            top_k=self._up(top_k, torch.int32),
        )

    @entry("runner.decode")
    def decode_step(
        self,
        last_tokens: np.ndarray,     # [B] int32
        past_len: np.ndarray,        # [B] int32
        page_table: np.ndarray,      # [B, MP] int32
        rng: int,
        temperature: np.ndarray,     # [B]
        top_p: np.ndarray,           # [B]
        top_k: Optional[np.ndarray] = None,     # [B] int32; None => disabled
        allowed: Optional[np.ndarray] = None,   # [B, V] bool
        row_seeds: Optional[np.ndarray] = None,  # [B] int
        penalties=None,  # (seen_packed [B, ceil(V/8)] uint8, pen_ids [B,K],
        #                   pen_cnt [B,K], presence [B], frequency [B],
        #                   repetition [B])
        pfx=None,  # ((pages [Pp], pfx_len [B]), ...) split-prefix groups
    ) -> Tuple[np.ndarray, np.ndarray]:
        B = len(last_tokens)
        ids = self._up(np.asarray(last_tokens)[:, None], torch.int32)
        past = self._up(past_len, torch.int32)
        table = self._up(page_table, torch.int32)
        logits, _, (k, v) = self._trunk_decode(
            ids, past[:, None], past, table, pfx=self._pfx_up(pfx)
        )
        self._write(k, v, table, past, torch.ones((B,), dtype=torch.int32, device=self.device))
        step_logits = logits[:, 0]
        if penalties is not None:
            # pre-applied so the reported logprob is w.r.t. the
            # penalized distribution too (seen-bits arrive packed)
            seen_packed, ids_p, cnt_p, pres, freq, rep = penalties
            seen = np.unpackbits(
                np.asarray(seen_packed, np.uint8), axis=1,
                count=self.mcfg.vocab_size,
            ).astype(bool)
            step_logits = apply_penalties(
                step_logits, self._up(seen, torch.bool),
                self._up(ids_p, torch.int32), self._up(cnt_p, torch.float32),
                self._up(pres, torch.float32), self._up(freq, torch.float32),
                self._up(rep, torch.float32),
            )
        tok = sample(
            step_logits, rng,
            allowed=None if allowed is None else self._up(allowed, torch.bool),
            row_seeds=None if row_seeds is None else [int(s) for s in row_seeds],
            **self._sampling_args(temperature, top_p, top_k, B),
        )
        logp = cumulative_logprob(step_logits, tok)
        self._record_tokens(tok)
        return self._host(tok), self._host(logp)

    # ------------------------------------------------------------------
    # multi-step decode
    # ------------------------------------------------------------------

    def _window_scan(
        self, last, past_len, table, rng, sampling, steps: int, pfx=None,
        allowed0=None,
    ):
        """``steps`` trunk forwards over the invariant pages plus the
        window buffer, sampling on the device. Returns (toks [steps, B],
        logps [steps, B], wk, wv) with the window K/V NOT yet in the
        pages: the pool is never written inside the window, so no step
        can read a slot it wrote itself. Step ``s`` sees the earlier
        steps' K/V as window slots ``< s`` (the query sits at
        ``past_len + s``). ``pfx``: shared-prefix groups as device
        tensors (``_pfx_up``).

        ``allowed0`` ([B, V] bool device tensor, optional) masks the
        FIRST step's sampling only: a row whose previous window rejected
        a token takes its FSM-masked step inside the next window. The
        logprob stays over the unmasked logits, as on the masked
        single step, so a row's cumulative logprob does not depend on
        the path that committed each token."""
        B = last.shape[0]
        L, KD = self.cache.k_pages.shape[0], self.cache.k_pages.shape[-1]  # this rank's
        # fused trailing axis, like the page pool (engine/kvcache.py);
        # under an int8 pool the window holds unquantized K/V in the
        # activation dtype, as in the reference (write_kv quantizes them
        # at the commit)
        dtype = (getattr(torch, self.ecfg.activation_dtype) if self.cache.quantized
                 else self.dtype)
        wk = torch.zeros((L, B, steps, KD), dtype=dtype, device=self.device)
        wv = torch.zeros_like(wk)
        toks, logps = [], []
        cur = last
        for step in range(steps):
            logits, _, (k, v) = self._trunk_decode(
                cur[:, None], (past_len + step)[:, None], past_len, table,
                window_past=(wk, wv, step), pfx=pfx,
            )
            wk[:, :, step] = k.reshape(L, B, KD)
            wv[:, :, step] = v.reshape(L, B, KD)
            step_logits = logits[:, 0]
            cur = sample(
                step_logits, fold_in(rng, step),
                allowed=allowed0 if step == 0 else None, **sampling,
            )
            toks.append(cur)
            logps.append(cumulative_logprob(step_logits, cur))
        toks = torch.stack(toks)
        self._record_tokens(toks)
        return toks, torch.stack(logps), wk, wv

    def decode_multi(
        self,
        last_tokens: np.ndarray,     # [B] int32
        past_len: np.ndarray,        # [B] int32
        page_table: np.ndarray,      # [B, MP] int32
        rng: int,
        temperature: np.ndarray,     # [B]
        top_p: np.ndarray,           # [B]
        steps: int,
        top_k: Optional[np.ndarray] = None,
        pfx=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens [steps, B], logprobs [steps, B]): a window of
        ``decode_multi_async``, fetched."""
        toks, logps = self.decode_multi_async(
            last_tokens, past_len, page_table, rng, temperature, top_p,
            steps, top_k=top_k, pfx=pfx,
        )
        return self._host(toks), self._host(logps)

    @entry("runner.decode")
    def decode_multi_async(
        self,
        last_tokens,                 # [B] int32 (numpy OR device tensor)
        past_len: np.ndarray,        # [B] int32
        page_table: np.ndarray,      # [B, MP] int32
        rng: int,
        temperature: np.ndarray,     # [B]
        top_p: np.ndarray,           # [B]
        steps: int,
        top_k: Optional[np.ndarray] = None,
        pfx=None,  # ((pages [Pp], pfx_len [B]), ...) split-prefix groups
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like ``decode_multi`` but returns DEVICE tensors without
        waiting: callers chain the next window off ``toks[-1]`` before
        this window's results cross to the host. The window's K/V go
        into the pages once, after the last step."""
        B = past_len.shape[0]
        last = self._up(last_tokens, torch.int32)
        past = self._up(past_len, torch.int32)
        table = self._up(page_table, torch.int32)
        sampling = self._sampling_args(temperature, top_p, top_k, B)
        toks, logps, wk, wv = self._window_scan(
            last, past, table, rng, sampling, steps, pfx=self._pfx_up(pfx)
        )
        self._write(wk, wv, table, past,
                    torch.full((B,), steps, dtype=torch.int32, device=self.device))
        return toks, logps

    def merge_last(self, prev_last, refresh_mask, refresh_vals):
        """Rows whose slot was re-admitted between dispatches take their
        host-known first token; everyone else chains the previous
        window's last sampled token. No host wait."""
        return torch.where(
            self._up(refresh_mask, torch.bool),
            self._up(refresh_vals, torch.int32),
            prev_last.to(torch.int32),
        )

    # ------------------------------------------------------------------
    # n-gram speculation and FSM fast-forward: verify forwards
    # ------------------------------------------------------------------

    def _verify_forward(self, last_tokens, drafts, draft_len, past_len, page_table):
        """One forward over ``[B, K+1]`` known tokens (each row's last
        token and its draft) against the paged past, K/V written for the
        ``draft_len + 1`` valid inputs. Returns the float32 logits ``[B,
        K+1, V]`` and each position's plain greedy token and its
        logprob. Rejected positions' K/V become dead stores past the
        row's accepted length (masked by ``past_len``, overwritten as
        decode proceeds)."""
        B, K = drafts.shape
        ids = np.zeros((B, K + 1), np.int32)
        ids[:, 0] = last_tokens
        ids[:, 1:] = drafts
        ids = self._up(ids, torch.int32)
        valid = self._up(np.asarray(draft_len, np.int32) + 1, torch.int32)
        start = self._up(past_len, torch.int32)
        table = self._up(page_table, torch.int32)
        positions = start[:, None] + torch.arange(
            K + 1, device=self.device, dtype=torch.int32
        )[None, :]
        logits, _, (k, v) = self._forward(
            ids, positions, valid, paged_past=self._paged(table), past_len=start,
        )
        self._write(k, v, table, start, valid)
        lg = logits.float()
        lse = torch.logsumexp(lg, dim=-1)                     # [B, C]
        plain = torch.argmax(lg, dim=-1)
        plain_lp = lg.gather(-1, plain[..., None])[..., 0] - lse
        return lg, lse, plain.to(torch.int32), plain_lp

    @entry(check=_refuse_paged_chunk)
    def verify_greedy(
        self,
        last_tokens: np.ndarray,   # [B] int32
        drafts: np.ndarray,        # [B, K] int32 (pad anything)
        draft_len: np.ndarray,     # [B] int32 — valid draft tokens
        past_len: np.ndarray,      # [B] int32
        page_table: np.ndarray,    # [B, MP] int32
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy verification: row b's inputs are ``[last, d0 ..
        d_{L-1}]`` (L = draft_len[b]); position t's output is the model's
        greedy next token after input t, and its logprob, each ``[B,
        K+1]``. The scheduler accepts the longest matching draft prefix
        plus the bonus token at the first mismatch; rows with draft_len
        0 take a plain greedy step."""
        _, _, toks, logps = self._verify_forward(
            last_tokens, drafts, draft_len, past_len, page_table
        )
        return self._host(toks), self._host(logps)

    @entry(check=_refuse_paged_chunk)
    def verify_candidates(
        self,
        last_tokens: np.ndarray,   # [B] int32
        drafts: np.ndarray,        # [B, K] int32 (pad anything)
        draft_len: np.ndarray,     # [B] int32
        cand: np.ndarray,          # [B, K+1, M] int32 (pad id 0)
        cand_n: np.ndarray,        # [B, K+1] int32 — 0 = unplanned position
        past_len: np.ndarray,      # [B] int32
        page_table: np.ndarray,    # [B, MP] int32
    ):
        """Masked-candidate verification (FSM fast-forward): position
        (b, j)'s choice is the argmax over its first ``cand_n[b, j]``
        candidate ids, the masked-path token without shipping ``[B,
        K+1, V]`` masks. Candidate logprobs are taken against the FULL
        vocabulary's softmax, the distribution the masked single step
        reports. Returns ``(cand_toks, cand_logps, plain_toks,
        plain_logps)``, each ``[B, K+1]``; the plain greedy choices
        serve the rows without a plan."""
        lg, lse, plain, plain_lp = self._verify_forward(
            last_tokens, drafts, draft_len, past_len, page_table
        )
        cand = self._up(cand, torch.int64)
        M = cand.shape[2]
        ok = (
            torch.arange(M, device=self.device)[None, None, :]
            < self._up(cand_n, torch.int32)[..., None]
        )
        g = lg.gather(2, cand).masked_fill(~ok, NEG_INF)
        ctok = cand.gather(2, torch.argmax(g, dim=-1, keepdim=True))   # [B, C, 1]
        clp = lg.gather(2, ctok)[..., 0] - lse
        return (
            self._host(ctok[..., 0].to(torch.int32)), self._host(clp),
            self._host(plain), self._host(plain_lp),
        )

    # ------------------------------------------------------------------
    # speculative window decode (constrained rows)
    # ------------------------------------------------------------------

    @entry("runner.decode")
    def decode_window(
        self,
        last_tokens: np.ndarray,     # [B] int32
        past_len: np.ndarray,        # [B] int32
        page_table: np.ndarray,      # [B, MP] int32
        rng: int,
        temperature: np.ndarray,     # [B]
        top_p: np.ndarray,           # [B]
        steps: int,
        top_k: Optional[np.ndarray] = None,
        allowed0: Optional[np.ndarray] = None,  # [B, V] bool, step 0 only
        pfx=None,  # ((pages [Pp], pfx_len [B]), ...) split-prefix groups
    ):
        """A fused window that leaves the pages alone: returns (tokens
        [steps, B], logprobs [steps, B], handle). The scheduler verifies
        constrained rows' tokens on the host, then calls
        ``commit_window(handle, accepted)`` to write each row's accepted
        prefix, so a rejected suffix costs nothing. The handle holds the
        window's K/V and device copies of ``past_len`` and the page
        table (the caller's arrays may be live views that change before
        the commit); the runner keeps them under the handle's number
        (every rank its own block), the last few windows at most."""
        B = len(last_tokens)
        past = self._up(past_len, torch.int32)
        table = self._up(page_table, torch.int32)
        toks, logps, wk, wv = self._window_scan(
            self._up(last_tokens, torch.int32), past, table, rng,
            self._sampling_args(temperature, top_p, top_k, B), steps,
            pfx=self._pfx_up(pfx),
            allowed0=None if allowed0 is None else self._up(allowed0, torch.bool),
        )
        self._window_seq += 1
        self._handles[self._window_seq] = (wk, wv, past, table)
        for old in [k for k in self._handles if k <= self._window_seq - 8]:
            del self._handles[old]
        return self._host(toks), self._host(logps), WindowHandle(self._window_seq)

    @entry()
    def commit_window(self, handle, accepted: np.ndarray) -> None:
        """Write each row's first ``accepted[b]`` (0 .. steps) window
        tokens' K/V into the page pool."""
        wk, wv, past, table = self._handles.pop(handle.seq)
        self._write(wk, wv, table, past, self._up(accepted, torch.int32))

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------

    @entry("runner.embed")
    def embed_batch(self, rows: list) -> np.ndarray:
        """List of token-id rows -> ``[N, H]`` float32 embeddings on the
        host. The rows pad to one ``[N, T]`` batch (``T`` a power-of-two
        bucket of the longest row) and run one forward with no past, so
        every layer's attention is flash prefill; the embedding head
        pools each row over its valid tokens only (last or mean) and
        L2-normalizes. No KV page is written."""
        n = len(rows)
        maxlen = max((len(r) for r in rows), default=1)
        T = next_bucket(max(maxlen, 1), lo=16, hi=self.ecfg.max_context())
        ids = np.zeros((n, T), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            lens[i] = len(r)
        if self.sp > 1 or self.pp > 1:   # the ring's T, the pipeline's B
            T = -(-T // self.sp) * self.sp
            M = min(self.ecfg.pp_microbatches or self.pp, n)
            B = -(-n // M) * M
            ids = np.pad(ids, ((0, B - n), (0, T - ids.shape[1])))
            lens = np.pad(lens, (0, B - n))
        positions = torch.arange(T, device=self.device, dtype=torch.int32)[None, :]
        emb, _, _ = self._forward(
            self._up(ids, torch.int32), positions.expand(ids.shape[0], T),
            self._up(lens, torch.int32),
        )
        return self._host(emb[:n].float())
