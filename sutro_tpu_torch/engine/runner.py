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

Not ported yet, and raising: device meshes (multi-GPU), int8 weights
and int8 KV pages, constrained decoding's
``decode_window``/``commit_window``/``verify_*``, and ``embed_batch``.
The reference's ``kv_chunk`` (TPU DMA chunking) has no counterpart, so
``alloc_pages == num_pages``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models import transformer
from ..models.configs import ModelConfig
from ..ops.sampling import (
    apply_penalties,
    cumulative_logprob,
    fold_in,
    sample,
)
from . import faults
from .config import EngineConfig
from .kvcache import alloc_cache, write_kv

CONSTRAINED_SLICE = (
    "constrained decoding (decode_window / commit_window / verify_*) is "
    "the next slice of the CUDA port (ROADMAP.md)"
)


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
    ):
        self.mcfg = mcfg
        self.ecfg = ecfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelRunner: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"ModelRunner: unsupported device {self.device}")
        set_matmul_precision()
        if ecfg.quantize:
            raise NotImplementedError(
                "int8 weights (quantize) are not ported to the CUDA engine "
                "yet (ROADMAP.md)"
            )
        if ecfg.kv_quantize:
            raise NotImplementedError(
                "int8 KV pages (kv_quantize) are not ported to the CUDA "
                "engine yet (ROADMAP.md)"
            )
        n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if any(
            (getattr(ecfg, axis) or 1) > 1 for axis in ("dp", "tp", "ep", "sp", "pp")
        ) or int(np.prod(ecfg.resolved_mesh(max(n_dev, 1)))) > 1:
            raise NotImplementedError(
                "device meshes (dp/tp/ep/sp/pp > 1) are not ported to the "
                "CUDA engine yet (ROADMAP.md, multi-GPU)"
            )
        self.dtype = getattr(torch, ecfg.param_dtype)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(ecfg.seed)
            params = transformer.init_params(mcfg, gen, self.dtype, self.device)
        self.params = params
        if num_pages is None:
            num_pages = 1 + ecfg.decode_batch_size * ecfg.max_pages_per_seq
        self.num_pages = num_pages
        self.alloc_pages = num_pages
        self.cache = alloc_cache(mcfg, ecfg, num_pages, self.dtype, self.device)

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

    def device_info(self) -> dict:
        """Device + model facts the bottleneck doctor grades decode
        windows against. Computed once per runner."""
        cached = getattr(self, "_device_info", None)
        if cached is not None:
            return cached
        leaves = [
            t for v in self.params.values()
            for t in (v.values() if isinstance(v, dict) else [v])
        ]
        cuda = self.device.type == "cuda"
        info = {
            "device_kind": (
                torch.cuda.get_device_name(self.device) if cuda else "cpu"
            ),
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "param_bytes": int(sum(t.numel() * t.element_size() for t in leaves)),
            "n_params": int(sum(t.numel() for t in leaves)),
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

    def read_pages(self, page_ids) -> dict:
        """Host copies of ``page_ids``'s K/V payloads, ``k``/``v``
        ``[L, n, PS, KD]`` float32 (exact for a bfloat16 pool; numpy has
        no bfloat16). Fetched synchronously, so the caller may free the
        pages the moment this returns."""
        ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)
        c = self.cache
        return {
            "k": self._host(c.k_pages[:, ids].float()),
            "v": self._host(c.v_pages[:, ids].float()),
        }

    def write_pages(self, page_ids, payload: dict) -> None:
        """Upload a raw-dtype payload from ``read_pages`` into freshly
        allocated pages. The tier's int8 payloads are not ported yet."""
        if np.asarray(payload["k"]).dtype == np.int8:
            raise NotImplementedError(
                "int8 tier payloads are not ported to the CUDA engine yet"
            )
        ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)
        dt = self.cache.k_pages.dtype
        self.cache.k_pages[:, ids] = self._up(payload["k"], dt)
        self.cache.v_pages[:, ids] = self._up(payload["v"], dt)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _prefill(self, ids, valid_len, page_table, start, with_past: bool):
        """One padded chunk ``ids [B, T]``: trunk forward (over the paged
        past when ``with_past``), K/V written into the pages, and the
        logits at each row's last valid position ``[B, V]`` (the head
        runs on those positions only, see transformer.forward)."""
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
            kw = dict(
                paged_past=(self.cache.k_pages, self.cache.v_pages, table),
                past_len=start,
            )
        logits, _, (k, v) = transformer.forward(
            self.mcfg, self.params, ids, positions, valid_len,
            head_index=last, **kw,
        )
        write_kv(self.cache, k, v, table, start, valid_len)
        return logits[:, 0]

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
        C = self.ecfg.prefill_chunk
        if start > 0 and n <= C:
            return self.prefill_batch_at(
                [token_ids], page_table[None, :], [start]
            )[0]
        if start > 0 or n > C:
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

    def prefill_batch(self, rows: list, page_tables: np.ndarray) -> np.ndarray:
        """Batched prefill with no past: N prompts in one forward ->
        last-position logits [N, V]. ``page_tables`` is [N, MP]."""
        if faults.ACTIVE is not None:
            faults.inject("runner.prefill")
        ids, lens, tables = self._pack(rows, page_tables)
        logits = self._prefill(
            ids, lens, tables, np.zeros((len(rows),), np.int32), with_past=False
        )
        return self._host(logits)

    def prefill_batch_at(
        self, rows: list, page_tables: np.ndarray, starts
    ) -> np.ndarray:
        """Batched SUFFIX prefill: row i begins at global position
        ``starts[i]`` and attends over pages that already hold its
        earlier positions."""
        if faults.ACTIVE is not None:
            faults.inject("runner.prefill")
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
        return transformer.forward(
            self.mcfg, self.params, ids, positions,
            torch.ones((B,), dtype=torch.int32, device=self.device),
            paged_past=(self.cache.k_pages, self.cache.v_pages, table),
            past_len=past_len,
            window_past=window_past,
            pfx_groups=pfx,
        )

    def _sampling_args(self, temperature, top_p, top_k, B):
        if top_k is None:
            top_k = np.zeros((B,), np.int32)
        return dict(
            temperature=self._up(temperature, torch.float32),
            top_p=self._up(top_p, torch.float32),
            top_k=self._up(top_k, torch.int32),
        )

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
        if faults.ACTIVE is not None:
            faults.inject("runner.decode")
        B = len(last_tokens)
        ids = self._up(np.asarray(last_tokens)[:, None], torch.int32)
        past = self._up(past_len, torch.int32)
        table = self._up(page_table, torch.int32)
        logits, _, (k, v) = self._trunk_decode(
            ids, past[:, None], past, table, pfx=self._pfx_up(pfx)
        )
        write_kv(
            self.cache, k, v, table, past,
            torch.ones((B,), dtype=torch.int32, device=self.device),
        )
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
        return self._host(tok), self._host(logp)

    # ------------------------------------------------------------------
    # multi-step decode
    # ------------------------------------------------------------------

    def _window_scan(
        self, last, past_len, table, rng, sampling, steps: int, pfx=None,
    ):
        """``steps`` trunk forwards over the invariant pages plus the
        window buffer, sampling on the device. Returns (toks [steps, B],
        logps [steps, B], wk, wv) with the window K/V NOT yet in the
        pages: the pool is never written inside the window, so no step
        can read a slot it wrote itself. Step ``s`` sees the earlier
        steps' K/V as window slots ``< s`` (the query sits at
        ``past_len + s``). ``pfx``: shared-prefix groups as device
        tensors (``_pfx_up``)."""
        B = last.shape[0]
        L = self.mcfg.num_layers
        KD = self.mcfg.num_kv_heads * self.mcfg.head_dim
        # fused trailing axis, like the page pool (engine/kvcache.py)
        wk = torch.zeros((L, B, steps, KD), dtype=self.dtype, device=self.device)
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
            cur = sample(step_logits, fold_in(rng, step), **sampling)
            toks.append(cur)
            logps.append(cumulative_logprob(step_logits, cur))
        return torch.stack(toks), torch.stack(logps), wk, wv

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
        """Returns (tokens [steps, B], logprobs [steps, B])."""
        toks, logps = self.decode_multi_async(
            last_tokens, past_len, page_table, rng, temperature, top_p,
            steps, top_k=top_k, pfx=pfx,
        )
        return self._host(toks), self._host(logps)

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
        if faults.ACTIVE is not None:
            faults.inject("runner.decode")
        B = past_len.shape[0]
        last = self._up(last_tokens, torch.int32)
        past = self._up(past_len, torch.int32)
        table = self._up(page_table, torch.int32)
        sampling = self._sampling_args(temperature, top_p, top_k, B)
        toks, logps, wk, wv = self._window_scan(
            last, past, table, rng, sampling, steps, pfx=self._pfx_up(pfx)
        )
        write_kv(
            self.cache, wk, wv, table, past,
            torch.full((B,), steps, dtype=torch.int32, device=self.device),
        )
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
    # later slices
    # ------------------------------------------------------------------

    def decode_window(self, *args, **kwargs):
        raise NotImplementedError(CONSTRAINED_SLICE)

    def commit_window(self, *args, **kwargs):
        raise NotImplementedError(CONSTRAINED_SLICE)

    def verify_greedy(self, *args, **kwargs):
        raise NotImplementedError(CONSTRAINED_SLICE)

    def verify_candidates(self, *args, **kwargs):
        raise NotImplementedError(CONSTRAINED_SLICE)

    def embed_batch(self, rows: list) -> np.ndarray:
        raise NotImplementedError(
            "embeddings (embed_batch) are a later slice of the CUDA port "
            "(ROADMAP.md)"
        )
