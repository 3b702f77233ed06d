#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sutro_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the engine's main paths is compiled from
   ``sutro_tpu_torch/csrc/`` (five sources; the paged decode's bf16 and
   int8 entry points are one) with ``nvcc`` (one process per source,
   all started together); the compiler's register, shared-memory and
   spill report, and for flash prefill and paged decode the count of
   tensor-core (``HMMA``/``HGMMA``) and ``cp.async`` (``LDGSTS``)
   instructions in each function's SASS, are printed;
3. kernels: each kernel is held against its plain PyTorch version on
   random bfloat16 inputs, and timed beside its plain version, a
   one-call PyTorch yardstick where one exists and its bound (the least
   time the card could take): paged decode, the page write and flash
   prefill at Qwen3-8B shapes (NH=32, KVH=8, Dh=128, PS=64, B=64); the
   prefix carry and the paged decode with the carry at Qwen3-30B-A3B
   shapes (B=64, NH=32, KVH=4, 1,024-token shared prefix), the carry's
   yardstick being the memory-efficient SDPA with its log-sum-exp; the
   grouped GEMM at Qwen3-30B-A3B expert shapes (E=128, H=2048, F=768),
   including an lhs with rows past its last group, which must be zero;
   the paged decode's int8-page option at Qwen3-32B shapes (B=64,
   NH=64, KVH=8), with and without the carry, on the same quantized
   values as its plain version, the yardstick being SDPA over K/V
   gathered and dequantized to bf16 beforehand (twice the bytes); the
   bf16 and int8 paged decode also at long context (64 rows with pasts
   of 4,096-8,192, 130 pages a row) at Qwen3-8B's and Qwen3-32B's head
   counts, and flash prefill also at NH=64 (8 x 500) and at T=2,048
   (4 rows, NH=32 over KVH=4), each beside its bound and SDPA;
4. serve 1: ``ContinuousBatcher.run`` over a ``ModelRunner`` for
   ``qwen3-8b`` at full width and depth with random weights from a
   seed: 96 requests, greedy, top-p and row-seeded rows. Every row must
   finish with its full token count, every kernel of the path must
   have launched during this run, the run must take both the
   single-step and the fused-window decode paths, and prefill logits of
   4 rows must match a cache-free forward through the plain attention;
5. serve 2, after serve 1's runner is freed: a templated batch job on
   ``qwen3-30b-a3b`` (MoE, 128 experts) at full width and depth with
   ``prefix_split=True``: 96 requests sharing a 1,024-token template.
   Every row must finish, the grouped GEMM, the prefix carry, the
   carry-mode paged decode, the page write and flash prefill must have
   launched during this run, both decode paths must have run with
   prefix groups, prefill logits of three sets of 4 rows must match a
   cache-free forward through the plain attention and the plain grouped
   GEMM, a decode step of two sets of 8 rows over the shared pages must
   give the same layer-0 attention output (atol = rtol of the kernel
   phase) and the same logits with and without the prefix groups, and
   a fused window with the groups must not wait for the card
   (``torch.cuda.set_sync_debug_mode``);
6. serve 3, after serve 2's runner is freed: ``qwen3-32b`` at full
   width and depth with int8 weights and int8 KV pages: 88 requests of
   16-500 tokens and 8 of 1,200-1,900 (chunked prefill over an int8
   past). Every row must finish, the int8 paged decode and flash
   prefill must launch and the bf16 paged decode and page write must
   not, both decode paths must run, prefill logits of 4 rows must match
   a cache-free forward through the plain versions, layer 0's decode
   attention over the serve's int8 pool must match the plain version,
   and a fused window must not wait for the card.

The engines are ``sutro_tpu_torch.engine.stepprofile.ENGINES``, which
the step profile measures.

The second-to-last lines are a JSON ``{"kernels": [...]}`` record and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Nothing of JAX or of the JAX package
is imported. Exits with 2 and prints no result when no CUDA device is
available. ``python3 chip_smoke.py --kernels-only`` stops after phase 3
(and prints neither record).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and dense
# bf16 tensor-core rate, the denominators of every bound below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ATOL = RTOL = 2e-2  # bf16 output rounding of an f32-accumulated kernel
REL_L2 = 5e-2       # logits of a bf16 model against a plain-version forward
SLEEP_CYCLES = 40_000_000  # ~20 ms of device sleep before a timed run
ALPHABET = np.array(list("abcdefghijklmnopqrstuvwxyz ,.;:!?"))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    device sleeps while the host queues them, so a call whose host side
    outlasts its kernels (a small kernel behind a Python wrapper) is
    still timed on the device, not at the rate the host queues them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got, want) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{name}: max |err| {err} beyond atol=rtol={ATOL}")
    return err


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

NH, KVH, DH, PS, B = 32, 8, 128, 64, 64
MP = 32                      # max_pages_per_seq of the serve phase
NP = 1 + B * MP              # the serve phase's pool size
KD = KVH * DH
L = 36                       # qwen3-8b depth (page-write shapes)


def _decode_inputs(rng, torch, dev, nh=NH, mp=MP, past_range=(1, 2001), ragged=True):
    """``nh`` query heads over KVH=8 KV heads, ``mp`` pages per row.
    Ragged rows: past in ``past_range``, some past=0 rows, page-0
    padding rows; with ``ragged`` false every row is in ``past_range``."""
    past = rng.integers(*past_range, B)
    if ragged:
        past[::9] = 0                    # rows at their first decode step
        pad = np.zeros(B, bool)
        pad[5::16] = True                # inactive slots: zero table, past 0
        past[pad] = 0
    n_pool = 1 + B * mp
    table = np.zeros((B, mp), np.int32)
    perm = rng.permutation(np.arange(1, n_pool))
    nxt = 0
    for b in range(B):
        n = -(-int(past[b]) // PS)
        table[b, :n] = perm[nxt : nxt + n]
        nxt += n
    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    return dict(
        q=torch.randn((B, nh, DH), generator=g, **bf),
        k_pages=torch.randn((n_pool, PS, KD), generator=g, **bf),
        v_pages=torch.randn((n_pool, PS, KD), generator=g, **bf),
        page_table=torch.as_tensor(table, device=dev),
        past_len=torch.as_tensor(past.astype(np.int32), device=dev),
        k_cur=torch.randn((B, KVH, DH), generator=g, **bf),
        v_cur=torch.randn((B, KVH, DH), generator=g, **bf),
        win_k=torch.randn((B, 8, KD), generator=g, **bf),
        win_v=torch.randn((B, 8, KD), generator=g, **bf),
        sink=torch.randn((nh,), generator=g, device=dev),
    )


def _sdpa_over_gathered(torch, x, k_pages, v_pages, win_len):
    """Yardstick of a paged decode call: SDPA over K/V already gathered
    (and, for int8 pages, dequantized to bf16) into [B, KVH, S, Dh]
    with a key-validity mask; building them is not timed."""
    import torch.nn.functional as F

    past = x["past_len"].long()
    dev = past.device
    ctx = x["page_table"].shape[1] * PS
    W = x["win_k"].shape[1]
    idx = x["page_table"].long().reshape(-1)
    kg = k_pages[idx].reshape(B, ctx, KVH, DH)
    vg = v_pages[idx].reshape(B, ctx, KVH, DH)
    keys = torch.cat([kg, x["win_k"].reshape(B, W, KVH, DH), x["k_cur"][:, None]], 1)
    vals = torch.cat([vg, x["win_v"].reshape(B, W, KVH, DH), x["v_cur"][:, None]], 1)
    keys, vals = keys.transpose(1, 2).contiguous(), vals.transpose(1, 2).contiguous()
    tok = torch.arange(ctx, device=dev)
    slot = torch.arange(W, device=dev)
    mask = torch.cat([tok[None] < past[:, None], (slot < win_len)[None].expand(B, W),
                      torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    mask = mask[:, None, None, :]
    qs = x["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, keys, vals, attn_mask=mask,
                                                  enable_gqa=True)


def _decode_bound(x, nh, win_len, int8=False):
    """The least time of a paged decode call: every live token's K and V
    row once (int8 pages: 1 byte an element and two f32 scales a token;
    the window slots and the current token in bf16), q in, out back, the
    table and lengths; 4 flops per (query head, key, Dh)."""
    n_rows, mp = x["page_table"].shape
    page_tokens = int(x["past_len"].long().sum())
    other = n_rows * (win_len + 1)
    if int8:
        kv = 2 * page_tokens * (KD + 4) + 2 * other * KD * 2
    else:
        kv = 2 * (page_tokens + other) * KD * 2
    nbytes = kv + 2 * n_rows * nh * DH * 2 + n_rows * mp * 4 + n_rows * 4
    return bound_ms(nbytes, 4 * (page_tokens + other) * nh * DH)


def _dequantized_pools(torch, x):
    """bf16 pools holding the int8 pages' dequantized values on the
    table's pages (the SDPA yardstick's input; not timed)."""
    idx = x["page_table"].long().reshape(-1)
    out = []
    for name in ("k", "v"):
        pool = torch.zeros(x[f"{name}_pages"].shape, dtype=torch.bfloat16,
                           device=idx.device)
        pool[idx] = (x[f"{name}_pages"][idx].float()
                     * x[f"{name}_scale"][idx][..., None]).to(torch.bfloat16)
        out.append(pool)
    return out


LONG_MP = 130   # 8,320 tokens a row: pasts of 4,096-8,192 and the window


def paged_decode_long(rng, torch, dev, nh, int8) -> dict:
    """The paged decode at long context, where split-K matters: 64 rows
    with pasts of 4,096-8,192 over a table of 130 pages, ``nh`` query
    heads over 8 KV heads, inside a fused window (4 slots); held against
    the plain version and timed beside its bound and the SDPA yardstick
    (over K/V gathered, and for int8 pages dequantized, beforehand)."""
    from sutro_tpu_torch.ops import paged_decode as pd

    x = _decode_inputs(rng, torch, dev, nh=nh, mp=LONG_MP, past_range=(4096, 8193),
                       ragged=False)
    scales = {}
    if int8:
        x = _int8_pools(torch, x)
        scales = dict(k_scale=x["k_scale"], v_scale=x["v_scale"])
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    kw = dict(window=0, win_k=x["win_k"], win_v=x["win_v"], win_len=4, **scales)
    err = check_close(f"paged_decode long context nh={nh} int8={int8}",
                      pd.paged_decode_attention(*base, **kw), pd.paged_decode_plain(*base, **kw))
    ms = time_ms(lambda: pd.paged_decode_attention(*base, **kw))
    pools = _dequantized_pools(torch, x) if int8 else (x["k_pages"], x["v_pages"])
    library_ms = time_ms(_sdpa_over_gathered(torch, x, *pools, 4))
    bms, by = _decode_bound(x, nh, 4, int8)
    del pools, x
    return dict(ms=ms, library_ms=library_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                nh=nh, past="4096-8192")


def _rec(kernel, **kw) -> dict:
    return dict(kernel=kernel, name=kernel.name, **kw)


def kernel_paged_decode(rng, torch, dev) -> dict:
    from sutro_tpu_torch.ops import paged_decode as pd

    x = _decode_inputs(rng, torch, dev)
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    cases = {
        "window0_slots8": dict(window=0, win_k=x["win_k"], win_v=x["win_v"], win_len=5),
        "window500_sink_slots8": dict(window=500, sink=x["sink"], win_k=x["win_k"],
                                      win_v=x["win_v"], win_len=3),
        "window0_no_slots": dict(window=0),
        "window100_sink_no_slots": dict(window=100, sink=x["sink"]),
    }
    errs = {}
    for name, kw in cases.items():
        got = pd.paged_decode_attention(*base, **kw)
        want = pd.paged_decode_plain(*base, **kw)
        torch.cuda.synchronize()
        errs[name] = check_close(f"paged_decode[{name}]", got, want)
    # the main path's call: qwen3-8b (no window, no sink) inside a window
    main = dict(window=0, win_k=x["win_k"], win_v=x["win_v"], win_len=4)
    ms = time_ms(lambda: pd.paged_decode_attention(*base, **main))
    plain_ms = time_ms(lambda: pd.paged_decode_plain(*base, **main), iters=5)
    # yardstick: SDPA over K/V already gathered into [B, KVH, S, Dh]
    # (the gather itself is not timed), with a key-validity mask
    library_ms = time_ms(_sdpa_over_gathered(torch, x, x["k_pages"], x["v_pages"], 4))
    bms, by = _decode_bound(x, NH, 4)
    del x, base
    torch.cuda.empty_cache()
    timed = {f"long_context_nh{nh}": paged_decode_long(rng, torch, dev, nh, False)
             for nh in (NH, Q32_NH)}
    return _rec(pd.KERNEL, max_abs_err=max([*errs.values(),
                                            *(t["max_abs_err"] for t in timed.values())]),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                cases=errs, timed_cases=timed)


def kernel_kv_write(rng, torch, dev) -> dict:
    from sutro_tpu_torch.ops import kv_write as kw

    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    k_pages = torch.randn((L, NP, PS, KD), generator=g, **bf)
    v_pages = torch.randn((L, NP, PS, KD), generator=g, **bf)
    errs = {}

    def case(name, Bc, Tb, start, valid, table):
        k_new = torch.randn((L, Bc, Tb, KD), generator=g, **bf)
        v_new = torch.randn((L, Bc, Tb, KD), generator=g, **bf)
        args = (k_new, v_new, torch.as_tensor(table, device=dev),
                torch.as_tensor(start.astype(np.int32), device=dev),
                torch.as_tensor(valid.astype(np.int32), device=dev))
        kp_k, vp_k = k_pages.clone(), v_pages.clone()
        kp_p, vp_p = k_pages.clone(), v_pages.clone()
        kw.kv_write(kp_k, vp_k, *args)
        kw.kv_write_plain(kp_p, vp_p, *args)
        torch.cuda.synchronize()
        same = torch.equal(kp_k[:, 1:], kp_p[:, 1:]) and torch.equal(vp_k[:, 1:], vp_p[:, 1:])
        if not same:
            raise AssertionError(f"kv_write[{name}]: pages >= 1 differ from the plain version")
        errs[name] = 0.0
        del kp_k, vp_k, kp_p, vp_p
        return args

    # decode window commit: 64 slots x 8 steps at ragged offsets, some
    # inactive slots (zero table)
    past = rng.integers(0, MP * PS - 8, B)
    table = np.zeros((B, MP), np.int32)
    perm = rng.permutation(np.arange(1, NP))
    for b in range(B):
        table[b] = perm[b * MP : (b + 1) * MP]
    table[3::11] = 0
    win_args = case("decode_window", B, 8, past, np.full(B, 8), table)
    # prefill chunk: 8 rows of up to 512 tokens, padded tails, one
    # padding row (valid_len 0)
    valid = rng.integers(16, 513, 8)
    valid[-1] = 0
    case("prefill", 8, 512, np.zeros(8, np.int64), valid, table[:8])

    ms = time_ms(lambda: kw.kv_write(k_pages, v_pages, *win_args))
    plain_ms = time_ms(lambda: kw.kv_write_plain(k_pages, v_pages, *win_args), iters=5)
    # yardstick: index_copy_ into the flat pool with precomputed slots
    k_new, v_new, tab, st, vl = win_args
    t = torch.arange(8, device=dev)
    pos = st.long()[:, None] + t[None]
    page = tab.long().gather(1, pos // PS)
    ok = page > 0
    flat = (page * PS + pos % PS)[ok]
    src_k = k_new[:, ok]
    src_v = v_new[:, ok]
    kf = k_pages.view(L, NP * PS, KD)
    vf = v_pages.view(L, NP * PS, KD)

    def library():
        kf.index_copy_(1, flat, src_k)
        vf.index_copy_(1, flat, src_v)

    library_ms = time_ms(library)
    n_tok = int(ok.sum())
    nbytes = 2 * L * n_tok * KD * 2 * 2 + B * (MP + 2) * 4
    bms, by = bound_ms(nbytes, 0.0)
    del k_pages, v_pages, kf, vf
    return _rec(kw.KERNEL, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms, cases=errs)


def kernel_flash_prefill(rng, torch, dev) -> dict:
    import torch.nn.functional as F
    from sutro_tpu_torch.ops import flash_prefill as fp

    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def inputs(Bc, T, nh=NH, kvh=KVH):
        return (torch.randn((Bc, T, nh, DH), generator=g, **bf),
                torch.randn((Bc, T, kvh, DH), generator=g, **bf),
                torch.randn((Bc, T, kvh, DH), generator=g, **bf))

    def timed(args):
        """The kernel's time beside SDPA's (causal, same inputs) and the
        bound: q, k, v in and out back once; 4 flops per causal (query,
        key) pair, head and column."""
        q, k, v = (t.transpose(1, 2).contiguous() for t in args)
        Bc, T, nh = args[0].shape[:3]
        kvh = args[1].shape[2]
        nbytes = 2 * Bc * T * nh * DH * 2 + 2 * Bc * T * kvh * DH * 2
        bms, by = bound_ms(nbytes, 4 * Bc * T * (T + 1) / 2 * nh * DH)
        return dict(ms=time_ms(lambda: fp.flash_prefill(*args)),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)),
                    bound_ms=bms, bound_by=by, shape=[Bc, T, nh, kvh, DH])

    sink = torch.randn((NH,), generator=g, device=dev)
    errs = {}
    main = inputs(8, 500)   # the serve phase's prefill batch: 8 rows, T <= 500
    for name, (args, kw) in {
        "T500_full": (main, {}),
        "T1024_window128_sink": (inputs(2, 1024), dict(window=128, sink=sink)),
        "T77_sink": (inputs(3, 77), dict(sink=sink)),
    }.items():
        got = fp.flash_prefill(*args, **kw)
        want = fp.flash_prefill_plain(*args, **kw)
        torch.cuda.synchronize()
        errs[name] = check_close(f"flash_prefill[{name}]", got, want)
    plain_ms = time_ms(lambda: fp.flash_prefill_plain(*main), iters=5)
    m = timed(main)
    # qwen3-32b's heads (NH=64 over 8) at the serve's 8 x 500, and serve
    # 2's prefill_chunk of 2,048 tokens at qwen3-30b-a3b's heads (32 over 4)
    more = {"T500_nh64": inputs(8, 500, nh=Q32_NH), "T2048_nh32_kvh4": inputs(4, 2048, kvh=QKVH)}
    timed_cases = {}
    for name, args in more.items():
        errs[name] = check_close(f"flash_prefill[{name}]", fp.flash_prefill(*args),
                                 fp.flash_prefill_plain(*args))
        timed_cases[name] = timed(args)
    del more
    return _rec(fp.KERNEL, max_abs_err=max(errs.values()), ms=m["ms"],
                plain_ms=plain_ms, bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                library_ms=m["library_ms"], cases=errs, timed_cases=timed_cases)


# Qwen3-30B-A3B serve shapes (serve 2): B=64 slots of 24 pages, a
# 1,024-token (16-page) shared template, top-8 of 128 experts
QB, QNH, QKVH, QMP = 64, 32, 4, 24
QNP = 1 + QB * QMP
QKD = QKVH * DH
N_PFX = 16
GE, GH, GF, TOPK = 128, 2048, 768, 8


def _prefix_inputs(rng, torch, dev, nh=QNH, kvh=QKVH, mp=QMP):
    """Rows 0..63 of a templated batch: members' tables start with the
    16 shared pages, every 8th row is outside the group (a short
    untemplated row, so that, as in the serve, no row walks more than
    ~320 tokens of its own); each member has decoded into its own pages
    past the template and its suffix. Qwen3-30B-A3B's heads and pages
    unless ``nh``/``kvh``/``mp`` say otherwise."""
    n_pool, kd = 1 + QB * mp, kvh * DH
    member = np.ones(QB, bool)
    member[7::8] = False
    past = N_PFX * PS + rng.integers(16, 257, QB) + rng.integers(0, 57, QB)
    past[~member] = rng.integers(16, 321, int((~member).sum()))
    table = np.zeros((QB, mp), np.int32)
    perm = rng.permutation(np.arange(1 + N_PFX, n_pool))
    nxt = 0
    for b in range(QB):
        head = N_PFX if member[b] else 0
        if head:
            table[b, :head] = np.arange(1, 1 + N_PFX)
        n = -(-int(past[b]) // PS) - head
        table[b, head : head + n] = perm[nxt : nxt + n]
        nxt += n
    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    win_len = 4
    return dict(
        q=torch.randn((QB, nh, DH), generator=g, **bf),
        k_pages=torch.randn((n_pool, PS, kd), generator=g, **bf),
        v_pages=torch.randn((n_pool, PS, kd), generator=g, **bf),
        page_table=i32(table), past_len=i32(past),
        k_cur=torch.randn((QB, kvh, DH), generator=g, **bf),
        v_cur=torch.randn((QB, kvh, DH), generator=g, **bf),
        win_k=torch.randn((QB, 8, kd), generator=g, **bf),
        win_v=torch.randn((QB, 8, kd), generator=g, **bf),
        win_len=win_len,
        pages=i32(np.arange(1, 1 + N_PFX)),
        pfx_len=i32(np.where(member, N_PFX * PS, 0)),
        pfx_cnt=i32(np.where(member, N_PFX, 0)),
        q_pos=i32(past + win_len),
        member=member, past=past,
    )


def kernel_prefix_split(rng, torch, dev) -> list:
    """The prefix carry, and the paged decode started from it, against
    their plain versions: the carry kernel plus the decode kernel with
    pfx_cnt must equal the plain decode over the full table."""
    from sutro_tpu_torch.ops import paged_decode as pd
    from sutro_tpu_torch.ops import prefix_carry as pc

    x = _prefix_inputs(rng, torch, dev)
    pool = (x["q"], x["k_pages"], x["v_pages"])
    padded = torch.cat([x["pages"], torch.zeros_like(x["pages"])])  # page-0 padding
    carry_errs, dec_errs = {}, {}
    carries = {}
    for name, pages, window in (("window0", x["pages"], 0),
                                ("window600_cuts_prefix", x["pages"], 600),
                                ("padded_pages", padded, 0)):
        args = (*pool, pages, x["pfx_len"], x["q_pos"], window)
        got = pc.prefix_attention_carry(*args)
        want = pc.prefix_attention_carry_plain(*args)
        torch.cuda.synchronize()
        live = want[1] > 0   # m matters only where a key was in range
        carry_errs[name] = max(check_close(f"prefix_carry[{name}].m", got[0][live],
                                           want[0][live]),
                               check_close(f"prefix_carry[{name}].l", got[1], want[1]),
                               check_close(f"prefix_carry[{name}].acc", got[2], want[2]))
        if (got[1][~torch.as_tensor(x["member"], device=dev)] != 0).any():
            raise AssertionError(f"prefix_carry[{name}]: a row outside the group got a carry")
        carries[name] = (got, window)
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    win = dict(win_k=x["win_k"], win_v=x["win_v"], win_len=x["win_len"])
    for name in ("window0", "window600_cuts_prefix"):
        (m0, l0, acc0), window = carries[name]
        got = pd.paged_decode_attention(*base, window, **win, pfx_cnt=x["pfx_cnt"],
                                        m0=m0, l0=l0, acc0=acc0)
        want = pd.paged_decode_plain(*base, window, **win)
        torch.cuda.synchronize()
        dec_errs[name] = check_close(f"paged_decode_carry[{name}]", got, want)

    (m0, l0, acc0), _ = carries["window0"]
    carry_args = (*pool, x["pages"], x["pfx_len"], x["q_pos"], 0)
    dec_kw = dict(**win, pfx_cnt=x["pfx_cnt"], m0=m0, l0=l0, acc0=acc0)
    ms_c = time_ms(lambda: pc.prefix_attention_carry(*carry_args))
    plain_c = time_ms(lambda: pc.prefix_attention_carry_plain(*carry_args), iters=5)
    ms_d = time_ms(lambda: pd.paged_decode_attention(*base, 0, **dec_kw))
    plain_d = time_ms(lambda: pd.paged_decode_plain(*base, 0, **dec_kw), iters=5)

    def split_pair():
        m, l_, a = pc.prefix_attention_carry(*carry_args)
        pd.paged_decode_attention(*base, 0, **win, pfx_cnt=x["pfx_cnt"], m0=m, l0=l_,
                                  acc0=a)

    pair_ms = time_ms(split_pair)
    full_ms = time_ms(lambda: pd.paged_decode_attention(*base, 0, **win))
    library, lib_err = _library_carry(torch, x, pc.prefix_attention_carry_plain(*carry_args))
    carry_errs["library_sdpa_vs_plain"] = lib_err
    library_ms = time_ms(library)
    # bounds: the carry reads the shared K/V rows once and q, writes
    # m/l/acc; 4 flops per (query head, key, Dh) (q.k and p.v)
    member = x["member"]
    n_member = int(member.sum())
    pfx_tokens = N_PFX * PS
    nbytes = (QB * QNH * DH * 2 + 2 * pfx_tokens * QKD * 2 + N_PFX * 4 + 2 * QB * 4
              + QB * QNH * (2 * 4 + DH * 4))
    flops = 4 * n_member * pfx_tokens * QNH * DH
    bc, byc = bound_ms(nbytes, flops)
    # the decode with the carry: each row's own K/V rows (past the
    # prefix), the window slots and current token, q and the carry in,
    # out back
    own = int(np.where(member, x["past"] - pfx_tokens, x["past"]).sum())
    live = own + QB * (x["win_len"] + 1)
    nbytes = (2 * live * QKD * 2 + 2 * QB * QNH * DH * 2 + QB * QNH * (2 * 4 + DH * 4)
              + QB * QMP * 4 + 2 * QB * 4)
    bd, byd = bound_ms(nbytes, 4 * live * QNH * DH)
    return [
        _rec(pc.KERNEL, max_abs_err=max(v for k, v in carry_errs.items()
                                        if not k.startswith("library")),
             ms=ms_c, plain_ms=plain_c, bound_ms=bc, bound_by=byc, library_ms=library_ms,
             cases=carry_errs,
             library="aten._scaled_dot_product_efficient_attention with its log-sum-exp"),
        _rec(pd.CARRY, max_abs_err=max(dec_errs.values()), ms=ms_d, plain_ms=plain_d,
             bound_ms=bd, bound_by=byd, library_ms=None, cases=dec_errs,
             split_pair_ms=pair_ms, full_table_ms=full_ms),
    ]


# Qwen3-32B decode shapes (serve 3): NH=64 over KVH=8, Dh=128, the
# qwen3-8b pool's 64-token pages and 32 pages per row, int8 pages
Q32_NH = 64


def _int8_pools(torch, x):
    """The bf16 pools of ``x`` quantized per token, as the int8 KV write
    does; the bf16 ones are dropped."""
    from sutro_tpu_torch.engine.kvcache import _quantize_tokens

    for name in ("k", "v"):
        q, sc = _quantize_tokens(x.pop(f"{name}_pages"))
        x[f"{name}_pages"], x[f"{name}_scale"] = q, sc
    return x


def kernel_paged_decode_int8(rng, torch, dev) -> dict:
    """The int8-page option at Qwen3-32B decode shapes, held against the
    plain version on the same quantized values: windows, sink, slots,
    and the carry option (its carry from the plain int8 prefix carry,
    against the plain decode over the full table)."""
    from sutro_tpu_torch.ops import paged_decode as pd
    from sutro_tpu_torch.ops import prefix_carry as pc

    x = _int8_pools(torch, _decode_inputs(rng, torch, dev, nh=Q32_NH))
    scales = dict(k_scale=x["k_scale"], v_scale=x["v_scale"])
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    cases = {
        "window0_slots8": dict(window=0, win_k=x["win_k"], win_v=x["win_v"], win_len=5),
        "window500_sink_slots8": dict(window=500, sink=x["sink"], win_k=x["win_k"],
                                      win_v=x["win_v"], win_len=3),
        "window0_no_slots": dict(window=0),
        "window100_sink_no_slots": dict(window=100, sink=x["sink"]),
    }
    errs = {}
    for name, kw in cases.items():
        got = pd.paged_decode_attention(*base, **kw, **scales)
        want = pd.paged_decode_plain(*base, **kw, **scales)
        torch.cuda.synchronize()
        errs[name] = check_close(f"paged_decode_int8[{name}]", got, want)
    # with the carry: 56 of 64 rows share a 1,024-token template
    y = _int8_pools(torch, _prefix_inputs(rng, torch, dev, nh=Q32_NH, kvh=KVH, mp=MP))
    ys = dict(k_scale=y["k_scale"], v_scale=y["v_scale"])
    ybase = (y["q"], y["k_pages"], y["v_pages"], y["page_table"], y["past_len"],
             y["k_cur"], y["v_cur"])
    ywin = dict(win_k=y["win_k"], win_v=y["win_v"], win_len=y["win_len"])
    for name, window in (("carry_window0", 0), ("carry_window600_cuts_prefix", 600)):
        m0, l0, acc0 = pc.prefix_attention_carry(
            y["q"], y["k_pages"], y["v_pages"], y["pages"], y["pfx_len"], y["q_pos"],
            window, **ys)
        got = pd.paged_decode_attention(*ybase, window, **ywin, pfx_cnt=y["pfx_cnt"], m0=m0,
                                        l0=l0, acc0=acc0, **ys)
        want = pd.paged_decode_plain(*ybase, window, **ywin, **ys)
        torch.cuda.synchronize()
        errs[name] = check_close(f"paged_decode_int8[{name}]", got, want)
    del y
    # the main path's call: qwen3-32b (no window, no sink) inside a window
    main = dict(window=0, win_k=x["win_k"], win_v=x["win_v"], win_len=4, **scales)
    ms = time_ms(lambda: pd.paged_decode_attention(*base, **main))
    plain_ms = time_ms(lambda: pd.paged_decode_plain(*base, **main), iters=5)
    # yardstick: SDPA over K/V gathered and dequantized to bf16 outside
    # the timed region; it reads 2 bytes per K/V element, twice the
    # kernel's 1
    deq = _dequantized_pools(torch, x)
    library_ms = time_ms(_sdpa_over_gathered(torch, x, *deq, 4))
    del deq
    bms, by = _decode_bound(x, Q32_NH, 4, int8=True)
    del x, base
    torch.cuda.empty_cache()
    timed = {f"long_context_nh{nh}": paged_decode_long(rng, torch, dev, nh, True)
             for nh in (NH, Q32_NH)}
    return _rec(pd.INT8, max_abs_err=max([*errs.values(),
                                          *(t["max_abs_err"] for t in timed.values())]),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                cases=errs, timed_cases=timed,
                library="SDPA over K/V gathered and dequantized to bf16 beforehand "
                        "(reads 2x the kernel's K/V bytes)")


def _library_carry(torch, x, want):
    """One PyTorch call for the prefix carry at window 0: the
    memory-efficient SDPA with its log-sum-exp over the template's K/V
    gathered into [1, KVH, S, Dh] (the gather is not timed), each KV
    head's B x G queries as its rows and the length mask as an additive
    bias. (lse, 1, out) is the same carry as (m, l, acc / l) up to the
    free choice of m. Held against the plain carry ``want`` on the
    member rows; returns (callable, max |err|)."""
    q = x["q"]
    G = QNH // QKVH
    S = N_PFX * PS
    idx = x["pages"].long()

    def heads_first(pool):   # [1, KVH, S, Dh]
        return pool[idx].reshape(S, QKVH, DH).transpose(0, 1)[None].contiguous()

    kg, vg = heads_first(x["k_pages"]), heads_first(x["v_pages"])
    qs = q.reshape(QB, QKVH, G, DH).transpose(0, 1).reshape(1, QKVH, QB * G, DH).contiguous()
    ok = torch.arange(S, device=q.device)[None] < x["pfx_len"].long()[:, None]   # [B, S]
    bias = torch.zeros(ok.shape, dtype=torch.bfloat16, device=q.device).masked_fill(~ok, -1e30)
    bias = bias.repeat_interleave(G, 0)[None, None].expand(1, QKVH, QB * G, S).contiguous()

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(qs, kg, vg, bias, True)

    out, lse = library()[:2]
    torch.cuda.synchronize()
    out = out[0].reshape(QKVH, QB, G, DH).transpose(0, 1).reshape(QB, QNH, DH)
    lse = lse[0, :, : QB * G].reshape(QKVH, QB, G).transpose(0, 1).reshape(QB, QNH)
    m, l_, acc = want
    rows = torch.as_tensor(x["member"], device=q.device)
    err = max(check_close("prefix_carry library: out", out[rows], (acc / l_[..., None])[rows]),
              check_close("prefix_carry library: lse", lse[rows], (m + l_.log())[rows]))
    return library, err


def _library_grouped_mm(torch, lhs, rhs, sizes):
    """One PyTorch call for the grouped GEMM: ``torch._grouped_mm``
    where this PyTorch has it for bf16 on the card (checked against the
    plain loop), else ``torch.bmm`` over groups padded to the largest
    (the padding copy is not timed). Returns (callable, its name)."""
    from sutro_tpu_torch.ops.grouped_matmul import grouped_matmul_plain

    gs = torch.as_tensor(np.asarray(sizes, np.int32), device=lhs.device)
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0).to(torch.int32)
        want = grouped_matmul_plain(lhs, rhs, gs).float()
        col_major = rhs.transpose(-2, -1).contiguous().transpose(-2, -1)
        for b in (rhs, col_major):
            try:
                out = torch._grouped_mm(lhs, b, offs=offs, out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError):
                continue
            if torch.allclose(out.float(), want, atol=ATOL, rtol=RTOL):
                return (lambda: torch._grouped_mm(lhs, b, offs=offs,
                                                  out_dtype=torch.bfloat16),
                        "torch._grouped_mm")
    E = rhs.shape[0]
    width = max(max(sizes), 1)
    pad = torch.zeros((E, width, lhs.shape[1]), dtype=lhs.dtype, device=lhs.device)
    start = 0
    for e, n in enumerate(sizes):
        pad[e, :n] = lhs[start : start + n]
        start += n
    return (lambda: torch.bmm(pad, rhs)), "torch.bmm over groups padded to the largest"


def kernel_grouped_matmul(rng, torch, dev) -> dict:
    """Expert GEMMs at Qwen3-30B-A3B shapes: a decode step's 512
    (token, expert) rows routed by a random router, a 4,096-token
    prefill's 32,768, one empty group and one hot expert, for the
    gate/up (H -> F) and the down (F -> H) projections."""
    from sutro_tpu_torch.ops import grouped_matmul as gm

    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    router = torch.randn((GH, GE), generator=g, device=dev) * GH ** -0.5

    def routed(n_tokens, empty=None):
        logits = torch.randn((n_tokens, GH), generator=g, device=dev) @ router
        if empty is not None:
            logits[:, empty] = float("-inf")
        idx = torch.topk(logits, TOPK, dim=-1).indices.reshape(-1)
        return torch.bincount(idx, minlength=GE).tolist()

    w_up = torch.randn((GE, GH, GF), generator=g, **bf) * GH ** -0.5
    w_down = torch.randn((GE, GF, GH), generator=g, **bf) * GF ** -0.5
    hot = [0] * GE
    hot[GE // 3] = 512
    cases = {   # name: (group sizes, weights, lhs rows past the last group)
        "decode_M512_gate": (routed(64), w_up, 0),
        "decode_M512_down": (routed(64), w_down, 0),
        "prefill_M32768_gate": (routed(4096), w_up, 0),
        "prefill_M32768_down": (routed(4096), w_down, 0),
        "empty_group_M512": (routed(64, empty=5), w_up, 0),
        "hot_expert_M512": (hot, w_up, 0),
        "rows_past_groups_M512": (routed(40), w_down, 192),
    }
    if cases["empty_group_M512"][0][5] != 0:
        raise AssertionError("grouped_matmul: the empty-group case has no empty group")
    errs, timed = {}, {}
    for name, (sizes, rhs, pad) in cases.items():
        lhs = torch.randn((sum(sizes) + pad, rhs.shape[1]), generator=g, **bf)
        gs = torch.as_tensor(np.asarray(sizes, np.int32), device=dev)
        got = gm.grouped_matmul(lhs, rhs, gs)
        want = gm.grouped_matmul_plain(lhs, rhs, gs)
        torch.cuda.synchronize()
        errs[name] = check_close(f"grouped_matmul[{name}]", got, want)
        if pad and got[sum(sizes):].any():
            raise AssertionError(f"grouped_matmul[{name}]: rows past the groups are not zero")
        if name.startswith(("decode", "prefill")):
            M, K = lhs.shape
            N = rhs.shape[2]
            used = sum(1 for n in sizes if n)
            nbytes = M * K * 2 + used * K * N * 2 + M * N * 2 + GE * 4
            bms, by = bound_ms(nbytes, 2 * M * K * N)
            lib, lib_name = _library_grouped_mm(torch, lhs, rhs, sizes)
            timed[name] = dict(
                ms=time_ms(lambda: gm.grouped_matmul(lhs, rhs, gs)),
                plain_ms=time_ms(lambda: gm.grouped_matmul_plain(lhs, rhs, gs), iters=3,
                                 warmup=1),
                library_ms=time_ms(lib), library=lib_name, bound_ms=bms, bound_by=by,
                experts_used=used,
            )
        del lhs, got, want
    main = timed["decode_M512_gate"]   # a decode step's gate/up call
    return _rec(gm.KERNEL, max_abs_err=max(errs.values()), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"], cases=errs,
                library=main["library"], timed_cases=timed)


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the no-past attention and the expert GEMMs through their
    plain versions (for the cache-free reference forward)."""
    from sutro_tpu_torch.ops import attention, flash_prefill, grouped_matmul, moe

    saved = attention.flash_prefill, moe.grouped_matmul
    attention.flash_prefill = flash_prefill.flash_prefill_plain
    moe.grouped_matmul = grouped_matmul.grouped_matmul_plain
    try:
        yield
    finally:
        attention.flash_prefill, moe.grouped_matmul = saved


def check_prefill_logits(torch, runner, rows, label: str) -> float:
    """Prefill logits of ``rows`` (batched, through the kernels, into
    pages 1.. of the pool) against a cache-free forward of each row
    through the plain versions. Returns the relative L2 error."""
    from sutro_tpu_torch.engine.kvcache import make_page_table, pages_needed
    from sutro_tpu_torch.models import transformer

    ecfg, mcfg = runner.ecfg, runner.mcfg
    pages, nxt = [], 1
    for r in rows:
        n = pages_needed(len(r), ecfg.kv_page_size)
        pages.append(list(range(nxt, nxt + n)))
        nxt += n
    got = runner.prefill_batch(rows, make_page_table(pages, ecfg.max_pages_per_seq))
    ref = []
    with plain_kernels(), torch.no_grad():
        for r in rows:
            ids = torch.as_tensor(r[None], device=runner.device)
            pos = torch.arange(len(r), device=runner.device)[None]
            lg, _, _ = transformer.forward(
                mcfg, runner.params, ids, pos,
                torch.as_tensor([len(r)], device=runner.device),
                head_index=torch.as_tensor([len(r) - 1], device=runner.device),
            )
            ref.append(lg[0, 0].float().cpu().numpy())
    ref = np.stack(ref)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    print(f"{label}: prefill logits vs cache-free plain forward: rel_l2={rel:.3e} "
          f"argmax_agree={agree}/{len(rows)} max_abs={float(np.abs(got - ref).max()):.3e}",
          flush=True)
    # bf16 weights/activations through the whole depth: a relative L2
    # error of a few 1e-3 is rounding; a wrong mask, page or expert
    # would be O(1)
    if not (np.isfinite(got).all() and rel < REL_L2):
        raise AssertionError(f"{label}: prefill logits disagree with the plain forward: "
                             f"rel_l2={rel}")
    return rel


def count_decode_calls(runner, calls: dict) -> None:
    """Count the runner's two decode entry points, and those calls that
    carried shared-prefix groups."""
    for name in ("decode_step", "decode_multi_async"):
        calls.setdefault(name, 0)
        calls.setdefault(name + "_with_groups", 0)

        def counted(*a, _fn=getattr(runner, name), _name=name, **k):
            calls[_name] += 1
            calls[_name + "_with_groups"] += bool(k.get("pfx"))
            return _fn(*a, **k)
        setattr(runner, name, counted)


def run_batch(torch, runner, requests, kernels, seed: int, absent=()):
    """``ContinuousBatcher.run`` with every launch counter at 0 just
    before it; returns (results, launches during the run, timer, wall).
    Every kernel of ``kernels`` must launch in the run, and none of
    ``absent`` (a route the path must not take)."""
    from sutro_tpu_torch.engine.scheduler import ContinuousBatcher

    for k in (*kernels, *absent):
        k.launches = 0
    results = {}
    batcher = ContinuousBatcher(runner, stop_ids=[], seed=seed)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = batcher.run(requests, on_result=lambda r: results.__setitem__(r.row_id, r))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k.name: k.launches for k in (*kernels, *absent)}
    if state != "completed" or len(results) != len(requests):
        raise AssertionError(f"run ended {state!r} with {len(results)}/{len(requests)} rows")
    for r in results.values():
        if r.error or r.finish_reason != "length" or len(r.token_ids) != 64:
            raise AssertionError(
                f"row {r.row_id}: {r.finish_reason!r} {len(r.token_ids)} tokens {r.error!r}")
        if not all(0 <= t < runner.mcfg.vocab_size for t in r.token_ids):
            raise AssertionError(f"row {r.row_id}: token id out of range")
        if not math.isfinite(r.cumulative_logprob):
            raise AssertionError(f"row {r.row_id}: non-finite logprob")
    for k in kernels:
        if launches[k.name] <= 0:
            raise AssertionError(f"kernel {k.name} was not launched on the main path")
    for k in absent:
        if launches[k.name]:
            raise AssertionError(f"kernel {k.name} launched {launches[k.name]} times on a "
                                 "path that must not take it")
    return results, launches, batcher.timer.summary(), wall


def mixed_requests(prompts, n_new: int = 64):
    """3 in 4 greedy, 1 in 4 top-p; the three row-seeded rows get the
    three shortest prompts: admission is shortest-first, so they ride
    the first wave of slots, which then decodes one step at a time (a
    seeded row needs its own draw), and the later waves take the
    pipelined fused windows."""
    from sutro_tpu_torch.engine.scheduler import GenRequest

    seeded = set(np.argsort([len(p) for p in prompts], kind="stable")[:3].tolist())
    requests = []
    for i, p in enumerate(prompts):
        if i in seeded:
            kw = dict(temperature=0.7, top_p=0.95, row_seed=1000 + i)
        elif i % 8 in (1, 5):
            kw = dict(temperature=0.8, top_p=0.9)          # nucleus rows
        else:
            kw = dict(temperature=0.0)                     # greedy rows
        requests.append(GenRequest(row_id=i, prompt_ids=p, max_new_tokens=n_new, **kw))
    return requests


def serve_summary(prompts, n_new, results, launches, calls, timer, wall, rel) -> dict:
    n_prompt = int(sum(len(p) for p in prompts))
    n_gen = n_new * len(results)
    pre_s = timer.get("prefill", {}).get("total_s", float("nan"))
    dec_s = timer.get("decode", {}).get("total_s", float("nan"))
    return dict(rows=len(results), prompt_tokens=n_prompt, generated_tokens=n_gen,
                wall_s=wall, prefill_s=pre_s, decode_s=dec_s, decode_calls=calls,
                prefill_tok_s=n_prompt / pre_s, decode_tok_s=n_gen / dec_s,
                launches=launches, logits_rel_l2=rel, timer=timer)


def serve(torch, kernels, dev, n_requests: int = 96, seed: int = 0) -> dict:
    """Serve 1: qwen3-8b, prompts of 16-500 tokens."""
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS["qwen3-8b"]
    ecfg = EngineConfig(**ENGINES[mcfg.name][0], seed=seed)
    t0 = time.monotonic()
    runner = ModelRunner(mcfg, ecfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    info = runner.device_info()
    print(f"serve: {mcfg.name} L={mcfg.num_layers} H={mcfg.hidden_size} "
          f"params={info['n_params']:,} ({info['param_bytes'] / 1e9:.2f} GB) "
          f"kv_pool={2 * runner.cache.k_pages.numel() * 2 / 1e9:.2f} GB "
          f"init={init_s:.1f}s", flush=True)

    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed)
    prompts = [
        np.asarray(tok.encode("".join(rng.choice(ALPHABET, int(n)))), np.int32)
        for n in rng.integers(16, 501, n_requests)
    ]
    rel = check_prefill_logits(torch, runner, prompts[:4], "serve")
    calls = {}
    count_decode_calls(runner, calls)
    results, launches, timer, wall = run_batch(
        torch, runner, mixed_requests(prompts), kernels, seed)
    if min(calls["decode_step"], calls["decode_multi_async"]) <= 0:
        raise AssertionError(f"the batch did not take both decode paths: {calls}")
    out = serve_summary(prompts, 64, results, launches, calls, timer, wall, rel)
    print("serve: " + json.dumps(out), flush=True)
    return out


def check_split_decode(torch, runner, template, rows, rng, label: str):
    """The template in pages 1.., ``rows``' suffixes after it; then one
    decode step over those pages with and without the prefix groups.
    Held two ways: layer 0's attention output on the same pool (one
    layer of rounding: the kernel phase's atol = rtol), and the logits
    after the whole depth (rel-L2 under REL_L2). Returns (logits rel-L2,
    layer-0 max |err|, tables)."""
    from sutro_tpu_torch.models import transformer
    from sutro_tpu_torch.ops import attention

    dev, mcfg, ecfg = runner.device, runner.mcfg, runner.ecfg
    PSz, n_rows = ecfg.kv_page_size, len(rows)
    n_pfx = len(template) // PSz
    head = np.zeros((ecfg.max_pages_per_seq,), np.int32)
    head[:n_pfx] = np.arange(1, 1 + n_pfx)
    runner.prefill(template, head)
    tables, nxt = [], 1 + n_pfx
    for p in rows:
        t = head.copy()
        n = -(-(len(p) + 1) // PSz) - n_pfx
        t[n_pfx : n_pfx + n] = np.arange(nxt, nxt + n)
        nxt += n
        tables.append(t)
    tables = np.stack(tables)
    runner.prefill_batch_at([p[len(template):] for p in rows], tables,
                            [len(template)] * n_rows)
    past = torch.as_tensor([len(p) for p in rows], dtype=torch.int32, device=dev)
    table_t = torch.as_tensor(tables, device=dev)
    ones = torch.ones((n_rows,), dtype=torch.int32, device=dev)
    groups = ((torch.arange(1, 1 + n_pfx, dtype=torch.int32, device=dev),
               torch.full((n_rows,), len(template), dtype=torch.int32, device=dev)),)

    # layer 0's attention: random current-token q/k/v over the real pool
    NHq, KVHq, Dh = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    bf = dict(dtype=torch.bfloat16, device=dev, generator=g)
    q = torch.randn((n_rows, 1, NHq, Dh), **bf)
    k, v = (torch.randn((n_rows, 1, KVHq, Dh), **bf) for _ in range(2))
    akw = dict(positions=past[:, None], valid_len=ones, past_len=past, page_table=table_t,
               past_k_pages=runner.cache.k_pages[0], past_v_pages=runner.cache.v_pages[0])
    attn_err = check_close(f"{label}: layer-0 attention with vs without prefix groups",
                           attention.chunk_attention(q, k, v, pfx_groups=groups, **akw),
                           attention.chunk_attention(q, k, v, **akw))

    ids = torch.as_tensor(rng.integers(3, 256, (n_rows, 1)), dtype=torch.int32, device=dev)
    kw = dict(paged_past=(runner.cache.k_pages, runner.cache.v_pages, table_t), past_len=past)
    with torch.no_grad():
        split, _, _ = transformer.forward(mcfg, runner.params, ids, past[:, None], ones,
                                          pfx_groups=groups, **kw)
        full, _, _ = transformer.forward(mcfg, runner.params, ids, past[:, None], ones, **kw)
    split, full = split[:, 0].float().cpu().numpy(), full[:, 0].float().cpu().numpy()
    rel = float(np.linalg.norm(split - full) / np.linalg.norm(full))
    print(f"{label}: decode with vs without prefix groups: layer-0 attention "
          f"max_abs={attn_err:.3e}; logits rel_l2={rel:.3e} "
          f"argmax_agree={int((split.argmax(-1) == full.argmax(-1)).sum())}/{n_rows}",
          flush=True)
    if not (np.isfinite(split).all() and rel < REL_L2):
        raise AssertionError(f"{label}: split decode disagrees with the full table: {rel}")
    return rel, attn_err, tables


def serve_templated(torch, kernels, dev, n_requests: int = 96, seed: int = 0) -> dict:
    """Serve 2: a templated classify/extract-style job on qwen3-30b-a3b
    with prefix_split on. Every request is one shared 1,024-token
    template (16 pages) and a distinct 16-256-token suffix."""
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS["qwen3-30b-a3b"]
    fields, n_tpl = ENGINES[mcfg.name]
    ecfg = EngineConfig(**fields, seed=seed)
    t0 = time.monotonic()
    runner = ModelRunner(mcfg, ecfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    info = runner.device_info()
    print(f"serve2: {mcfg.name} L={mcfg.num_layers} H={mcfg.hidden_size} "
          f"E={mcfg.moe_experts} top_k={mcfg.moe_top_k} params={info['n_params']:,} "
          f"({info['param_bytes'] / 1e9:.2f} GB) "
          f"kv_pool={2 * runner.cache.k_pages.numel() * 2 / 1e9:.2f} GB "
          f"init={init_s:.1f}s", flush=True)

    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 1)
    text = lambda n: "".join(rng.choice(ALPHABET, int(n)))  # noqa: E731
    template = np.asarray(tok.encode(text(n_tpl)), np.int32)
    prompts = [
        np.concatenate([template, np.asarray(tok.encode(text(n)), np.int32)])
        for n in rng.integers(16, 257, n_requests)
    ]
    # three sets of 4 rows for the prefill logits, two of 8 for the
    # split decode: one reading each would say little about how close
    # to its limit a check runs
    rels = [check_prefill_logits(torch, runner, prompts[i : i + 4], f"serve2 rows {i}-{i + 3}")
            for i in (0, 4, 8)]
    split_checks = [check_split_decode(torch, runner, template, prompts[i : i + 8], rng,
                                       f"serve2 rows {i}-{i + 7}") for i in (0, 8)]
    tables = split_checks[-1][2]

    # a fused window with the prefix groups chains on the device: no
    # operation inside the call may wait for the card (the grouped GEMM
    # reads its group sizes on the device)
    n_rows = len(tables)
    pfx = ((np.arange(1, 1 + n_tpl // ecfg.kv_page_size, dtype=np.int32),
            np.full(n_rows, len(template), np.int32)),)
    window_args = (
        rng.integers(3, 256, n_rows).astype(np.int32),
        np.array([len(p) for p in prompts[8 : 8 + n_rows]], np.int32), tables, 7,
        np.array([0.0] * 4 + [0.8] * 4, np.float32),
        np.array([1.0] * 4 + [0.9] * 4, np.float32), ecfg.decode_multi_step,
    )
    check_window_no_wait(torch, runner, window_args, "serve2 (prefix groups)", pfx=pfx)

    calls = {}
    count_decode_calls(runner, calls)
    results, launches, timer, wall = run_batch(
        torch, runner, mixed_requests(prompts), kernels, seed)
    if min(calls["decode_step_with_groups"], calls["decode_multi_async_with_groups"]) <= 0:
        raise AssertionError(f"both decode paths must run with prefix groups: {calls}")
    out = serve_summary(prompts, 64, results, launches, calls, timer, wall, max(rels))
    out["logits_rel_l2_by_rows"] = rels
    out["split_vs_full_rel_l2"] = [c[0] for c in split_checks]
    out["split_vs_full_layer0_attn_max_abs"] = [c[1] for c in split_checks]
    print("serve2: " + json.dumps(out), flush=True)
    return out


def check_int8_decode_attention(torch, runner, rows, label: str) -> float:
    """``rows`` prefilled into the int8 pool (pages 1..; a row longer
    than ``prefill_chunk`` goes through chunked prefill over its int8
    past), then layer 0's decode attention over those real pages: the
    kernel (through ``chunk_attention``) against the plain version on the
    same quantized values, at the kernel phase's atol = rtol. Returns
    the max |err|."""
    from sutro_tpu_torch.engine.kvcache import pages_needed
    from sutro_tpu_torch.ops import attention
    from sutro_tpu_torch.ops import paged_decode as pd

    dev, mcfg, ecfg, cache = runner.device, runner.mcfg, runner.ecfg, runner.cache
    tables, nxt = np.zeros((len(rows), ecfg.max_pages_per_seq), np.int32), 1
    for i, r in enumerate(rows):
        n = pages_needed(len(r) + 1, ecfg.kv_page_size)
        tables[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
        runner.prefill(r, tables[i])
    n_rows = len(rows)
    past = torch.as_tensor([len(r) for r in rows], dtype=torch.int32, device=dev)
    table_t = torch.as_tensor(tables, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    bf = dict(dtype=torch.bfloat16, device=dev, generator=g)
    q = torch.randn((n_rows, 1, mcfg.num_heads, mcfg.head_dim), **bf)
    k, v = (torch.randn((n_rows, 1, mcfg.num_kv_heads, mcfg.head_dim), **bf)
            for _ in range(2))
    scales = dict(k_scale=cache.k_scale[0], v_scale=cache.v_scale[0])
    before = pd.INT8.launches
    got = attention.chunk_attention(
        q, k, v, positions=past[:, None], valid_len=torch.ones_like(past), past_len=past,
        page_table=table_t, past_k_pages=cache.k_pages[0], past_v_pages=cache.v_pages[0],
        past_k_scale=scales["k_scale"], past_v_scale=scales["v_scale"])[:, 0]
    if pd.INT8.launches != before + 1:
        raise AssertionError(f"{label}: decode attention over the int8 pool did not launch "
                             "paged_decode_int8")
    want = pd.paged_decode_plain(q[:, 0], cache.k_pages[0], cache.v_pages[0], table_t, past,
                                 k[:, 0], v[:, 0], **scales)
    err = check_close(f"{label}: layer-0 decode attention over the int8 pool", got, want)
    print(f"{label}: layer-0 decode attention over the int8 pool (rows of "
          f"{[len(r) for r in rows]} tokens), kernel vs plain: max_abs={err:.3e}", flush=True)
    return err


def check_window_no_wait(torch, runner, args, label: str, **kw) -> None:
    """One fused window (after a warm-up) under
    ``torch.cuda.set_sync_debug_mode``: no operation may wait for the card."""
    runner.decode_multi_async(*args, **kw)  # warm-up: allocator, pinned buffers
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.decode_multi_async(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    waits = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message)})
    print(f"{label}: host waits inside a fused window: {len(waits)} {waits}", flush=True)
    if waits:
        raise AssertionError(f"{label}: a fused window waited for the card: {waits}")


def serve_int8(torch, kernels, absent, dev, n_requests: int = 96, seed: int = 0) -> dict:
    """Serve 3: qwen3-32b at full width and depth with int8 weights and
    int8 KV pages: 88 prompts of 16-500 tokens and 8 of 1,200-1,900
    (chunked prefill over an int8 past)."""
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS["qwen3-32b"]
    ecfg = EngineConfig(**ENGINES[mcfg.name][0], seed=seed)
    t0 = time.monotonic()
    runner = ModelRunner(mcfg, ecfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    info = runner.device_info()
    c = runner.cache
    pool = sum(t.numel() * t.element_size() for t in (c.k_pages, c.v_pages, c.k_scale,
                                                      c.v_scale))
    print(f"serve3: {mcfg.name} L={mcfg.num_layers} H={mcfg.hidden_size} "
          f"quantize={ecfg.quantize} kv_quantize={ecfg.kv_quantize} "
          f"params={info['n_params']:,} ({info['param_bytes'] / 1e9:.2f} GB) "
          f"kv_pool={pool / 1e9:.2f} GB init={init_s:.1f}s "
          f"allocated={torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 2)
    lengths = np.concatenate([rng.integers(16, 501, n_requests - 8),
                              rng.integers(1200, 1901, 8)])
    rng.shuffle(lengths)
    prompts = [np.asarray(tok.encode("".join(rng.choice(ALPHABET, int(n)))), np.int32)
               for n in lengths]
    short = [p for p in prompts if len(p) <= 500]
    long_ = [p for p in prompts if len(p) > ecfg.prefill_chunk]
    rel = check_prefill_logits(torch, runner, short[:4], "serve3")
    attn_err = check_int8_decode_attention(torch, runner, short[:3] + long_[:1], "serve3")

    n_rows = 8
    tables = np.zeros((n_rows, ecfg.max_pages_per_seq), np.int32)
    tables[:, :8] = np.arange(1, 1 + n_rows * 8).reshape(n_rows, 8)
    window_args = (
        rng.integers(3, 256, n_rows).astype(np.int32),
        rng.integers(16, 400, n_rows).astype(np.int32), tables, 7,
        np.array([0.0] * 4 + [0.8] * 4, np.float32),
        np.array([1.0] * 4 + [0.9] * 4, np.float32), ecfg.decode_multi_step,
    )
    check_window_no_wait(torch, runner, window_args, "serve3")

    calls = {}
    count_decode_calls(runner, calls)
    results, launches, timer, wall = run_batch(
        torch, runner, mixed_requests(prompts), kernels, seed, absent=absent)
    if min(calls["decode_step"], calls["decode_multi_async"]) <= 0:
        raise AssertionError(f"the batch did not take both decode paths: {calls}")
    out = serve_summary(prompts, 64, results, launches, calls, timer, wall, rel)
    out["layer0_int8_attn_max_abs"] = attn_err
    out["long_prompts"] = len(long_)
    print("serve3: " + json.dumps(out), flush=True)
    return out


def free_card(torch, model: str) -> None:
    """The previous serve's runner must be gone before the next one."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"serve: after freeing the {model} runner, {held / 1e9:.3f} GB still allocated",
          flush=True)
    if held > 1e9:
        raise AssertionError(f"the {model} runner was not freed: {held} bytes allocated")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sutro_tpu_torch.engine.runner import set_matmul_precision
    from sutro_tpu_torch.ops import (
        cuda_build, flash_prefill, grouped_matmul, kv_write, paged_decode, prefix_carry,
    )

    set_matmul_precision()
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    dense_path = [paged_decode.KERNEL, kv_write.KERNEL, flash_prefill.KERNEL]
    templated_path = [grouped_matmul.KERNEL, prefix_carry.KERNEL, paged_decode.CARRY,
                      kv_write.KERNEL, flash_prefill.KERNEL]
    int8_path = [paged_decode.INT8, flash_prefill.KERNEL]
    # no silent bf16 route under an int8 pool
    int8_absent = [paged_decode.KERNEL, paged_decode.CARRY, kv_write.KERNEL]

    t0 = time.monotonic()
    logs = cuda_build.build(dense_path + templated_path + int8_path)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build[{name}]: {line.strip()}", flush=True)
    print(f"build: {len(logs)} sources compiled in {time.monotonic() - t0:.1f}s", flush=True)
    for k in (flash_prefill.KERNEL, paged_decode.KERNEL):   # the two redesigned kernels
        for fn, n in cuda_build.sass_counts(k).items():
            print(f"sass[{k.source.name}]: {fn}: HMMA/HGMMA={n['mma']} LDGSTS={n['cp_async']}",
                  flush=True)

    records = []
    rng = np.random.default_rng(1234)
    for fn in (kernel_paged_decode, kernel_kv_write, kernel_flash_prefill,
               kernel_prefix_split, kernel_grouped_matmul, kernel_paged_decode_int8):
        recs = fn(rng, torch, dev)
        torch.cuda.empty_cache()
        for rec in recs if isinstance(recs, list) else [recs]:
            lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            extra = {k: rec[k] for k in ("library", "split_pair_ms", "full_table_ms",
                                         "timed_cases") if k in rec}
            print(f"kernel[{rec['name']}]: ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"library_ms={lib} bound_ms={rec['bound_ms']:.4f} "
                  f"({rec['bound_by']}) max_abs_err={rec['max_abs_err']:.3e} "
                  f"cases={json.dumps(rec['cases'])} {json.dumps(extra)}", flush=True)
            records.append(rec)
    if "--kernels-only" in sys.argv[1:]:
        print(f"card: {card}")
        return 0

    served = {"qwen3-8b": serve(torch, dense_path, dev)}
    print(f"serve: card={card} prefill_tok_s={served['qwen3-8b']['prefill_tok_s']:.1f} "
          f"decode_tok_s={served['qwen3-8b']['decode_tok_s']:.1f} "
          f"wall_s={served['qwen3-8b']['wall_s']:.2f}", flush=True)
    # serve 2 needs the card to itself: 61 GB of weights and a 9.7 GB pool
    free_card(torch, "qwen3-8b")
    s2 = served["qwen3-30b-a3b"] = serve_templated(torch, templated_path, dev)
    print(f"serve2: card={card} prefill_tok_s={s2['prefill_tok_s']:.1f} "
          f"decode_tok_s={s2['decode_tok_s']:.1f} wall_s={s2['wall_s']:.2f}", flush=True)
    # serve 3: 33.6 GB of int8 weights and a 17.3 GB int8 pool
    free_card(torch, "qwen3-30b-a3b")
    s3 = served["qwen3-32b"] = serve_int8(torch, int8_path, int8_absent, dev)
    print(f"serve3: card={card} prefill_tok_s={s3['prefill_tok_s']:.1f} "
          f"decode_tok_s={s3['decode_tok_s']:.1f} wall_s={s3['wall_s']:.2f}", flush=True)

    kernels = []
    for rec in records:
        k = rec["kernel"]
        by_serve = {m: out["launches"][k.name] for m, out in served.items()
                    if k.name in out["launches"]}
        kernels.append({
            "name": rec["name"],
            "route": "cuda",
            "source": str(k.source.relative_to(Path(__file__).resolve().parent)),
            "replaces": k.replaces,
            "launches": sum(by_serve.values()),
            "launches_by_serve": by_serve,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **({"timed_cases": rec["timed_cases"]} if "timed_cases" in rec else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
