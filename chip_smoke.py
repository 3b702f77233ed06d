#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sutro_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the engine's main path is compiled from
   ``sutro_tpu_torch/csrc/`` with ``nvcc`` (one process per source, all
   started together);
3. kernels: each kernel is held against its plain PyTorch version on
   random bfloat16 inputs at Qwen3-8B shapes (NH=32, KVH=8, Dh=128,
   PS=64, B=64), and timed beside its plain version, a one-call PyTorch
   yardstick and its bound (the least time the card could take);
4. serve: ``ContinuousBatcher.run`` over a ``ModelRunner`` for
   ``qwen3-8b`` at full width and depth with random weights from a
   seed: 96 requests, greedy, top-p and row-seeded rows. Every row must
   finish with its full token count, every kernel's launch counter must
   have moved during this run only, the run must take both the
   single-step and the fused-window decode paths, and prefill logits of
   4 rows must match a cache-free forward through the plain attention.

The second-to-last lines are a JSON ``{"kernels": [...]}`` record and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Nothing of JAX or of the JAX package
is imported. Exits with 2 and prints no result when no CUDA device is
available.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and dense
# bf16 tensor-core rate, the denominators of every bound below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ATOL = RTOL = 2e-2  # bf16 output rounding of an f32-accumulated kernel


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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


def _decode_inputs(rng, torch, dev):
    """Ragged rows: past 1..2000, some past=0 rows, page-0 padding rows."""
    past = rng.integers(1, 2001, B)
    past[::9] = 0                        # rows at their first decode step
    pad = np.zeros(B, bool)
    pad[5::16] = True                    # inactive slots: zero table, past 0
    past[pad] = 0
    table = np.zeros((B, MP), np.int32)
    perm = rng.permutation(np.arange(1, NP))
    nxt = 0
    for b in range(B):
        n = -(-int(past[b]) // PS)
        table[b, :n] = perm[nxt : nxt + n]
        nxt += n
    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    return dict(
        q=torch.randn((B, NH, DH), generator=g, **bf),
        k_pages=torch.randn((NP, PS, KD), generator=g, **bf),
        v_pages=torch.randn((NP, PS, KD), generator=g, **bf),
        page_table=torch.as_tensor(table, device=dev),
        past_len=torch.as_tensor(past.astype(np.int32), device=dev),
        k_cur=torch.randn((B, KVH, DH), generator=g, **bf),
        v_cur=torch.randn((B, KVH, DH), generator=g, **bf),
        win_k=torch.randn((B, 8, KD), generator=g, **bf),
        win_v=torch.randn((B, 8, KD), generator=g, **bf),
        sink=torch.randn((NH,), generator=g, device=dev),
    )


def kernel_paged_decode(rng, torch, dev) -> dict:
    import torch.nn.functional as F
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
    past = x["past_len"].long()
    ctx = MP * PS
    idx = x["page_table"].long().reshape(-1)
    kg = x["k_pages"][idx].reshape(B, ctx, KVH, DH)
    vg = x["v_pages"][idx].reshape(B, ctx, KVH, DH)
    keys = torch.cat([kg, x["win_k"].reshape(B, 8, KVH, DH), x["k_cur"][:, None]], 1)
    vals = torch.cat([vg, x["win_v"].reshape(B, 8, KVH, DH), x["v_cur"][:, None]], 1)
    keys, vals = keys.transpose(1, 2).contiguous(), vals.transpose(1, 2).contiguous()
    tok = torch.arange(ctx, device=dev)
    slot = torch.arange(8, device=dev)
    mask = torch.cat([tok[None] < past[:, None], (slot < 4)[None].expand(B, 8),
                      torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    mask = mask[:, None, None, :]
    qs = x["q"][:, :, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, keys, vals, attn_mask=mask, enable_gqa=True))
    # bound: every live token's K and V row once, q in, out back
    live = int(past.sum()) + B * (4 + 1)
    nbytes = 2 * live * KD * 2 + 2 * B * NH * DH * 2 + B * MP * 4 + B * 4
    flops = 4 * live * NH * DH  # per head: 2 for q.k, 2 for p.v
    bms, by = bound_ms(nbytes, flops)
    return dict(name="paged_decode", max_abs_err=max(errs.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                cases=errs, module=pd)


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
    return dict(name="kv_write", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms, cases=errs, module=kw)


def kernel_flash_prefill(rng, torch, dev) -> dict:
    import torch.nn.functional as F
    from sutro_tpu_torch.ops import flash_prefill as fp

    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def inputs(Bc, T):
        return (torch.randn((Bc, T, NH, DH), generator=g, **bf),
                torch.randn((Bc, T, KVH, DH), generator=g, **bf),
                torch.randn((Bc, T, KVH, DH), generator=g, **bf))

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
    ms = time_ms(lambda: fp.flash_prefill(*main))
    plain_ms = time_ms(lambda: fp.flash_prefill_plain(*main), iters=5)
    q, k, v = (t.transpose(1, 2).contiguous() for t in main)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    Bc, T = main[0].shape[:2]
    pairs = Bc * T * (T + 1) / 2
    flops = 4 * pairs * NH * DH
    nbytes = 2 * Bc * T * NH * DH * 2 + 2 * Bc * T * KVH * DH * 2
    bms, by = bound_ms(nbytes, flops)
    return dict(name="flash_prefill", max_abs_err=max(errs.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                cases=errs, module=fp)


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_attention():
    """Route the no-past attention through the plain version (for the
    cache-free reference forward)."""
    from sutro_tpu_torch.ops import attention, flash_prefill

    saved = attention.flash_prefill
    attention.flash_prefill = flash_prefill.flash_prefill_plain
    try:
        yield
    finally:
        attention.flash_prefill = saved


def serve(torch, modules, dev, n_requests: int = 96, seed: int = 0) -> dict:
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.kvcache import make_page_table, pages_needed
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.scheduler import ContinuousBatcher, GenRequest
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer
    from sutro_tpu_torch.models import transformer
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS["qwen3-8b"]
    ecfg = EngineConfig(kv_page_size=64, max_pages_per_seq=32, decode_batch_size=64,
                        max_model_len=2048, decode_multi_step=8, seed=seed)
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
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz ,.;:!?"))
    prompts = [
        np.asarray(tok.encode("".join(rng.choice(alphabet, int(n)))), np.int32)
        for n in rng.integers(16, 501, n_requests)
    ]

    # prefill logits of 4 rows vs a cache-free forward through the plain
    # attention (pages 1.. of the pool; the batcher's allocator reuses
    # them afterwards)
    rows = [prompts[i] for i in range(4)]
    pages, nxt = [], 1
    for r in rows:
        n = pages_needed(len(r), ecfg.kv_page_size)
        pages.append(list(range(nxt, nxt + n)))
        nxt += n
    got = runner.prefill_batch(rows, make_page_table(pages, ecfg.max_pages_per_seq))
    ref = []
    with plain_attention(), torch.no_grad():
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
    print(f"serve: prefill logits vs cache-free plain forward: rel_l2={rel:.3e} "
          f"argmax_agree={agree}/4 max_abs={float(np.abs(got - ref).max()):.3e}", flush=True)
    # bf16 weights/activations through 36 layers: a relative L2 error of
    # a few 1e-3 is rounding; a wrong mask or page would be O(1)
    if not (np.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"prefill logits disagree with the plain forward: rel_l2={rel}")

    # the seeded rows get the three shortest prompts: admission is
    # shortest-first, so they ride the first wave of slots, which then
    # decodes one step at a time (a seeded row needs its own draw), and
    # the later waves take the pipelined fused windows
    seeded = set(np.argsort([len(p) for p in prompts], kind="stable")[:3].tolist())
    requests = []
    for i, p in enumerate(prompts):
        if i in seeded:
            kw = dict(temperature=0.7, top_p=0.95, row_seed=1000 + i)
        elif i % 8 in (1, 5):
            kw = dict(temperature=0.8, top_p=0.9)          # nucleus rows
        else:
            kw = dict(temperature=0.0)                     # greedy rows
        requests.append(GenRequest(row_id=i, prompt_ids=p, max_new_tokens=64, **kw))

    # count the runner's two decode entry points, to show the run took both
    calls = {"decode_step": 0, "decode_multi_async": 0}
    for name in calls:
        def counted(*a, _fn=getattr(runner, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(runner, name, counted)

    for m in modules:
        m.KERNEL.launches = 0
    results = {}
    batcher = ContinuousBatcher(runner, stop_ids=[], seed=seed)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = batcher.run(requests, on_result=lambda r: results.__setitem__(r.row_id, r))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {m.KERNEL.name: m.KERNEL.launches for m in modules}
    if state != "completed" or len(results) != n_requests:
        raise AssertionError(f"run ended {state!r} with {len(results)}/{n_requests} rows")
    for r in results.values():
        if r.error or r.finish_reason != "length" or len(r.token_ids) != 64:
            raise AssertionError(
                f"row {r.row_id}: {r.finish_reason!r} {len(r.token_ids)} tokens {r.error!r}")
        if not all(0 <= t < mcfg.vocab_size for t in r.token_ids):
            raise AssertionError(f"row {r.row_id}: token id out of range")
        if not math.isfinite(r.cumulative_logprob):
            raise AssertionError(f"row {r.row_id}: non-finite logprob")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if min(calls.values()) <= 0:
        raise AssertionError(f"the batch did not take both decode paths: {calls}")
    summary = batcher.timer.summary()
    n_prompt = int(sum(len(p) for p in prompts))
    n_gen = 64 * n_requests
    pre_s = summary.get("prefill", {}).get("total_s", float("nan"))
    dec_s = summary.get("decode", {}).get("total_s", float("nan"))
    out = dict(rows=len(results), prompt_tokens=n_prompt, generated_tokens=n_gen,
               wall_s=wall, prefill_s=pre_s, decode_s=dec_s, decode_calls=calls,
               prefill_tok_s=n_prompt / pre_s, decode_tok_s=n_gen / dec_s,
               launches=launches, logits_rel_l2=rel, timer=summary)
    print("serve: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sutro_tpu_torch.engine.runner import set_matmul_precision
    from sutro_tpu_torch.ops import cuda_build, flash_prefill, kv_write, paged_decode

    set_matmul_precision()
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    modules = [paged_decode, kv_write, flash_prefill]

    t0 = time.monotonic()
    logs = cuda_build.build([m.KERNEL for m in modules])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build[{name}]: {line.strip()}", flush=True)
    print(f"build: {len(logs)} kernels compiled in {time.monotonic() - t0:.1f}s", flush=True)

    records = []
    rng = np.random.default_rng(1234)
    for fn in (kernel_paged_decode, kernel_kv_write, kernel_flash_prefill):
        rec = fn(rng, torch, dev)
        torch.cuda.empty_cache()
        print(f"kernel[{rec['name']}]: ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) max_abs_err={rec['max_abs_err']:.3e} "
              f"cases={json.dumps(rec['cases'])}", flush=True)
        records.append(rec)

    served = serve(torch, modules, dev)
    print(f"serve: card={card} prefill_tok_s={served['prefill_tok_s']:.1f} "
          f"decode_tok_s={served['decode_tok_s']:.1f} wall_s={served['wall_s']:.2f}",
          flush=True)

    kernels = []
    for rec in records:
        m = rec["module"]
        kernels.append({
            "name": rec["name"],
            "route": "cuda",
            "source": f"sutro_tpu_torch/csrc/{rec['name']}.cu",
            "replaces": m.KERNEL.replaces,
            "launches": served["launches"][rec["name"]],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
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
