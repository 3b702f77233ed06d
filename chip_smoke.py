#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sutro_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the engine's main paths is compiled from
   ``sutro_tpu_torch/csrc/`` (five sources; the paged decode's bf16 and
   int8 entry points are one) with ``nvcc`` (one process per source, all started together); the
   compiler's register, shared-memory and spill report, and for the
   four redesigned kernels (flash prefill, paged decode, prefix carry,
   grouped GEMM) the count of tensor-core (``HMMA``/``HGMMA``),
   ``cp.async`` (``LDGSTS``) and TMA (``UTMALDG``) instructions in each
   function's SASS, are printed;
3. kernels: each kernel is held against its plain PyTorch version on
   random bfloat16 inputs, and timed beside its plain version, a
   one-call PyTorch yardstick where one exists and its bound (the least
   time the card could take): paged decode, the page write and flash
   prefill at Qwen3-8B shapes (NH=32, KVH=8, Dh=128, PS=64, B=64); the
   prefix carry and the paged decode with the carry at Qwen3-30B-A3B
   shapes (B=64, NH=32, KVH=4, 1,024-token shared prefix), at serve
   5's (NH=32 over KVH=8 behind the classify prompt's 5 shared pages)
   and at serve 7's (the same heads behind S's 15 shared pages, pasts
   to ~1,600 tokens; both held only), the carry's
   yardstick being the memory-efficient SDPA with its log-sum-exp, the
   carry also timed at a 4,096-token template, with its pages cold
   (rotated past the L2) and at forced split counts; the grouped GEMM at
   Qwen3-30B-A3B expert shapes (E=128, H=2048, F=768; gate/up and down)
   from M = 24 to 32,768 (decode steps over 128 and over 21 experts,
   prefills) beside ``torch._grouped_mm``, including an lhs with rows
   past its last group, which must be zero;
   the paged decode's int8-page option at Qwen3-32B shapes (B=64,
   NH=64, KVH=8), with and without the carry, on the same quantized
   values as its plain version, the yardstick being SDPA over K/V
   gathered and dequantized to bf16 beforehand (twice the bytes); the
   bf16 and int8 paged decode also at long context (64 rows with pasts
   of 4,096-8,192, 130 pages a row) at Qwen3-8B's and Qwen3-32B's head
   counts, and flash prefill also at NH=64 (8 x 500), at T=2,048
   (4 rows, NH=32 over KVH=4) and at serve 6's embedding batch (64 rows
   x 512, NH=16 over KVH=8, also beside its plain version), each beside
   its bound and SDPA; and at gpt-oss-20b's shapes (``kernel_gpt_oss``:
   NH=64 over KVH=8, Dh=64; E=32 at H=F=2,880) flash prefill 8 x 500
   and the paged decode with the sink and the 128-token window and
   without, the carry over 16 shared pages and the decode from it, and
   the grouped GEMM at M = 256 and 16,000, each beside its bound and
   library call; then every kernel of serve 11 and its phases at the
   shapes one rank launches (``check_shard_shapes``, held only):
   Qwen3-30B-A3B's heads at tp=2 (16 over 2) in the prefix carry, the
   paged decode with and without it and flash prefill, the page write
   at KVH/tp*Dh = 256, and the grouped GEMM at E=128 with F=384 (tp=2)
   and at E=64 with F=768 (ep=2);
4. serve 1: ``ContinuousBatcher.run`` over a ``ModelRunner`` for
   ``qwen3-8b`` at full width and depth with random weights from a
   seed: 96 requests, greedy, top-p and row-seeded rows. Every row must
   finish with its full token count, every kernel of the path must
   have launched during this run, the run must take both the
   single-step and the fused-window decode paths, and prefill logits of
   4 rows must match a cache-free forward through the plain attention;
5. serve 5, after serve 1 and before serve 2, through the port's
   façade and job API: serve 1's parameters (checksummed leaf by leaf)
   written as an HF checkpoint (bf16 shards of ~4 GB and an index, by
   the smoke's own few lines) under a temporary ``SUTRO_HOME`` (which
   must have room for it), serve 1's runner freed, ``$SUTRO_HOME/engine.json`` written (serve 1's geometry,
   ``prefix_split``, ``weights_dir``), then ``import sutro_tpu_torch as
   so``: a classify job A (the classify template's prompt and schema,
   four labels with descriptions) of 48 rows of 16-400 tokens, greedy,
   and 48 rows of 16-500 tokens as two ``so.infer`` jobs (36 greedy
   rows; 12 at top-p 0.9 with ``random_seed_per_input``), 64 new
   tokens, submitted back to back so that they attach to A's
   co-batched session. All jobs must succeed with results 1:1 with
   their inputs, every classify row valid under its schema, every other
   row at its 64 tokens or stopped, each progress stream ending at its
   row count, the records' row and token counts and the results' token
   counts and finish reasons equal to the rows' finish data and sums,
   the attached jobs' records naming A's session, every leaf of the
   engine's runner bit-equal to serve 1's, paged decode, its carry
   option, the prefix carry, the page write and flash prefill launched
   by the jobs and the grouped GEMM and the int8 option not; then, on
   the engine's runner, a decode step of two sets of 8 of job A's rows
   must give the same layer-0 attention output (atol = rtol of the
   kernel phase) and the same logits with and without the prefix group
   of the classify prompt's shared pages;
Serves 4, 7, 9 and 10 run at ``CUT_LAYERS`` (8) layers of their
models' full widths (``cut_model``): their checks read routing,
failover, rank recovery and constraints, and the whole smoke must fit
its time limit with serve 11 in it. Serve 5 writes a second checkpoint
of serve 1's first 8 layers beside the full one for serves 7, 9 and 10.

6. serve 7, after serve 5's engine is closed: online serving over HTTP
   on the 8-layer checkpoint serve 5 wrote. A new ``LocalEngine`` (serve 1's
   geometry, ``prefix_split``, ``interactive_slots=8``, the radix prefix
   store on, as by default, ``kv_tiers=True`` and an admission budget of
   the pool's 64 x 2,048 tokens) behind ``server.start_server_thread`` on
   127.0.0.1. Batch job B, 256 rows of 16-500 characters under one
   ~1,024-token system prompt S (a prefix group of 15 pages), 64 new
   tokens, greedy, priority 1, goes through ``Sutro(backend="remote")``
   and its progress is read over the NDJSON stream. Once B passes 64
   rows, 16 chat sessions start 0.25 s apart (3 turns each with a sticky
   ``session_id``, S as their system prompt, 32-128-character user
   turns, 64 tokens at temperature 0; 12 over SSE, 4 collected) beside 4
   one-shot ``/v1/completions``; after turn 2 every session idles and
   ``gateway.checkpoint_idle(0)`` demotes their pages to the host tier,
   so that turn 3 promotes them. B must end ``SUCCEEDED`` with its rows
   1:1 and the stream's end record; every request must end with
   ``stop`` or ``length`` and its streamed deltas must equal its
   terminal record's text; every chat turn must find S's pages warm in
   the store (B's shell put them there), and the tier must demote and
   promote, every promoted page within the int8 round trip of what was
   demoted (pairs that ``ContinuousBatcher.tier_observer`` records); 4
   requests replayed one at a time must give the same reply streamed
   and collected, and the first of each route again with a stop string
   from its reply must end ``stop`` just before it, streamed and
   collected (the head's columns but for the printable ASCII bytes' and
   the stop ids' are zeroed first, so that greedy replies are text a
   client can time); a graceful shutdown with two streams in flight
   must refuse a new request with a 503 and let the streams finish;
   paged decode, its carry option, the prefix carry, the page write and
   flash prefill must launch and the grouped GEMM and the int8 option
   not; then, on the runner with its whole head, a warm request's
   first-step logits must match its cold prefill's (the relative L2
   bound of the prefill checks), and a decode step of two sets of 8 of
   B's rows must give the same layer-0 attention and logits with and
   without S's pages as prefix groups (one group, then two in one
   step); during the burst ``GET /monitor`` must answer with the
   interactive TTFT and ITL p99 and the stock TTFT rule's state, and
   ``GET /monitor/stream?ticks=2`` with two NDJSON ticks. It prints
   client and server TTFT and ITL percentiles, B's
   decode tok/s before and during the burst, the rows suspended for
   interactive requests, the store's hits and tokens saved and the
   tier's operations, bytes and host time, and a ``serve7 summary``
   line after the ``kernels`` line;
7. serve 9, after serve 7's engine is closed, on the same 8-layer checkpoint:
   the replica fleet (``serve_fleet``). Two ``LocalEngine`` replicas r0
   and r1 (serve 1's geometry at 32 slots, a 9.66 GB pool each,
   ``prefix_split``, ``interactive_slots=4``, the prefix store) share the
   smoke's ``SUTRO_HOME``, each behind ``start_server_thread``, r0 with a
   ``profile_dir``; the port's router (``fleet.start_fleet_thread``)
   fronts both and ``Sutro(backend="fleet")`` talks to it. Two 32-row
   jobs through the router, one on each replica (r0 drains for the
   second), progress relayed as NDJSON, each job's outputs equal to its
   rows' run directly on the other replica; r0's job is traced
   (``torch.profiler``) and its trace's kernel events must equal each
   port kernel's launch counters over the job (its busy share, top
   kernels, trace bytes and export time printed beside r1's untraced
   wall); 8 two-turn chat sessions under serve 7's S through the
   router, every turn 2 on its turn 1's replica; a stitched
   ``GET /trace/{id}``; ``/metrics`` under the ``replica`` label; a
   ``fleet.replica_crash`` mid-SSE-stream ending in a structured error
   frame; a 384-row job failed on its owner after its first partial
   chunk (256 rows) and its server shut down, which must fail over and
   end SUCCEEDED with every row once and the stored rows byte-equal;
   ``so.get_fleet`` (not healthy), ``so.get_fleet_monitor``,
   ``so.get_replay_log`` replayed through ``fleet.replay``; a split
   decode behind S on the survivor's runner. A ``serve9 summary`` line
   follows serve 8's;
8. serve 10, after serve 9's engines are closed, on the same 8-layer checkpoint
   (``serve_dp``): data-parallel engine ranks. Two processes of this
   script (``--dp-rank 0`` and ``1``, ``SUTRO_DP_WORLD=2`` on a free
   local port), each a ``LocalEngine`` at serve 9's geometry loading
   qwen3-8b from the checkpoint and qwen-3-embedding-0.6b from one
   written here, each behind ``start_server_thread``; every job's
   payload goes to both through the remote SDK. Job G: 256 rows under
   serve 7's S, 32 tokens, greedy; rank 0's merged results must hold
   every row once in input order, its telemetry document rank 1's
   spans and counters, the doctor a verdict over both processes and
   the fleet view both ranks. Job E: 1,024 embeddings through the dp
   branch, every row once. Job K: 384 rows; once rank 0's live fleet
   view shows 64 of rank 1's rows merged rank 1 is SIGKILLed, and K
   must end SUCCEEDED on rank 0 with every row once and rank 1 lost
   with rows requeued in the fleet view and ``fleet.json``. Each rank's
   launch counters (rank 1's before its kill) must show paged decode,
   its carry option, the prefix carry, the page write and flash
   prefill. Then one engine here, at serve 1's geometry, runs the same
   rows: the token-equal share of G and K and E's largest difference
   and lowest cosine are printed. A ``serve10 summary`` line follows
   serve 9's;
9. serve 8, after serve 10's ranks have exited: stage graphs, the control
   plane and the live monitor on gpt-oss-20b (24 layers, H=2,880, 64/8
   heads of 64, sinks, a 128-token window on every other layer, 32
   experts top-4; random weights from the seed, 41.8 GB) through
   ``import sutro_tpu_torch as so`` (``serve_graphs``: a dry run and a
   six-stage ``so.run_graph`` job, a priority-0 job preempting a
   priority-1 job's rows through the ladder, an over-bucket submit
   refused, an SLO rule set through ``monitor.set_rules`` firing and
   resolving), every kernel but the int8 option launching; then prefill
   logits and a split decode (layers 0 and 1) against their plain
   versions, a MoE forward replaying the kernel run's expert choices
   (``routing``). A ``serve8 summary`` line follows serve 7's;
10. serve 6, after serve 8's engine is closed: embedding jobs through
   the façade on ``qwen-3-embedding-0.6b`` (28 layers, H=1024, 16/8
   heads; random weights from the seed) at serve 1's geometry (batches
   of 64 rows). Job E1: 4,096 rows of 16-1,024 tokens written as two
   CSV files (``id``, ``text``), uploaded with ``so.create_dataset`` /
   ``so.upload_to_dataset`` and submitted as ``so.infer("dataset-<id>",
   column="text", job_priority=1)``; job E2: 256 rows as a list at
   priority 0, submitted once E1 has passed 512 rows. Both must
   succeed, results 1:1 with their inputs (E1's the CSVs' text column
   in file order), every vector 1,024 floats of L2 norm within 1e-3 of
   1; E1 must yield (E2's rows embedded between two of E1's batches,
   E1 back to ``QUEUED`` and then ``RUNNING``) and embed no row twice;
   flash prefill must launch exactly 28 times an ``embed_batch`` call
   and every other kernel never; 8 of E1's rows of mixed length
   embedded in a batch, under the plain attention and each alone must
   agree to a cosine of 0.999; ``so.diagnose_job(E1)`` must grade
   against the H100 row and ``so.get_trace(E1)`` give trace events. It
   prints each job's rows/s and input tok/s, the jobstore's flush and
   finalize ms and the bytes of JSON written;
11. serve 2, after serve 6's runner is freed: a templated batch job on
   ``qwen3-30b-a3b`` (MoE, 128 experts) at full width and depth with
   ``prefix_split=True``: 96 requests sharing a 1,024-token template.
   Every row must finish, the grouped GEMM, the prefix carry, the
   carry-mode paged decode, the page write and flash prefill must have
   launched during this run,
   both decode paths must have run with prefix groups, prefill logits
   of three sets of 4 rows must match a cache-free forward through the
   plain attention and the plain grouped GEMM (on the kernel run's
   expert choices, ``routing``), a decode step of two sets of 8 rows
   over the shared pages must give the same layer-0 attention output
   (atol = rtol of the kernel phase) and the same logits with and
   without the prefix groups, and a fused window with
   the groups must not wait for the card
   (``torch.cuda.set_sync_debug_mode``);
12. serve 4, after serve 2's runner is freed, on a runner of
   qwen3-30b-a3b's widths at 8 layers: a schema-constrained templated
   job of 96 rows, one
   shared 1,024-token template with the classify system prompt at its
   head and a 16-256-token suffix each, at most 128 new tokens: 64
   greedy rows under the classify template's schema, 16 greedy under
   an extraction schema, 16 sampled (0.7, top-p 0.9) under the classify
   schema; then 16 unconstrained greedy rows with repetitive prompts
   and ``spec_ngram_draft=4``. Every constrained row must parse as JSON
   with its schema's required keys, types and labels; the runner's
   ``decode_window``, ``commit_window``, ``verify_candidates``,
   ``verify_greedy`` and masked ``decode_step`` must each be called;
   the grouped GEMM, the prefix carry, the carry-mode paged decode, the
   page write and flash prefill must launch in the job; the verify
   forward's logits at each row's first position must match the
   decode forward's (two sets of 8 rows). It prints the mask core
   (native or Python) and the host time spent on masks;
13. serve 11, after serve 4's runner is freed: device meshes
   (``serve_mesh``). qwen3-30b-a3b at full width and depth on a tp=2
   mesh of two rank processes, this one (rank 0) and the one its runner
   starts, on ``cuda:(r % device_count)``: one card shared over gloo,
   the runner capping each rank's allocator at its share of the card
   (NCCL where a machine has a card a rank). Each rank draws serve 2's
   seeded stream and keeps its half; its blocks' checksums must equal
   those of serve 2's blocks (``mesh_reference``, taken on serve 2's
   runner). Serve 2's 4 check rows' prefill logits, every rank
   replaying serve 2's expert choices, must be within REL_L2 of serve
   2's, and so must one decode step of those rows over the pages that
   prefill wrote: split over their template, over the full table, and
   through the plain versions (``rank_decode_check``); serve 2's first
   32 templated rows, greedy, 16 new tokens (``prefix_split``), must
   each come back once at their length, every kernel of serve 2's path
   launch on both ranks and both ranks sample the same tokens in every
   call; the rows token-equal to serve 2's greedy rows are counted. A
   ``LocalEngine`` job with the mesh runner resident must succeed. Then
   four phases on 4 layers of the same widths, each against one
   device replaying its expert choices, prefill logits within REL_L2:
   ep=2 (64 experts a rank), sp=2 (a ring prefill of 8,192 tokens),
   pp=2 (two stages, two microbatches), each with one fused window, and
   dp=2 x ep=2 on four rank processes (``cuda:(r % device_count)``, each
   capped at its share of the card): the MoE layers split the 4 rows
   over ``data`` and a prefill of 3 of them replicates its tokens; the
   grouped GEMM, flash prefill, paged decode and page write must launch
   on all four ranks and every rank sample the same tokens. A
   ``serve11 summary`` line follows serve 10's;
14. serve 3, after serve 11's ranks are stopped: ``qwen3-32b`` at full
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
(and prints neither record); ``--serve8-only`` runs serve 8 after it
and prints serve 8's summary, not the records; ``--serve9-only`` runs
the build, then serve 9 alone on a qwen3-8b checkpoint it writes from
the seed (its first 8 layers), and prints serve 9's summary;
``--serve10-only`` does the same for serve 10; ``--serve11-only`` runs
the build, then serve 11 against a serve 2 runner built and run here
(``serve11_reference``); ``--nccl-probe`` first prints what NCCL says of
two ranks on one card. ``--dp-rank N`` is serve 10's rank process (``dp_rank``),
which serve 10 starts. ``python3 chip_smoke.py --pair-timing
[--package DIR]`` only times the prefix carry and the grouped GEMM
through their wrappers and prints one JSON line; with ``--package`` the
``sutro_tpu_torch`` under DIR (a parent commit's ``git archive``) is
timed by the same code, so parent and change compare in one call.
The engine's state lives in a temporary ``SUTRO_HOME``, removed at
exit.
"""

from __future__ import annotations

import contextlib
import itertools
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
L2_BYTES = 50e6            # H100 L2 cache: inputs rotated past twice this are cold
ALPHABET = np.array(list("abcdefghijklmnopqrstuvwxyz ,.;:!?"))


# Serve 4's and serve 5's classify labels; the system prompt and output
# schema come from the classify template's own function (classify_job)
CLASSIFY_LABELS = ("positive", "negative", "neutral", "mixed")


def classify_job(classes=CLASSIFY_LABELS):
    """(system prompt, output schema) of a classify job over ``classes``
    (labels, or labels -> descriptions): what ``so.classify`` submits,
    built by the template's own function (pydantic is not on the card's
    machine; the template writes pydantic's schema as a dict)."""
    from sutro_tpu_torch.templates.classification import _prompt_and_schema

    return _prompt_and_schema(classes if isinstance(classes, dict) else list(classes))


# serve 5's classify job: its labels with their descriptions
FACADE_CLASSES = {"positive": "the writer likes it", "negative": "the writer dislikes it",
                  "neutral": "no opinion either way", "mixed": "both likes and dislikes"}


def shared_head(prompts, ps: int) -> np.ndarray:
    """The page-aligned head that every prompt shares, as the scheduler's
    ``_setup_prefix`` finds it: at most one token short of the shortest
    prompt, cut to whole pages of ``ps`` tokens."""
    first = np.asarray(prompts[0])
    lcp = min(len(p) for p in prompts) - 1
    for p in prompts[1:]:
        neq = np.nonzero(first[:lcp] != np.asarray(p)[:lcp])[0]
        lcp = int(neq[0]) if len(neq) else lcp
    return first[: max(lcp, 0) // ps * ps]


def online_system_prompt(rng, chars: int) -> str:
    """Serve 7's system prompt S: ``chars`` characters of ``ALPHABET``."""
    return "".join(rng.choice(ALPHABET, int(chars)))


def online_prefix_pages(seed: int = 0, system_chars: int = 1000, model: str = "qwen3-8b",
                        ps: int = 0) -> int:
    """Pages of ``ps`` tokens (qwen3-8b's 64 by default) of the head that
    serve 7's rows share (``model``'s chat frame around S, byte
    tokenizer): the prefix its carry kernels read."""
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    ps = ps or PS
    mcfg = MODEL_CONFIGS[model]
    system = online_system_prompt(np.random.default_rng(seed + 7), system_chars)
    rows = encode_chat_batch(ByteTokenizer(vocab_size=mcfg.vocab_size), ["x" * 16, "y" * 16],
                             system, mcfg.chat_template)
    return len(shared_head(rows, ps)) // ps


def facade_prefix_pages() -> int:
    """Pages of the head that serve 5's classify prompts share on
    qwen3-8b (Qwen3's chat frame around the classify system prompt,
    byte tokenizer): the prefix its carry kernels read."""
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS["qwen3-8b"]
    prompt, _ = classify_job(FACADE_CLASSES)
    rows = encode_chat_batch(ByteTokenizer(vocab_size=mcfg.vocab_size), ["x" * 16, "y" * 16],
                             prompt, mcfg.chat_template)
    return len(shared_head(rows, PS)) // PS


# an extraction job's schema: an integer, a boolean, an array of strings
# and a nested object, all required
EXTRACT_SCHEMA = {
    "type": "object",
    "properties": {
        "count": {"type": "integer"},
        "urgent": {"type": "boolean"},
        "tags": {"type": "array", "items": {"type": "string", "maxLength": 24}, "maxItems": 4},
        "contact": {
            "type": "object",
            "properties": {"name": {"type": "string", "maxLength": 40},
                           "year": {"type": "integer"}},
            "required": ["name", "year"],
        },
    },
    "required": ["count", "urgent", "tags", "contact"],
}


def schema_errors(schema: dict, text: str) -> list:
    """What is wrong with ``text`` under a classify schema (the one of
    ``classify_job``) or the extraction schema: not JSON, a required key
    missing, a value of the wrong type, a label outside the enum. Empty
    when the text is valid."""
    try:
        obj = json.loads(text)
    except ValueError as e:
        return [f"not JSON: {e}"]
    if not isinstance(obj, dict):
        return ["not an object"]
    is_int = lambda v: isinstance(v, int) and not isinstance(v, bool)  # noqa: E731
    if "classification" in schema["properties"]:
        labels = schema["$defs"]["ClassLabel"]["enum"]
        checks = {"scratchpad": lambda v: isinstance(v, str) and len(v) <= 400,
                  "classification": lambda v: v in labels}
    else:
        checks = {"count": is_int, "urgent": lambda v: isinstance(v, bool),
                  "tags": lambda v: isinstance(v, list) and len(v) <= 4
                  and all(isinstance(t, str) for t in v),
                  "contact": lambda v: isinstance(v, dict) and isinstance(v.get("name"), str)
                  and is_int(v.get("year"))}
    return [f"{key}: {obj.get(key)!r}" for key, ok in checks.items()
            if key not in obj or not ok(obj[key])]


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


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call of ``fn`` (its wrapper, argument checks
    and launch) while the device sleeps, so that no call waits for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


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


def _decode_inputs(rng, torch, dev, nh=NH, mp=MP, past_range=(1, 2001), ragged=True, dh=DH):
    """``nh`` query heads over KVH=8 KV heads of ``dh``, ``mp`` pages per
    row. Ragged rows: past in ``past_range``, some past=0 rows, page-0
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
    kd = KVH * dh
    return dict(
        q=torch.randn((B, nh, dh), generator=g, **bf),
        k_pages=torch.randn((n_pool, PS, kd), generator=g, **bf),
        v_pages=torch.randn((n_pool, PS, kd), generator=g, **bf),
        page_table=torch.as_tensor(table, device=dev),
        past_len=torch.as_tensor(past.astype(np.int32), device=dev),
        k_cur=torch.randn((B, KVH, dh), generator=g, **bf),
        v_cur=torch.randn((B, KVH, dh), generator=g, **bf),
        win_k=torch.randn((B, 8, kd), generator=g, **bf),
        win_v=torch.randn((B, 8, kd), generator=g, **bf),
        sink=torch.randn((nh,), generator=g, device=dev),
    )


def _sdpa_over_gathered(torch, x, k_pages, v_pages, win_len, window=0):
    """Yardstick of a paged decode call: SDPA over K/V already gathered
    (and, for int8 pages, dequantized to bf16) into [B, KVH, S, Dh]
    with a key-validity mask, cut to the last ``window`` positions when
    one is given (no sink: a little less work than the kernel's);
    building them is not timed."""
    import torch.nn.functional as F

    past = x["past_len"].long()
    dev = past.device
    nb, kvh, dh = x["k_cur"].shape
    ctx = x["page_table"].shape[1] * PS
    W = x["win_k"].shape[1]
    idx = x["page_table"].long().reshape(-1)
    kg = k_pages[idx].reshape(nb, ctx, kvh, dh)
    vg = v_pages[idx].reshape(nb, ctx, kvh, dh)
    keys = torch.cat([kg, x["win_k"].reshape(nb, W, kvh, dh), x["k_cur"][:, None]], 1)
    vals = torch.cat([vg, x["win_v"].reshape(nb, W, kvh, dh), x["v_cur"][:, None]], 1)
    keys, vals = keys.transpose(1, 2).contiguous(), vals.transpose(1, 2).contiguous()
    tok = torch.arange(ctx, device=dev)
    slot = torch.arange(W, device=dev)
    mask = torch.cat([tok[None] < past[:, None], (slot < win_len)[None].expand(nb, W),
                      torch.ones((nb, 1), dtype=torch.bool, device=dev)], 1)
    if window:
        pos = torch.cat([tok[None].expand(nb, ctx), past[:, None] + slot[None],
                         (past + win_len)[:, None]], 1)
        mask &= pos > (past + win_len)[:, None] - window
    mask = mask[:, None, None, :]
    qs = x["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, keys, vals, attn_mask=mask,
                                                  enable_gqa=True)


def _decode_bound(x, nh, win_len, int8=False, window=0):
    """The least time of a paged decode call: every live token's K and V
    row once (only those in the window on a windowed layer; int8 pages:
    1 byte an element and two f32 scales a token; the window slots and
    the current token in bf16), q in, out back, the table and lengths;
    4 flops per (query head, key, Dh)."""
    n_rows, mp = x["page_table"].shape
    dh = x["q"].shape[2]
    kd = x["k_cur"].shape[1] * dh
    past = x["past_len"].long().cpu().numpy()
    if window:   # the current token and the slots first, then the pages
        other = n_rows * min(win_len + 1, window)
        page_tokens = int(np.minimum(past, max(window - win_len - 1, 0)).sum())
    else:
        other = n_rows * (win_len + 1)
        page_tokens = int(past.sum())
    if int8:
        kv = 2 * page_tokens * (kd + 4) + 2 * other * kd * 2
    else:
        kv = 2 * (page_tokens + other) * kd * 2
    nbytes = kv + 2 * n_rows * nh * dh * 2 + n_rows * mp * 4 + n_rows * 4
    return bound_ms(nbytes, 4 * (page_tokens + other) * nh * dh)


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
    """A kernel-phase record: named after its kernel unless ``name``
    says which shape of it the record is."""
    return {"kernel": kernel, "name": kernel.name, **kw}


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


# serve 6's embedding batch: 64 rows padded to 512 tokens, qwen3-emb-0.6b's
# 16 query heads over 8 KV heads
EB, ET, EMB_NH = 64, 512, 16
EMBED_CASE = "T512_B64_nh16_kvh8_embed"


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
    # qwen3-32b's heads (NH=64 over 8) at the serve's 8 x 500, serve 2's
    # prefill_chunk of 2,048 tokens at qwen3-30b-a3b's heads (32 over 4),
    # and serve 6's embedding batch: 64 rows x 512 at qwen3-emb-0.6b's
    # heads (16 over 8), also beside its plain version
    more = {"T500_nh64": inputs(8, 500, nh=Q32_NH), "T2048_nh32_kvh4": inputs(4, 2048, kvh=QKVH),
            EMBED_CASE: inputs(EB, ET, nh=EMB_NH, kvh=KVH)}
    timed_cases = {}
    for name, args in more.items():
        errs[name] = check_close(f"flash_prefill[{name}]", fp.flash_prefill(*args),
                                 fp.flash_prefill_plain(*args))
        timed_cases[name] = timed(args)
    timed_cases[EMBED_CASE]["plain_ms"] = time_ms(
        lambda: fp.flash_prefill_plain(*more[EMBED_CASE]), iters=3, warmup=1)
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


def _prefix_inputs(rng, torch, dev, nh=QNH, kvh=QKVH, mp=QMP, n_pfx=N_PFX, suffix=(16, 257),
                   dh=DH):
    """Rows 0..63 of a templated batch: members' tables start with the
    ``n_pfx`` shared pages (16: the serve's 1,024-token template), every
    8th row is outside the group (a short untemplated row, so that, as
    in the serve, no row walks more than ~320 tokens of its own); each
    member has decoded into its own pages past the template and its
    suffix (``suffix``: the range of its length). Qwen3-30B-A3B's heads
    and pages unless ``nh``/``kvh``/``mp``/``dh`` say otherwise."""
    n_pool, kd = 1 + QB * mp, kvh * dh
    member = np.ones(QB, bool)
    member[7::8] = False
    past = n_pfx * PS + rng.integers(*suffix, QB) + rng.integers(0, 57, QB)
    past[~member] = rng.integers(16, 321, int((~member).sum()))
    table = np.zeros((QB, mp), np.int32)
    perm = rng.permutation(np.arange(1 + n_pfx, n_pool))
    nxt = 0
    for b in range(QB):
        head = n_pfx if member[b] else 0
        if head:
            table[b, :head] = np.arange(1, 1 + n_pfx)
        n = -(-int(past[b]) // PS) - head
        table[b, head : head + n] = perm[nxt : nxt + n]
        nxt += n
    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    win_len = 4
    return dict(
        q=torch.randn((QB, nh, dh), generator=g, **bf),
        k_pages=torch.randn((n_pool, PS, kd), generator=g, **bf),
        v_pages=torch.randn((n_pool, PS, kd), generator=g, **bf),
        page_table=i32(table), past_len=i32(past),
        k_cur=torch.randn((QB, kvh, dh), generator=g, **bf),
        v_cur=torch.randn((QB, kvh, dh), generator=g, **bf),
        win_k=torch.randn((QB, 8, kd), generator=g, **bf),
        win_v=torch.randn((QB, 8, kd), generator=g, **bf),
        sink=torch.randn((nh,), generator=g, device=dev),
        win_len=win_len,
        pages=i32(np.arange(1, 1 + n_pfx)),
        pfx_len=i32(np.where(member, n_pfx * PS, 0)),
        pfx_cnt=i32(np.where(member, n_pfx, 0)),
        q_pos=i32(past + win_len),
        member=member, past=past,
    )


def _carry_bound(x):
    """The least time of a carry call: the shared K/V rows once, q in,
    m/l/acc out; 4 flops per (member query head, prefix key, Dh) (q.k
    and p.v)."""
    n_pfx = x["pages"].numel()
    pfx_tokens = n_pfx * PS
    nb, nh, dh = x["q"].shape
    kd = x["k_pages"].shape[2]
    nbytes = (nb * nh * dh * 2 + 2 * pfx_tokens * kd * 2 + n_pfx * 4 + 2 * nb * 4
              + nb * nh * (2 * 4 + dh * 4))
    return bound_ms(nbytes, 4 * int(x["member"].sum()) * pfx_tokens * nh * dh)


def _carry_cold_ms(torch, pc, x) -> float:
    """The carry with its pages cold, as a layer's pages are on the main
    path: page 0 and the shared pages copied into enough small pools to
    exceed the L2 twice over, each call reading the next pool (no pool
    repeats within ``time_ms``'s 23 calls)."""
    n = 1 + x["pages"].numel()   # pages 0 .. n_pfx
    k, v = x["k_pages"][:n], x["v_pages"][:n]
    copies = max(24, math.ceil(2 * L2_BYTES / (2 * k.numel() * k.element_size())))
    pools = itertools.cycle([(k.clone(), v.clone()) for _ in range(copies)])

    def call():
        kp, vp = next(pools)
        pc.prefix_attention_carry(x["q"], kp, vp, x["pages"], x["pfx_len"], x["q_pos"], 0)

    return time_ms(call)


def carry_timings(rng, torch, dev, pc, serve_x=None) -> dict:
    """The prefix carry at serve 2's shape (a 1,024-token template) and at
    a 4,096-token one, window 0: warm (one call repeated: its 2-8 MB of
    pages stay in L2) and cold, beside the memory-efficient SDPA with its
    log-sum-exp and the bound. Uses only ``prefix_attention_carry`` and
    its plain version, so a parent tree's package is timed the same way
    (``--pair-timing``)."""
    out = {}
    for name, n_pfx in (("template_1024", N_PFX), ("template_4096", 64)):
        x = serve_x if n_pfx == N_PFX and serve_x is not None else _prefix_inputs(
            rng, torch, dev, mp=n_pfx + 8, n_pfx=n_pfx)
        args = (x["q"], x["k_pages"], x["v_pages"], x["pages"], x["pfx_len"], x["q_pos"], 0)
        want = pc.prefix_attention_carry_plain(*args)
        got = pc.prefix_attention_carry(*args)
        torch.cuda.synchronize()
        live = want[1] > 0
        err = max(check_close(f"prefix_carry[{name}].m", got[0][live], want[0][live]),
                  check_close(f"prefix_carry[{name}].l", got[1], want[1]),
                  check_close(f"prefix_carry[{name}].acc", got[2], want[2]))
        library, _ = _library_carry(torch, x, want)
        bms, by = _carry_bound(x)
        out[name] = dict(warm_ms=time_ms(lambda: pc.prefix_attention_carry(*args)),
                         cold_ms=_carry_cold_ms(torch, pc, x), library_ms=time_ms(library),
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         tokens=n_pfx * PS, member_rows=int(x["member"].sum()))
        del x, args, want, got, library
        torch.cuda.empty_cache()
    return out


def carry_split_sweep(torch, pc, carry_args) -> dict:
    """The carry at serve 2's shape with its 16 tiles forced into 1, 2,
    4 and 8 splits (``split_plan`` replaced for the call), each held
    against the plain carry: the data behind the plan's one wave and
    ``MIN_TILES``."""
    want = pc.prefix_attention_carry_plain(*carry_args)
    live = want[1] > 0
    tiles = N_PFX * PS // pc.TILE_TOKENS[DH]
    plan, out = pc.split_plan, {}
    try:
        for n in (1, 2, 4, 8):
            pc.split_plan = lambda *a, n=n: (tiles // n, n)
            got = pc.prefix_attention_carry(*carry_args)
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(got, want)):
                check_close(f"prefix_carry[splits{n}][{i}]", x[live] if i == 0 else x,
                            y[live] if i == 0 else y)
            out[f"splits{n}"] = time_ms(lambda: pc.prefix_attention_carry(*carry_args))
    finally:
        pc.split_plan = plan
    return out


def check_carry(torch, pc, pd, x, dev, tag: str = "", window: int = 600,
                sink: bool = False) -> tuple:
    """The carry kernel on ``x`` (windows 0 and ``window``, which cuts the
    prefix, and its page list padded with page 0) and the paged decode
    started from each carry (with ``x``'s attention sink when ``sink``),
    against their plain versions: the carry kernel plus the decode
    kernel with pfx_cnt must equal the plain decode over the full table.
    Returns (carry errors, decode errors, the window-0 carry)."""
    pool = (x["q"], x["k_pages"], x["v_pages"])
    padded = torch.cat([x["pages"], torch.zeros_like(x["pages"])])  # page-0 padding
    carry_errs, dec_errs, carries = {}, {}, {}
    cut = f"window{window}_cuts_prefix"
    for name, pages, w in (("window0", x["pages"], 0), (cut, x["pages"], window),
                           ("padded_pages", padded, 0)):
        name = tag + name
        args = (*pool, pages, x["pfx_len"], x["q_pos"], w)
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
        carries[name] = (got, w)
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    win = dict(win_k=x["win_k"], win_v=x["win_v"], win_len=x["win_len"],
               **({"sink": x["sink"]} if sink else {}))
    for name in (tag + "window0", tag + cut):
        (m0, l0, acc0), w = carries[name]
        got = pd.paged_decode_attention(*base, w, **win, pfx_cnt=x["pfx_cnt"],
                                        m0=m0, l0=l0, acc0=acc0)
        want = pd.paged_decode_plain(*base, w, **win)
        torch.cuda.synchronize()
        dec_errs[name] = check_close(f"paged_decode_carry[{name}]", got, want)
    return carry_errs, dec_errs, carries[tag + "window0"][0]


def kernel_prefix_split(rng, torch, dev) -> list:
    """The prefix carry, and the paged decode started from it, against
    their plain versions (``check_carry``) at serve 2's shape, at serve
    5's (qwen3-8b's NH=32 over KVH=8 behind the classify prompt's shared
    pages) and at serve 7's (the same heads behind the system prompt S's
    shared pages, members' suffixes as long as job B's rows and their
    64 new tokens); timed at serve 2's."""
    from sutro_tpu_torch.ops import paged_decode as pd
    from sutro_tpu_torch.ops import prefix_carry as pc

    x = _prefix_inputs(rng, torch, dev)
    carry_errs, dec_errs, (m0, l0, acc0) = check_carry(torch, pc, pd, x, dev)
    for tag, n_pfx, suffix in (("qwen3_8b_classify_", facade_prefix_pages(), (16, 257)),
                               ("qwen3_8b_online_", online_prefix_pages(), (16, 565))):
        y = _prefix_inputs(rng, torch, dev, nh=NH, kvh=KVH, mp=MP, n_pfx=n_pfx, suffix=suffix)
        more = check_carry(torch, pc, pd, y, dev, tag)
        carry_errs.update(more[0])
        dec_errs.update(more[1])
        del y, more
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    win = dict(win_k=x["win_k"], win_v=x["win_v"], win_len=x["win_len"])
    pool = (x["q"], x["k_pages"], x["v_pages"])
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
    bc, byc = _carry_bound(x)
    del library
    timed = carry_timings(rng, torch, dev, pc, x)
    split_sweep = carry_split_sweep(torch, pc, carry_args)
    member = x["member"]
    pfx_tokens = N_PFX * PS
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
             cases=carry_errs, timed_cases=timed, split_sweep=split_sweep,
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
    nb, nh, dh = q.shape
    kvh = x["k_pages"].shape[2] // dh
    G = nh // kvh
    S = x["pages"].numel() * PS
    idx = x["pages"].long()

    def heads_first(pool):   # [1, KVH, S, Dh]
        return pool[idx].reshape(S, kvh, dh).transpose(0, 1)[None].contiguous()

    kg, vg = heads_first(x["k_pages"]), heads_first(x["v_pages"])
    qs = q.reshape(nb, kvh, G, dh).transpose(0, 1).reshape(1, kvh, nb * G, dh).contiguous()
    ok = torch.arange(S, device=q.device)[None] < x["pfx_len"].long()[:, None]   # [B, S]
    bias = torch.zeros(ok.shape, dtype=torch.bfloat16, device=q.device).masked_fill(~ok, -1e30)
    bias = bias.repeat_interleave(G, 0)[None, None].expand(1, kvh, nb * G, S).contiguous()

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(qs, kg, vg, bias, True)

    out, lse = library()[:2]
    torch.cuda.synchronize()
    out = out[0].reshape(kvh, nb, G, dh).transpose(0, 1).reshape(nb, nh, dh)
    lse = lse[0, :, : nb * G].reshape(kvh, nb, G).transpose(0, 1).reshape(nb, nh)
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


def _routed_sizes(torch, g, router, n_tokens, empty=None, experts=GE):
    """Group sizes of ``n_tokens`` tokens routed top-8 by a random router
    (~127 of 128 experts from 64 tokens on) among the first ``experts``;
    ``empty`` gets no rows."""
    logits = torch.randn((n_tokens, GH), generator=g, device=router.device) @ router
    logits[:, experts:] = float("-inf")
    if empty is not None:
        logits[:, empty] = float("-inf")
    idx = torch.topk(logits, TOPK, dim=-1).indices.reshape(-1)
    return torch.bincount(idx, minlength=GE).tolist()


# name: (M, experts the router draws from): a row-seeded step's 3 rows, a
# few decode rows, a decode step (and one over 21 experts, as many as the
# random-weight serve's decode steps reach: stepprofile's experts_used),
# serve 2's 2,048-token chunk, a 4,096-token prefill
GMM_TIMED = {"M24": (24, GE), "M128": (128, GE), "M512": (512, GE),
             "M512_experts21": (512, 21), "M16384": (16384, GE), "M32768": (32768, GE)}


def gmm_timings(rng, torch, dev, gm, with_plain: bool = True) -> dict:
    """The grouped GEMM through its wrapper at Qwen3-30B-A3B expert widths
    for the calls of ``GMM_TIMED``, gate/up (H -> F) and down (F -> H),
    beside ``torch._grouped_mm`` and the bound. Uses only
    ``grouped_matmul`` and its plain version, so a parent tree's package
    is timed the same way (``--pair-timing``)."""
    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    router = torch.randn((GH, GE), generator=g, device=dev) * GH ** -0.5
    weights = {"gate": torch.randn((GE, GH, GF), generator=g, **bf) * GH ** -0.5,
               "down": torch.randn((GE, GF, GH), generator=g, **bf) * GF ** -0.5}
    out = {}
    for key, (M, experts) in GMM_TIMED.items():
        sizes = _routed_sizes(torch, g, router, M // TOPK, experts=experts)
        gs = torch.as_tensor(np.asarray(sizes, np.int32), device=dev)
        used = sum(1 for n in sizes if n)
        for proj, rhs in weights.items():
            K, N = rhs.shape[1:]
            lhs = torch.randn((M, K), generator=g, **bf)
            want = gm.grouped_matmul_plain(lhs, rhs, gs)
            err = check_close(f"grouped_matmul[{key}_{proj}]",
                              gm.grouped_matmul(lhs, rhs, gs), want)
            lib, lib_name = _library_grouped_mm(torch, lhs, rhs, sizes)
            bms, by = bound_ms(M * K * 2 + used * K * N * 2 + M * N * 2 + GE * 4, 2 * M * K * N)
            out[f"{key}_{proj}"] = dict(
                ms=time_ms(lambda: gm.grouped_matmul(lhs, rhs, gs)),
                host_us=host_us(lambda: gm.grouped_matmul(lhs, rhs, gs)),
                library_ms=time_ms(lib), library=lib_name, bound_ms=bms, bound_by=by,
                experts_used=used, max_abs_err=err,
                **({"plain_ms": time_ms(lambda: gm.grouped_matmul_plain(lhs, rhs, gs),
                                        iters=3, warmup=1)} if with_plain else {}),
            )
            del lhs, want, lib
    return out


def kernel_grouped_matmul(rng, torch, dev) -> dict:
    """Expert GEMMs at Qwen3-30B-A3B shapes, held against the plain
    version: decode steps' 512 (token, expert) rows routed by a random
    router, prefills' 16,384 and 32,768, an empty group, one hot expert,
    rows past the last group (which must be zero), for the gate/up
    (H -> F) and the down (F -> H) projections; then timed
    (``gmm_timings``). The record's main call is a decode step's gate/up
    (M = 512), the call the serve makes most."""
    from sutro_tpu_torch.ops import grouped_matmul as gm

    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    router = torch.randn((GH, GE), generator=g, device=dev) * GH ** -0.5
    routed = lambda n, empty=None: _routed_sizes(torch, g, router, n, empty)  # noqa: E731
    w_up = torch.randn((GE, GH, GF), generator=g, **bf) * GH ** -0.5
    w_down = torch.randn((GE, GF, GH), generator=g, **bf) * GF ** -0.5
    hot = [0] * GE
    hot[GE // 3] = 512
    cases = {   # name: (group sizes, weights, lhs rows past the last group)
        "decode_M512_gate": (routed(64), w_up, 0),
        "decode_M512_down": (routed(64), w_down, 0),
        "prefill_M16384_gate": (routed(2048), w_up, 0),
        "prefill_M16384_down": (routed(2048), w_down, 0),
        "prefill_M32768_gate": (routed(4096), w_up, 0),
        "prefill_M32768_down": (routed(4096), w_down, 0),
        "empty_group_M512": (routed(64, empty=5), w_up, 0),
        "hot_expert_M512": (hot, w_up, 0),
        "rows_past_groups_M512": (routed(40), w_down, 192),
        "rows_past_groups_M8192": (routed(1000), w_up, 192),
    }
    if cases["empty_group_M512"][0][5] != 0:
        raise AssertionError("grouped_matmul: the empty-group case has no empty group")
    errs = {}
    for name, (sizes, rhs, pad) in cases.items():
        lhs = torch.randn((sum(sizes) + pad, rhs.shape[1]), generator=g, **bf)
        gs = torch.as_tensor(np.asarray(sizes, np.int32), device=dev)
        got = gm.grouped_matmul(lhs, rhs, gs)
        want = gm.grouped_matmul_plain(lhs, rhs, gs)
        torch.cuda.synchronize()
        errs[name] = check_close(f"grouped_matmul[{name}]", got, want)
        if pad and got[sum(sizes):].any():
            raise AssertionError(f"grouped_matmul[{name}]: rows past the groups are not zero")
        del lhs, got, want
    del w_up, w_down
    timed = gmm_timings(rng, torch, dev, gm)
    t = timed["M512_gate"]
    return _rec(gm.KERNEL, max_abs_err=max([*errs.values(),
                                            *(v["max_abs_err"] for v in timed.values())]),
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"], cases=errs,
                library=t["library"], timed_cases=timed)


# gpt-oss-20b (serve 8): 64 query heads over 8 KV heads of 64, a sink
# and a 128-token window on every other layer, 32 experts top-4 at
# H = F = 2,880 (22.5 of the grouped GEMM's 128-wide tiles)
ONH, OKVH, ODH, OWIN = 64, 8, 64, 128
OE, OH, OTOPK = 32, 2880, 4


def _window_causal_flops(Bc: int, T: int, window: int, nh: int, dh: int) -> float:
    """4 flops per (query, key in its window or causal past), head and
    column: the work a causal prefill over ``T`` tokens needs."""
    keys = np.minimum(np.arange(1, T + 1), window) if window else np.arange(1, T + 1)
    return 4.0 * Bc * float(keys.sum()) * nh * dh


def kernel_gpt_oss(rng, torch, dev) -> list:
    """Every kernel of serve 8's path at gpt-oss-20b's shapes, held
    against its plain version and timed beside its bound and library
    call: flash prefill over 8 x 500 tokens with the sink and the
    128-token window (the windowed layers) and without either, beside
    SDPA with the window as a mask and no sink (less work); the paged
    decode in a fused window, the same two ways; the prefix carry over
    16 shared pages and the decode started from it (``check_carry``:
    windows 0 and 128, which cuts the prefix, the sink in the decode);
    the grouped GEMM at M = 256 (a decode step of 64 rows) and 16,000
    over 32 experts, gate/up and down, one expert empty, beside
    ``torch._grouped_mm``."""
    import torch.nn.functional as F
    from sutro_tpu_torch.ops import flash_prefill as fp
    from sutro_tpu_torch.ops import grouped_matmul as gm
    from sutro_tpu_torch.ops import paged_decode as pd
    from sutro_tpu_torch.ops import prefix_carry as pc

    bf = dict(dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    recs = []

    # -- flash prefill, 8 x 500 --------------------------------------------
    Bc, T = 8, 500
    args = (torch.randn((Bc, T, ONH, ODH), generator=g, **bf),
            torch.randn((Bc, T, OKVH, ODH), generator=g, **bf),
            torch.randn((Bc, T, OKVH, ODH), generator=g, **bf))
    sink = torch.randn((ONH,), generator=g, device=dev)
    q, k, v = (t.transpose(1, 2).contiguous() for t in args)
    t_idx = torch.arange(T, device=dev)
    band = (t_idx[None] <= t_idx[:, None]) & (t_idx[None] > t_idx[:, None] - OWIN)
    nbytes = 2 * Bc * T * ONH * ODH * 2 + 2 * Bc * T * OKVH * ODH * 2
    for tag, kw, lib in (
            ("window128_sink", dict(window=OWIN, sink=sink),
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)),
            ("full", {}, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                enable_gqa=True))):
        err = check_close(f"flash_prefill[gpt-oss {tag}]", fp.flash_prefill(*args, **kw),
                          fp.flash_prefill_plain(*args, **kw))
        bms, by = bound_ms(nbytes, _window_causal_flops(Bc, T, kw.get("window", 0), ONH, ODH))
        recs.append(_rec(fp.KERNEL, name=f"flash_prefill[gpt-oss-20b {tag}]", max_abs_err=err,
                         ms=time_ms(lambda: fp.flash_prefill(*args, **kw)),
                         plain_ms=time_ms(lambda: fp.flash_prefill_plain(*args, **kw), iters=3,
                                          warmup=1),
                         bound_ms=bms, bound_by=by, library_ms=time_ms(lib),
                         library="SDPA, the window as a mask, no sink (less work)"
                         if kw else "SDPA, causal",
                         cases={tag: err}, shape=[Bc, T, ONH, OKVH, ODH]))
    del args, q, k, v, band

    # -- paged decode, 64 rows in a fused window ---------------------------
    x = _decode_inputs(rng, torch, dev, nh=ONH, dh=ODH)
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    win = dict(win_k=x["win_k"], win_v=x["win_v"], win_len=4)
    for tag, kw in (("window128_sink", dict(window=OWIN, sink=x["sink"])), ("full", {})):
        call = dict(kw, **win)
        err = check_close(f"paged_decode[gpt-oss {tag}]", pd.paged_decode_attention(*base, **call),
                          pd.paged_decode_plain(*base, **call))
        bms, by = _decode_bound(x, ONH, 4, window=kw.get("window", 0))
        recs.append(_rec(pd.KERNEL, name=f"paged_decode[gpt-oss-20b {tag}]", max_abs_err=err,
                         ms=time_ms(lambda: pd.paged_decode_attention(*base, **call)),
                         plain_ms=time_ms(lambda: pd.paged_decode_plain(*base, **call), iters=5),
                         bound_ms=bms, bound_by=by,
                         library_ms=time_ms(_sdpa_over_gathered(torch, x, x["k_pages"],
                                                                x["v_pages"], 4,
                                                                kw.get("window", 0))),
                         library="SDPA over K/V gathered beforehand, the window as a mask, "
                                 "no sink", cases={tag: err}))
    del x, base

    # -- the prefix carry over 16 shared pages, and the decode from it -----
    y = _prefix_inputs(rng, torch, dev, nh=ONH, kvh=OKVH, mp=MP, n_pfx=16, dh=ODH)
    carry_errs, dec_errs, (m0, l0, acc0) = check_carry(torch, pc, pd, y, dev, "gpt_oss_",
                                                       window=OWIN, sink=True)
    carry_args = (y["q"], y["k_pages"], y["v_pages"], y["pages"], y["pfx_len"], y["q_pos"], 0)
    library, lib_err = _library_carry(torch, y, pc.prefix_attention_carry_plain(*carry_args))
    bc, byc = _carry_bound(y)
    recs.append(_rec(pc.KERNEL, name="prefix_carry[gpt-oss-20b 16 pages]",
                     max_abs_err=max(carry_errs.values()),
                     ms=time_ms(lambda: pc.prefix_attention_carry(*carry_args)),
                     plain_ms=time_ms(lambda: pc.prefix_attention_carry_plain(*carry_args),
                                      iters=5),
                     bound_ms=bc, bound_by=byc, library_ms=time_ms(library),
                     library="aten._scaled_dot_product_efficient_attention with its "
                             "log-sum-exp", cases={**carry_errs, "library_vs_plain": lib_err}))
    del library
    ybase = (y["q"], y["k_pages"], y["v_pages"], y["page_table"], y["past_len"],
             y["k_cur"], y["v_cur"])
    dec_kw = dict(win_k=y["win_k"], win_v=y["win_v"], win_len=y["win_len"], sink=y["sink"],
                  pfx_cnt=y["pfx_cnt"], m0=m0, l0=l0, acc0=acc0)
    own = int(np.where(y["member"], y["past"] - 16 * PS, y["past"]).sum())
    live = own + QB * (y["win_len"] + 1)
    kd = OKVH * ODH
    nbytes = (2 * live * kd * 2 + 2 * QB * ONH * ODH * 2 + QB * ONH * (2 * 4 + ODH * 4)
              + QB * MP * 4 + 2 * QB * 4)
    bd, byd = bound_ms(nbytes, 4 * live * ONH * ODH)
    recs.append(_rec(pd.CARRY, name="paged_decode_carry[gpt-oss-20b sink]",
                     max_abs_err=max(dec_errs.values()),
                     ms=time_ms(lambda: pd.paged_decode_attention(*ybase, 0, **dec_kw)),
                     plain_ms=time_ms(lambda: pd.paged_decode_plain(*ybase, 0, **dec_kw),
                                      iters=5),
                     bound_ms=bd, bound_by=byd, library_ms=None, cases=dec_errs))
    del y, ybase, dec_kw, m0, l0, acc0

    # -- the grouped GEMM over 32 experts at H = F = 2,880 ------------------
    router = torch.randn((OH, OE), generator=g, device=dev) * OH ** -0.5
    w = torch.randn((OE, OH, OH), generator=g, **bf) * OH ** -0.5
    w_down = torch.randn((OE, OH, OH), generator=g, **bf) * OH ** -0.5
    for M in (256, 16000):
        logits = torch.randn((M // OTOPK, OH), generator=g, device=dev) @ router
        logits[:, OE // 2] = float("-inf")   # one expert gets no rows
        sizes = torch.bincount(torch.topk(logits, OTOPK, dim=-1).indices.reshape(-1),
                               minlength=OE).tolist()
        gs = torch.as_tensor(np.asarray(sizes, np.int32), device=dev)
        used = sum(1 for n in sizes if n)
        per = {}
        for proj, rhs in (("gate", w), ("down", w_down)):
            lhs = torch.randn((M, OH), generator=g, **bf)
            err = check_close(f"grouped_matmul[gpt-oss M{M} {proj}]",
                              gm.grouped_matmul(lhs, rhs, gs), gm.grouped_matmul_plain(lhs, rhs, gs))
            lib, lib_name = _library_grouped_mm(torch, lhs, rhs, sizes)
            bms, by = bound_ms(M * OH * 2 + used * OH * OH * 2 + M * OH * 2 + OE * 4,
                               2.0 * M * OH * OH)
            per[proj] = dict(ms=time_ms(lambda: gm.grouped_matmul(lhs, rhs, gs)),
                             plain_ms=time_ms(lambda: gm.grouped_matmul_plain(lhs, rhs, gs),
                                              iters=3, warmup=1),
                             library_ms=time_ms(lib), library=lib_name, bound_ms=bms,
                             bound_by=by, max_abs_err=err, experts_used=used)
            del lhs, lib
        t = per["gate"]
        recs.append(_rec(gm.KERNEL, name=f"grouped_matmul[gpt-oss-20b M={M}]",
                         max_abs_err=max(p["max_abs_err"] for p in per.values()),
                         ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=t["library_ms"],
                         library=t["library"], cases={p: v["max_abs_err"] for p, v in per.items()},
                         timed_cases={f"M{M}_{p}": v for p, v in per.items()}))
    del w, w_down
    return recs


def check_shard_shapes(rng, torch, dev) -> dict:
    """Every kernel of serve 11 and its phases at the shapes one rank
    launches it with, against its plain version (atol = rtol = ATOL; the
    KV write bit for bit). qwen3-30b-a3b at tp=2 is 16 query heads over 2
    KV heads a rank: the prefix carry over serve 2's 16-page template and
    the paged decode started from it (``check_carry``), the paged decode
    over the full table, flash prefill over serve 2's check rows (and at
    the ep/pp phases' 32 over 4); its pool row is KVH/tp*Dh = 256: the KV
    write of a decode window over the 48 layers, and a commit of 0 to 8
    accepted tokens a row; its expert GEMMs are [128, H, F/2 = 384] at
    tp=2 and [64, H, 768] at ep=2 (unowned rows in the last group, as
    ``moe_ep`` sorts them). Returns each case's max |err|."""
    from sutro_tpu_torch.ops import flash_prefill as fp
    from sutro_tpu_torch.ops import grouped_matmul as gm
    from sutro_tpu_torch.ops import kv_write as kw
    from sutro_tpu_torch.ops import paged_decode as pd
    from sutro_tpu_torch.ops import prefix_carry as pc

    nh, kvh = QNH // MESH_TP, QKVH // MESH_TP
    errs = {}
    x = _prefix_inputs(rng, torch, dev, nh=nh, kvh=kvh)
    carry, dec, _ = check_carry(torch, pc, pd, x, dev, tag="tp2_")
    errs.update({f"prefix_carry[{k}]": v for k, v in carry.items()})
    errs.update({f"paged_decode_carry[{k}]": v for k, v in dec.items()})
    base = (x["q"], x["k_pages"], x["v_pages"], x["page_table"], x["past_len"],
            x["k_cur"], x["v_cur"])
    win = dict(window=0, win_k=x["win_k"], win_v=x["win_v"], win_len=x["win_len"])
    name = "paged_decode[tp2_full_table]"
    errs[name] = check_close(name, pd.paged_decode_attention(*base, **win),
                             pd.paged_decode_plain(*base, **win))
    del x, base, win

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    bf = dict(dtype=torch.bfloat16, device=dev, generator=g)
    for tag, heads, kv_heads, Bc in (("tp2", nh, kvh, 4), ("ep2_pp2", QNH, QKVH, 2)):
        T = 1024 + 256
        q = torch.randn((Bc, T, heads, DH), **bf)
        k, v = (torch.randn((Bc, T, kv_heads, DH), **bf) for _ in range(2))
        name = f"flash_prefill[{tag}_nh{heads}_kvh{kv_heads}_T{T}]"
        errs[name] = check_close(name, fp.flash_prefill(q, k, v), fp.flash_prefill_plain(q, k, v))
        del q, k, v

    kd, layers = kvh * DH, 48
    pools = [torch.randn((layers, QNP, PS, kd), **bf) for _ in range(2)]
    table = np.zeros((QB, QMP), np.int32)
    perm = rng.permutation(np.arange(1, QNP))
    for b in range(QB):
        table[b] = perm[b * QMP: (b + 1) * QMP]
    table[3::11] = 0
    steps = 8
    past = rng.integers(0, QMP * PS - steps, QB)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    for tag, valid in (("window", np.full(QB, steps)), ("commit", rng.integers(0, steps + 1, QB))):
        new = [torch.randn((layers, QB, steps, kd), **bf) for _ in range(2)]
        args = (*new, i32(table), i32(past), i32(valid))
        got, want = [p.clone() for p in pools], [p.clone() for p in pools]
        kw.kv_write(*got, *args)
        kw.kv_write_plain(*want, *args)
        torch.cuda.synchronize()
        name = f"kv_write[tp2_kd{kd}_{tag}]"
        if not all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: pages >= 1 differ from the plain version")
        errs[name] = 0.0
        del new, args, got, want
    del pools

    for tag, (E, K, N, M) in {"tp2_gate_M512": (GE, GH, GF // MESH_TP, 512),
                              "tp2_down_M512": (GE, GF // MESH_TP, GH, 512),
                              "tp2_gate_M16384": (GE, GH, GF // MESH_TP, 16384),
                              "ep2_gate_M512": (GE // 2, GH, GF, 512),
                              "ep2_down_M16384": (GE // 2, GF, GH, 16384)}.items():
        sizes = np.bincount(rng.integers(0, E, M // 2), minlength=E)
        sizes[-1] += M - sizes.sum()    # the unowned rows (ep), or more routed ones
        lhs = torch.randn((M, K), **bf)
        rhs = torch.randn((E, K, N), **bf) * K ** -0.5
        gs = i32(sizes)
        name = f"grouped_matmul[{tag}_E{E}_N{N}]"
        errs[name] = check_close(name, gm.grouped_matmul(lhs, rhs, gs),
                                 gm.grouped_matmul_plain(lhs, rhs, gs))
        del lhs, rhs
    torch.cuda.empty_cache()
    print("kernel shard shapes: " + json.dumps(errs), flush=True)
    return errs


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels(decode: bool = False):
    """Route the no-past attention and the expert GEMMs through their
    plain versions (for the cache-free reference forward); with
    ``decode`` the paged decode and the prefix carry too."""
    from sutro_tpu_torch.ops import (
        attention, flash_prefill, grouped_matmul, moe, paged_decode, prefix_carry,
    )

    saved = (attention.flash_prefill, moe.grouped_matmul, attention.paged_decode_attention,
             attention.prefix_attention_carry)
    attention.flash_prefill = flash_prefill.flash_prefill_plain
    moe.grouped_matmul = grouped_matmul.grouped_matmul_plain
    if decode:
        attention.paged_decode_attention = paged_decode.paged_decode_plain
        attention.prefix_attention_carry = prefix_carry.prefix_attention_carry_plain
    try:
        yield
    finally:
        (attention.flash_prefill, moe.grouped_matmul, attention.paged_decode_attention,
         attention.prefix_attention_carry) = saved


@contextlib.contextmanager
def routing(record=None, replay=None, flips=None):
    """The MoE router's expert choices recorded (``record``: one
    ``top_idx`` [N, K] a call, in call order) or replayed (``replay``:
    the choices to take, call by call; each call's weights are the
    softmax of its own logits at those experts, and ``flips`` counts
    the tokens whose own top-k differs). Under random weights the
    router's margins are tiny, so bf16 rounding flips some tokens'
    experts and the flips compound through the depth
    (``check_prefill_logits`` prints them layer by layer): a check that
    holds the kernels against their plain versions replays the kernel
    run's routing in the plain run."""
    import torch
    from sutro_tpu_torch.ops import moe

    real = moe._route

    def route(xt, router, router_b, top_k):
        out = real(xt, router, router_b, top_k)
        if record is not None:
            record.append(out[0].clone())
        if replay is None:
            return out
        idx = replay[route.calls]
        route.calls += 1
        if flips is not None:
            flips.append(int((out[0].sort(-1).values != idx.sort(-1).values).any(-1).sum()))
        logits = xt.float() @ router.float()
        if router_b is not None:
            logits = logits + router_b.float()
        probs = torch.softmax(logits.gather(1, idx), dim=-1)
        M = idx.numel()
        return (idx, probs, idx.reshape(M), torch.arange(M, device=xt.device) // top_k,
                probs.reshape(M))

    route.calls = 0
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def check_prefill_logits(torch, runner, rows, label: str) -> float:
    """Prefill logits of ``rows`` (batched, through the kernels, into
    pages 1.. of the pool) against a cache-free forward of each row
    through the plain versions; for a MoE model the plain forward takes
    the kernel run's expert choices (``routing``). Returns the relative
    L2 error."""
    from sutro_tpu_torch.models import transformer

    ecfg, mcfg = runner.ecfg, runner.mcfg
    routes, flips = [], []
    with routing(record=routes):
        got = runner.prefill_batch(rows, _pack_table(rows, 0, ecfg.kv_page_size,
                                                     ecfg.max_pages_per_seq))
    ref = []
    with plain_kernels(), torch.no_grad():
        for i, r in enumerate(rows):
            # the batch's [B, T] layout: this row's first len(r) tokens
            replay = [x.reshape(len(rows), -1, x.shape[-1])[i, : len(r)] for x in routes]
            ids = torch.as_tensor(r[None], device=runner.device)
            pos = torch.arange(len(r), device=runner.device)[None]
            with routing(replay=replay if routes else None, flips=flips):
                lg, _, _ = transformer.forward(
                    mcfg, runner.params, ids, pos,
                    torch.as_tensor([len(r)], device=runner.device),
                    head_index=torch.as_tensor([len(r) - 1], device=runner.device),
                )
            ref.append(lg[0, 0].float().cpu().numpy())
    ref = np.stack(ref)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    per_layer = np.asarray(flips).reshape(len(rows), -1).sum(0).tolist() if routes else []
    pinned = (f" (the kernel run's routing; the plain router would pick other experts "
              f"for {sum(flips)} of {sum(len(r) for r in rows) * len(routes)} token-layers, "
              f"by layer {per_layer})") if routes else ""
    print(f"{label}: prefill logits vs cache-free plain forward{pinned}: rel_l2={rel:.3e} "
          f"argmax_agree={agree}/{len(rows)} max_abs={float(np.abs(got - ref).max()):.3e}",
          flush=True)
    # bf16 weights/activations through the whole depth: a relative L2
    # error of a few 1e-3 is rounding; a wrong mask, page or expert
    # would be O(1)
    if not (np.isfinite(got).all() and rel < REL_L2):
        raise AssertionError(f"{label}: prefill logits disagree with the plain forward: "
                             f"rel_l2={rel}")
    return rel


DECODE_ENTRIES = ("decode_step", "decode_multi_async")
CONSTRAINED_ENTRIES = ("decode_window", "commit_window", "verify_candidates", "verify_greedy")


def count_decode_calls(runner, calls: dict, names=DECODE_ENTRIES) -> None:
    """Count calls of the runner's entry points ``names``, and those
    calls that carried shared-prefix groups (``_with_groups``) or a
    vocabulary mask (``_masked``: a constrained row's masked step)."""
    for name in names:
        for key in ("", "_with_groups", "_masked"):
            calls.setdefault(name + key, 0)

        def counted(*a, _fn=getattr(runner, name), _name=name, **k):
            calls[_name] += 1
            calls[_name + "_with_groups"] += bool(k.get("pfx"))
            calls[_name + "_masked"] += k.get("allowed") is not None
            return _fn(*a, **k)
        setattr(runner, name, counted)


def check_full_length(runner, r) -> None:
    """Serves 1-3: every row decodes its 64 tokens (no stop ids)."""
    if r.error or r.finish_reason != "length" or len(r.token_ids) != 64:
        raise AssertionError(
            f"row {r.row_id}: {r.finish_reason!r} {len(r.token_ids)} tokens {r.error!r}")


def run_batch(torch, runner, requests, kernels, seed: int, absent=(), stop_ids=(),
              check_row=check_full_length):
    """``ContinuousBatcher.run`` with every launch counter at 0 just
    before it; returns (results, launches during the run, the batcher,
    wall). Every row must pass ``check_row``, every kernel of
    ``kernels`` must launch in the run, and none of ``absent`` (a route
    the path must not take)."""
    from sutro_tpu_torch.engine.scheduler import ContinuousBatcher

    for k in (*kernels, *absent):
        k.launches = 0
    results = {}
    batcher = ContinuousBatcher(runner, stop_ids=list(stop_ids), seed=seed)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.monotonic()
    state = batcher.run(requests, on_result=lambda r: results.__setitem__(r.row_id, r))
    sync()
    wall = time.monotonic() - t0
    launches = {k.name: k.launches for k in (*kernels, *absent)}
    if state != "completed" or len(results) != len(requests):
        raise AssertionError(f"run ended {state!r} with {len(results)}/{len(requests)} rows")
    for r in results.values():
        check_row(runner, r)
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
    return results, launches, batcher, wall


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


def decode_seconds(timer) -> float:
    """Host seconds of a timer summary's decode calls: the calls and, on
    the pipelined path, the fetches of their windows."""
    if "decode" not in timer:
        return float("nan")
    return sum(timer[k]["total_s"] for k in ("decode", "decode_fetch") if k in timer)


def serve_summary(prompts, results, launches, calls, timer, wall, rel) -> dict:
    n_prompt = int(sum(len(p) for p in prompts))
    n_gen = sum(len(r.token_ids) for r in results.values())
    pre_s = timer.get("prefill", {}).get("total_s", float("nan"))
    dec_s = decode_seconds(timer)
    return dict(rows=len(results), prompt_tokens=n_prompt, generated_tokens=n_gen,
                wall_s=wall, prefill_s=pre_s, decode_s=dec_s, decode_calls=calls,
                prefill_tok_s=n_prompt / pre_s, decode_tok_s=n_gen / dec_s,
                launches=launches, logits_rel_l2=rel, timer=timer)


def serve(torch, kernels, dev, n_requests: int = 96, seed: int = 0):
    """Serve 1: qwen3-8b, prompts of 16-500 tokens. Returns the summary
    and the runner (serve 5 writes its parameters as a checkpoint)."""
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
    results, launches, batcher, wall = run_batch(
        torch, runner, mixed_requests(prompts), kernels, seed)
    if min(calls["decode_step"], calls["decode_multi_async"]) <= 0:
        raise AssertionError(f"the batch did not take both decode paths: {calls}")
    out = serve_summary(prompts, results, launches, calls, batcher.timer.summary(), wall, rel)
    print("serve: " + json.dumps(out), flush=True)
    return out, runner


def prefill_template_rows(runner, template, rows, room: int = 1, n_groups: int = 1) -> np.ndarray:
    """The template in pages 1.. (``n_groups`` copies, one after the
    other), each of ``rows`` (template + suffix) after them in its own
    pages, with ``room`` more tokens of space a row; row i reads copy
    i % n_groups. Returns the rows' page tables."""
    ecfg = runner.ecfg
    PSz = ecfg.kv_page_size
    n_pfx = len(template) // PSz
    heads = []
    for g in range(n_groups):
        head = np.zeros((ecfg.max_pages_per_seq,), np.int32)
        head[:n_pfx] = np.arange(1 + g * n_pfx, 1 + (g + 1) * n_pfx)
        runner.prefill(template, head)
        heads.append(head)
    tables, nxt = [], 1 + n_groups * n_pfx
    for i, p in enumerate(rows):
        t = heads[i % n_groups].copy()
        n = -(-(len(p) + room) // PSz) - n_pfx
        t[n_pfx : n_pfx + n] = np.arange(nxt, nxt + n)
        nxt += n
        tables.append(t)
    tables = np.stack(tables)
    runner.prefill_batch_at([p[len(template):] for p in rows], tables,
                            [len(template)] * len(rows))
    return tables


def check_split_decode(torch, runner, template, rows, rng, label: str, n_groups: int = 1,
                       layers=(0,)):
    """The template in pages 1.. (``n_groups`` copies: ``n_groups``
    prefix groups live in one step, as a batch job's and the chats' can
    be), ``rows``' suffixes after it; then one decode step over those
    pages with and without the prefix groups. Held two ways: the
    attention output of each of ``layers`` (with the layer's window and
    sink) on the same pool (one layer of rounding: the kernel phase's
    atol = rtol), and the logits after the whole depth (rel-L2 under
    REL_L2; a MoE model's full-table step takes the split step's
    experts, ``routing``). Returns (logits rel-L2, the layers' max
    |err|, tables)."""
    from sutro_tpu_torch.models import transformer
    from sutro_tpu_torch.ops import attention

    dev, mcfg = runner.device, runner.mcfg
    n_rows = len(rows)
    n_pfx = len(template) // runner.ecfg.kv_page_size
    tables = prefill_template_rows(runner, template, rows, n_groups=n_groups)
    past = torch.as_tensor([len(p) for p in rows], dtype=torch.int32, device=dev)
    table_t = torch.as_tensor(tables, device=dev)
    ones = torch.ones((n_rows,), dtype=torch.int32, device=dev)
    member = np.arange(n_rows)[None] % n_groups == np.arange(n_groups)[:, None]
    groups = tuple(
        (torch.arange(1 + g * n_pfx, 1 + (g + 1) * n_pfx, dtype=torch.int32, device=dev),
         torch.as_tensor(np.where(member[g], len(template), 0), dtype=torch.int32, device=dev))
        for g in range(n_groups))

    # each layer's attention: random current-token q/k/v over the real
    # pool, with the layer's window and sink
    NHq, KVHq, Dh = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    bf = dict(dtype=torch.bfloat16, device=dev, generator=g)
    q = torch.randn((n_rows, 1, NHq, Dh), **bf)
    k, v = (torch.randn((n_rows, 1, KVHq, Dh), **bf) for _ in range(2))
    windows = mcfg.window_array()
    attn_err = 0.0
    for layer in layers:
        sink = runner.params["layers"]["sink"][layer] if mcfg.attention_sink else None
        akw = dict(positions=past[:, None], valid_len=ones, past_len=past, page_table=table_t,
                   past_k_pages=runner.cache.k_pages[layer],
                   past_v_pages=runner.cache.v_pages[layer], window=int(windows[layer]),
                   sink=sink)
        attn_err = max(attn_err, check_close(
            f"{label}: layer-{layer} attention (window {int(windows[layer])}) with vs without "
            "prefix groups",
            attention.chunk_attention(q, k, v, pfx_groups=groups, **akw),
            attention.chunk_attention(q, k, v, **akw)))

    ids = torch.as_tensor(rng.integers(3, 256, (n_rows, 1)), dtype=torch.int32, device=dev)
    kw = dict(paged_past=(runner.cache.k_pages, runner.cache.v_pages, table_t), past_len=past)
    routes = []   # a MoE model's full-table step takes the split step's experts
    with torch.no_grad():
        with routing(record=routes):
            split, _, _ = transformer.forward(mcfg, runner.params, ids, past[:, None], ones,
                                              pfx_groups=groups, **kw)
        with routing(replay=routes or None):
            full, _, _ = transformer.forward(mcfg, runner.params, ids, past[:, None], ones,
                                             **kw)
    split, full = split[:, 0].float().cpu().numpy(), full[:, 0].float().cpu().numpy()
    rel = float(np.linalg.norm(split - full) / np.linalg.norm(full))
    print(f"{label}: decode with vs without prefix groups: layers {list(layers)} attention "
          f"max_abs={attn_err:.3e}; logits rel_l2={rel:.3e} "
          f"argmax_agree={int((split.argmax(-1) == full.argmax(-1)).sum())}/{n_rows}",
          flush=True)
    if not (np.isfinite(split).all() and rel < REL_L2):
        raise AssertionError(f"{label}: split decode disagrees with the full table: {rel}")
    return rel, attn_err, tables


def serve_templated(torch, kernels, dev, n_requests: int = 96, seed: int = 0):
    """Serve 2: a templated classify/extract-style job on qwen3-30b-a3b
    with prefix_split on. Every request is one shared 1,024-token
    template (16 pages) and a distinct 16-256-token suffix. Returns the
    summary, the runner and what serve 11 is held against
    (``mesh_reference``)."""
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
    requests = mixed_requests(prompts)
    results, launches, batcher, wall = run_batch(torch, runner, requests, kernels, seed)
    if min(calls["decode_step_with_groups"], calls["decode_multi_async_with_groups"]) <= 0:
        raise AssertionError(f"both decode paths must run with prefix groups: {calls}")
    out = serve_summary(prompts, results, launches, calls, batcher.timer.summary(), wall,
                        max(rels))
    out["logits_rel_l2_by_rows"] = rels
    out["split_vs_full_rel_l2"] = [c[0] for c in split_checks]
    out["split_vs_full_layer0_attn_max_abs"] = [c[1] for c in split_checks]
    print("serve2: " + json.dumps(out), flush=True)
    for name in DECODE_ENTRIES:   # the counting wrappers go
        delattr(runner, name)
    ref = mesh_reference(torch, runner, prompts, results,
                         [r.row_id for r in requests if r.temperature == 0.0], seed=seed)
    return out, runner, ref


def check_verify_logits(torch, runner, template, rows, rng, label: str) -> float:
    """``rows`` (template + suffix) prefilled; then each row's next
    token through the decode forward (the paged-decode kernel, with
    the template as a prefix group, as ``decode_step`` runs it) and
    through the verify forward (``[last, 4 draft tokens]`` over the
    paged past, as ``verify_greedy``/``verify_candidates`` run it). The
    verify logits at each row's first position must match the decode
    logits within REL_L2. Returns the relative L2 error."""
    dev = runner.device
    tables = prefill_template_rows(runner, template, rows, room=5)
    n_rows = len(rows)
    past = np.array([len(p) for p in rows], np.int32)
    last = rng.integers(3, 256, n_rows).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n_pfx = len(template) // runner.ecfg.kv_page_size
    pfx = runner._pfx_up(((np.arange(1, 1 + n_pfx, dtype=np.int32),
                           np.full(n_rows, len(template), np.int32)),))
    with torch.no_grad():
        dec, _, _ = runner._trunk_decode(t(last)[:, None], t(past)[:, None], t(past),
                                         t(tables), pfx=pfx)
        ver, _, _, _ = runner._verify_forward(
            last, rng.integers(3, 256, (n_rows, 4)).astype(np.int32),
            np.full(n_rows, 4, np.int32), past, tables)
    dec, ver = dec[:, 0].float().cpu().numpy(), ver[:, 0].cpu().numpy()
    rel = float(np.linalg.norm(ver - dec) / np.linalg.norm(dec))
    print(f"{label}: verify forward vs decode forward at each row's first position: "
          f"rel_l2={rel:.3e} argmax_agree={int((ver.argmax(-1) == dec.argmax(-1)).sum())}"
          f"/{n_rows}", flush=True)
    if not (np.isfinite(ver).all() and rel < REL_L2):
        raise AssertionError(f"{label}: verify logits disagree with the decode step: {rel}")
    return rel


class MaskClock:
    """Host time the scheduler spends on constraint masks: the masked
    step's and the window recovery's ``[B, V]`` masks, admission masks,
    single-token checks of window tokens and fast-forward plans
    (outermost calls only, so nested calls count once)."""

    def __init__(self):
        from sutro_tpu_torch.engine.constrain.fsm import TokenFSM
        from sutro_tpu_torch.engine.scheduler import ContinuousBatcher

        self.ms, self.calls, self._depth, self._saved = 0.0, 0, 0, []
        for cls, name in ((ContinuousBatcher, "_fsm_masks"),
                          (ContinuousBatcher, "_constraint_mask"),
                          (ContinuousBatcher, "_token_ok"),
                          (TokenFSM, "plan_fastforward")):
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._timed(fn))

    def _timed(self, fn):
        def timed(*a, **k):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.ms += (time.perf_counter() - t0) * 1e3
                    self.calls += 1
        return timed

    def close(self):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def templated_runner(torch, model: str, dev, seed: int = 0):
    """A runner of ``model`` at serve 2's geometry (``ENGINES``), random
    weights from the seed."""
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    t0 = time.monotonic()
    runner = ModelRunner(MODEL_CONFIGS[model], EngineConfig(**ENGINES[model][0], seed=seed),
                         device=dev)
    print(f"serve4: {model} built in {time.monotonic() - t0:.1f}s", flush=True)
    return runner


def serve11_reference(torch, dev, n_requests: int = 96, seed: int = 0) -> dict:
    """Serve 11's reference when it runs alone (``--serve11-only``):
    serve 2's runner and prompts, its greedy rows run here
    (``mesh_reference``); the runner is freed before serve 11."""
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer

    model = "qwen3-30b-a3b"
    runner = templated_runner(torch, model, dev, seed)
    tok = ByteTokenizer(vocab_size=runner.mcfg.vocab_size)
    rng = np.random.default_rng(seed + 1)
    text = lambda n: "".join(rng.choice(ALPHABET, int(n)))  # noqa: E731
    template = np.asarray(tok.encode(text(ENGINES[model][1])), np.int32)
    prompts = [np.concatenate([template, np.asarray(tok.encode(text(n)), np.int32)])
               for n in rng.integers(16, 257, n_requests)]
    ref = mesh_reference(torch, runner, prompts, seed=seed)
    del runner
    free_card(torch, model)
    return ref


def serve_constrained(torch, runner, kernels, ngram_kernels, card: str,
                      n_requests: int = 96, seed: int = 0) -> dict:
    """Serve 4, on a runner of qwen3-30b-a3b's widths at CUT_LAYERS layers
    (``cut_model``; built after serve 2's runner is freed): a constrained
    templated job. Every row is one shared 1,024-token template (the
    classify system prompt at its head) and a 16-256-token suffix, 128
    new tokens at most: 64 greedy rows under the classify template's
    schema, 16 greedy under the extraction schema, 16 at temperature 0.7
    and top-p 0.9 under the classify schema (the masked single step;
    admitted first, shortest suffixes, so the later waves take the
    speculative windows and the fast-forward). Then a short phase of 16
    unconstrained greedy rows with repetitive prompts and
    ``spec_ngram_draft=4`` (``verify_greedy``). ``kernels`` must launch
    in the job, ``ngram_kernels`` in the n-gram phase."""
    import dataclasses

    from sutro_tpu_torch.engine.constrain import schema_constraint_factory
    from sutro_tpu_torch.engine.scheduler import GenRequest
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer

    mcfg, ecfg = runner.mcfg, runner.ecfg
    n_tpl = ENGINES[mcfg.name][1]
    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 3)
    text = lambda n: "".join(rng.choice(ALPHABET, int(n)))  # noqa: E731
    classify_prompt, classify_schema = classify_job()
    head = classify_prompt + "\n\n"
    template = np.asarray(tok.encode(head + text(n_tpl - len(head))), np.int32)
    if len(template) != n_tpl:
        raise AssertionError(f"serve4: template of {len(template)} tokens, not {n_tpl}")
    suffix_lens = np.sort(rng.integers(16, 257, n_requests))
    prompts = [np.concatenate([template, np.asarray(tok.encode(text(n)), np.int32)])
               for n in suffix_lens]
    verify_rel = [check_verify_logits(torch, runner, template, prompts[i : i + 8], rng,
                                      f"serve4 rows {i}-{i + 7}") for i in (0, 48)]

    t0 = time.monotonic()
    factories = {"classify": schema_constraint_factory(classify_schema, tok),
                 "extract": schema_constraint_factory(EXTRACT_SCHEMA, tok)}
    factory_s = time.monotonic() - t0
    cores = {name: f.masks.core for name, f in factories.items()}
    print(f"serve4: mask core {cores}, schema factories built in {factory_s:.2f}s "
          f"(vocabulary {mcfg.vocab_size:,})", flush=True)
    # rows 0-15 (the shortest suffixes) sampled, then alternately 4
    # greedy classify rows and one greedy extraction row
    kinds = ["sampled"] * 16 + [("classify", "classify", "classify", "classify",
                                 "extract")[i % 5] for i in range(n_requests - 16)]
    schema_of = {"sampled": classify_schema, "classify": classify_schema,
                 "extract": EXTRACT_SCHEMA}
    requests = []
    for i, (p, kind) in enumerate(zip(prompts, kinds)):
        kw = dict(temperature=0.7, top_p=0.9) if kind == "sampled" else dict(temperature=0.0)
        requests.append(GenRequest(
            row_id=i, prompt_ids=p, max_new_tokens=128,
            constraint_factory=factories["extract" if kind == "extract" else "classify"],
            **kw))
    counts = {k: kinds.count(k) for k in schema_of}
    if counts != {"sampled": 16, "classify": 64, "extract": 16}:
        raise AssertionError(f"serve4: row mix {counts}")

    def valid_row(runner_, r):
        if r.error or r.finish_reason not in ("schema_complete", "stop"):
            raise AssertionError(f"serve4 row {r.row_id}: {r.finish_reason!r} {r.error!r}")
        errs = schema_errors(schema_of[kinds[r.row_id]], tok.decode(r.token_ids))
        if errs:
            raise AssertionError(f"serve4 row {r.row_id} ({kinds[r.row_id]}) is not valid "
                                 f"under its schema: {errs}: {tok.decode(r.token_ids)!r}")

    calls = {}
    count_decode_calls(runner, calls, DECODE_ENTRIES + CONSTRAINED_ENTRIES)
    committed = {"tokens": 0, "row_windows": 0}
    commit = runner.commit_window

    def counted_commit(handle, accepted):
        # a window's rows that were live: a row accepts 0 .. steps
        # tokens; inactive slots have no pages (table row of zeros)
        live = np.asarray(runner._handles[handle.seq][3][:, 0].cpu()) > 0
        committed["tokens"] += int(np.asarray(accepted)[live].sum())
        committed["row_windows"] += int(live.sum())
        return commit(handle, accepted)

    runner.commit_window = counted_commit
    clock = MaskClock()
    try:
        results, launches, batcher, wall = run_batch(
            torch, runner, requests, kernels, seed, stop_ids=tok.stop_ids(),
            check_row=valid_row)
    finally:
        clock.close()
    timer = batcher.timer.summary()
    out = serve_summary(prompts, results, launches, calls, timer, wall, max(verify_rel))
    forced = batcher.ff_forced
    out.update(
        verify_vs_decode_rel_l2=verify_rel, mask_core=cores, schema_factories_s=factory_s,
        mask_host_ms=clock.ms, mask_host_calls=clock.calls,
        masks_cached={name: len(f.masks._cache) for name, f in factories.items()},
        ff_forced=forced, decode_tok_s_unforced=(out["generated_tokens"] - forced)
        / decode_seconds(timer),
        window_tokens_per_row=committed["tokens"] / max(committed["row_windows"], 1),
        rows_by_kind=counts,
        finish_reasons={k: sum(r.finish_reason == k for r in results.values())
                        for k in ("schema_complete", "stop")})
    print("serve4: " + json.dumps(out), flush=True)

    # n-gram speculation: 16 greedy rows whose prompts repeat a phrase
    phrases = [text(rng.integers(12, 40)) for _ in range(16)]
    ngram_prompts = [np.asarray(tok.encode((ph + " ") * (240 // (len(ph) + 1))), np.int32)
                     for ph in phrases]
    ngram_requests = [GenRequest(row_id=i, prompt_ids=p, max_new_tokens=64, temperature=0.0)
                      for i, p in enumerate(ngram_prompts)]
    ngram_calls = {}
    count_decode_calls(runner, ngram_calls, ("decode_multi_async", "verify_greedy"))
    runner.ecfg = dataclasses.replace(ecfg, spec_ngram_draft=4)
    try:
        ng_results, ng_launches, ng_batcher, ng_wall = run_batch(
            torch, runner, ngram_requests, ngram_kernels, seed)
    finally:
        runner.ecfg = ecfg
    ng = serve_summary(ngram_prompts, ng_results, ng_launches, ngram_calls,
                       ng_batcher.timer.summary(), ng_wall, None)
    ng.update(spec_drafted=ng_batcher.spec_drafted, spec_accepted=ng_batcher.spec_accepted)
    print("serve4 n-gram: " + json.dumps(ng), flush=True)

    entry_calls = {"decode_window": calls["decode_window"],
                   "commit_window": calls["commit_window"],
                   "verify_candidates": calls["verify_candidates"],
                   "verify_greedy": ngram_calls["verify_greedy"] + calls["verify_greedy"],
                   "decode_step_masked": calls["decode_step_masked"]}
    if min(entry_calls.values()) <= 0:
        raise AssertionError(f"serve4: a constrained entry point was not called: "
                             f"{entry_calls}")
    out["entry_calls"] = entry_calls
    out["ngram"] = ng
    print(f"serve4: card={card} prefill_tok_s={out['prefill_tok_s']:.1f} "
          f"decode_tok_s={out['decode_tok_s']:.1f} (unforced "
          f"{out['decode_tok_s_unforced']:.1f}, {forced} fast-forward tokens) "
          f"mask_host_ms={clock.ms:.1f} mask_core={cores} window tokens a row "
          f"{out['window_tokens_per_row']:.2f}/{ecfg.decode_multi_step} wall_s={wall:.2f}; "
          f"n-gram phase "
          f"decode_tok_s={ng['decode_tok_s']:.1f} accepted {ng['spec_accepted']}/"
          f"{ng['spec_drafted']} drafted, wall_s={ng_wall:.2f}", flush=True)
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
    results, launches, batcher, wall = run_batch(
        torch, runner, mixed_requests(prompts), kernels, seed, absent=absent)
    if min(calls["decode_step"], calls["decode_multi_async"]) <= 0:
        raise AssertionError(f"the batch did not take both decode paths: {calls}")
    out = serve_summary(prompts, results, launches, calls, batcher.timer.summary(), wall, rel)
    out["layer0_int8_attn_max_abs"] = attn_err
    out["long_prompts"] = len(long_)
    print("serve3: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# serve 5: jobs through the façade, on weights loaded from a checkpoint
# ---------------------------------------------------------------------------

CKPT_SHARD_BYTES = 4e9   # HF's usual shard size


def flat_leaves(params, prefix: str = ""):
    """(dotted name, tensor) of every leaf of a parameter dict."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from flat_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def hf_tensors(params, mcfg) -> list:
    """[(HF name, tensor)] of a dense Qwen3 parameter dict in the layout
    ``load_checkpoint`` reads: projections back to ``[out, in]`` (views;
    made contiguous one at a time by the writer). Every leaf is used."""
    lay, used = params["layers"], {"embed", "final_norm"}

    def leaf(key, i):
        used.add(f"layers.{key}")
        return lay[key][i]

    out = [("model.embed_tokens.weight", params["embed"]),
           ("model.norm.weight", params["final_norm"])]
    if "lm_head" in params:
        out.append(("lm_head.weight", params["lm_head"].T))
        used.add("lm_head")
    for i in range(mcfg.num_layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", leaf("attn_norm", i)),
                (p + "post_attention_layernorm.weight", leaf("mlp_norm", i)),
                (p + "self_attn.q_norm.weight", leaf("q_norm", i)),
                (p + "self_attn.k_norm.weight", leaf("k_norm", i))]
        out += [(p + f"self_attn.{x}_proj.weight", leaf(f"w{x}", i).T) for x in "qkvo"]
        out += [(p + f"mlp.{x}_proj.weight", leaf(f"w_{x}", i).T)
                for x in ("gate", "up", "down")]
    missing = {n for n, _ in flat_leaves(params)} - used
    if missing:
        raise AssertionError(f"serve5: leaves the checkpoint writer does not map: {missing}")
    return out


def write_checkpoint(torch, params, mcfg, ckpt_dir: Path) -> dict:
    """The parameters as an HF safetensors checkpoint of ~4 GB bf16
    shards plus ``model.safetensors.index.json``, written by hand (an
    8-byte little-endian header length, the JSON header, the raw
    tensors); one tensor at a time is on the host."""
    tensors = hf_tensors(params, mcfg)
    shards, cur, size = [], [], 0
    for name, t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and size + nbytes > CKPT_SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append((name, t))
        size += nbytes
    shards.append(cur)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for name, t in shard:
            n = t.numel() * t.element_size()
            header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + n]}
            off += n
            weight_map[name] = fname
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(ckpt_dir / fname, "wb") as f:
            f.write(len(head).to_bytes(8, "little"))
            f.write(head)
            for name, t in shard:
                if t.dtype != torch.bfloat16:
                    raise AssertionError(f"serve5: {name} is {t.dtype}, not bfloat16")
                f.write(t.contiguous().view(torch.int16).cpu().numpy().data)
        total += off
    (ckpt_dir / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return {"bytes": total, "shards": len(shards), "tensors": len(tensors)}


def checkpoint_root(home: Path, need: float) -> Path:
    """Where the checkpoint goes: under ``home`` (the temporary
    ``SUTRO_HOME``, removed at exit), which must have room for ``need``
    bytes and a tenth more."""
    import shutil

    free = shutil.disk_usage(home).free
    print(f"serve5: {free / 1e9:.1f} GB free under {home} for a {need / 1e9:.1f} GB "
          "checkpoint", flush=True)
    if free <= 1.1 * need:
        raise AssertionError(f"serve5: no room for the checkpoint under {home}")
    return home / "weights"


def _record_s(rec: dict, a: str, b: str) -> float:
    from datetime import datetime

    return (datetime.fromisoformat(rec[b]) - datetime.fromisoformat(rec[a])).total_seconds()


def serve_facade(torch, runners: list, kernels, absent, card: str, home: Path,
                 n_rows: int = 48, seed: int = 0) -> dict:
    """Serve 5: serve 1's qwen3-8b parameters written as an HF checkpoint,
    then jobs through ``import sutro_tpu_torch as so`` on an engine that
    loads it (``$SUTRO_HOME/engine.json``: serve 1's geometry,
    ``prefix_split`` and ``weights_dir``). Job A: a classify job (the
    template's prompt and schema, four labels with descriptions) of
    ``n_rows`` rows of 16-400 tokens, greedy, at most 96 new tokens (or
    the schema's room). Job B: ``n_rows`` rows of 16-500 tokens, 64 new
    tokens, as two ``so.infer`` jobs: three in four rows greedy, one in
    four at temperature 0.7 and top-p 0.9 with ``random_seed_per_input``
    (sampling parameters are a job's, not a row's). Both submitted
    before A starts, so B's jobs attach to A's co-batched session.
    Then, on the engine's runner, ``check_split_decode`` over job A's
    shared head and two sets of 8 of its rows. ``runners`` holds serve 1's runner, which is taken out and freed
    here once the checkpoint is written (the caller keeps no other
    reference). The checkpoint stays for serve 7, which removes it."""
    import gc
    import threading

    import sutro_tpu_torch as so
    from sutro_tpu_torch.engine import api, weights
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch

    runner = runners.pop()
    mcfg = runner.mcfg
    t0 = time.monotonic()
    want = leaf_checksums(torch, runner.params)
    sum_s = time.monotonic() - t0
    need = float(sum(t.numel() * t.element_size() for _, t in flat_leaves(runner.params)))
    root = checkpoint_root(home, need)
    t0 = time.monotonic()
    ckpt = write_checkpoint(torch, runner.params, mcfg, root / mcfg.name)
    write_s = time.monotonic() - t0
    print(f"serve5: checkpoint of {ckpt['tensors']} tensors, {ckpt['bytes'] / 1e9:.2f} GB in "
          f"{ckpt['shards']} shards written to {root} in {write_s:.1f}s "
          f"(checksums {sum_s:.1f}s)", flush=True)
    # serves 7, 9 and 10 load the first CUT_LAYERS layers (step 0 of
    # serve 11's slice: their checks do not need the depth)
    t0 = time.monotonic()
    cut = cut_model(mcfg.name)
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    cut_ckpt = write_checkpoint(torch, first_layers(runner.params, CUT_LAYERS),
                                MODEL_CONFIGS[cut], root / cut)
    print(f"serve5: {cut}'s checkpoint of {cut_ckpt['bytes'] / 1e9:.2f} GB written in "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    runner = None
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve5: serve 1's runner freed: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          "allocated", flush=True)
    (home / "engine.json").write_text(json.dumps(
        {**ENGINES[mcfg.name][0], "prefix_split": True, "weights_dir": str(root), "seed": seed}))

    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 5)
    text = lambda n: "".join(rng.choice(ALPHABET, int(n)))  # noqa: E731
    prompt, schema = classify_job(FACADE_CLASSES)
    rows_a = [text(n) for n in rng.integers(16, 401, n_rows)]
    rows_b = [text(n) for n in rng.integers(16, 501, n_rows)]
    jobs = {  # name -> (rows, infer kwargs)
        "A": (rows_a, dict(output_schema=schema, system_prompt=prompt,
                           sampling_params={"temperature": 0.0, "max_new_tokens": 96})),
        "B": ([r for i, r in enumerate(rows_b) if i % 4 != 3],
              dict(sampling_params={"temperature": 0.0, "max_new_tokens": 64})),
        "B top-p": ([r for i, r in enumerate(rows_b) if i % 4 == 3],
                    dict(random_seed_per_input=True,
                         sampling_params={"temperature": 0.7, "top_p": 0.9,
                                          "max_new_tokens": 64})),
    }

    load = {}
    real_load = weights.load_checkpoint

    def timed_load(*a, **k):
        t = time.monotonic()
        try:
            return real_load(*a, **k)
        finally:
            load["s"] = time.monotonic() - t

    # each row's finish data as the scheduler hands it to the job's
    # session: job id -> row id -> (tokens generated, finish reason)
    finished = {}
    real_on_result = api._GenSession.on_result

    def on_result(session, res):
        finished.setdefault(session.job_id, {})[res.row_id] = (len(res.token_ids),
                                                               res.finish_reason)
        return real_on_result(session, res)

    weights.load_checkpoint = timed_load
    api._GenSession.on_result = on_result
    for k in (*kernels, *absent):
        k.launches = 0
    ids, progress, threads = {}, {}, []
    try:
        t_submit = time.monotonic()
        for name, (rows, kw) in jobs.items():
            jid = so.infer(rows, model="qwen-3-8b", stay_attached=False, **kw)
            if jid is None:
                raise AssertionError(f"serve5: job {name} was refused")
            ids[name] = jid
            submit_s = time.monotonic() - t_submit

            def follow(jid=jid):
                for u in so.Sutro().engine.stream_job_progress(jid):
                    if u["update_type"] == "progress":
                        progress[jid] = u["result"]

            threads.append(threading.Thread(target=follow, daemon=True))
            threads[-1].start()
        engine = so.Sutro().engine
        while engine.job_status(ids["A"]) in ("QUEUED", "STARTING"):
            time.sleep(0.01)
        to_running = time.monotonic() - t_submit
        for name, jid in ids.items():
            if so.await_job_completion(jid, timeout=900, obtain_results=False) != jid:
                raise AssertionError(f"serve5: job {name} ended {engine.job_status(jid)}: "
                                     f"{engine.get_job(jid)['failure_reason']}")
        wall = time.monotonic() - t_submit
        for t in threads:
            t.join(timeout=60)
        launches = {k.name: k.launches for k in (*kernels, *absent)}
    finally:
        weights.load_checkpoint = real_load
        api._GenSession.on_result = real_on_result

    out = {"card": card, "checkpoint": {**ckpt, "dir": str(root), "write_s": write_s,
                                        "cut_model": cut,
                                        "load_s": load.get("s")},
           "submit_s": submit_s, "submit_to_running_s": to_running, "wall_s": wall,
           "rows_per_s": sum(len(r) for r, _ in jobs.values()) / wall, "jobs": {}}
    for name, (rows, kw) in jobs.items():
        jid = ids[name]
        rec = engine.get_job(jid)
        res = engine.job_results(jid, include_inputs=True)
        cols = engine.jobs.read_results(jid)
        if res["inputs"] != rows or cols["row_id"] != list(range(len(rows))) or len(
                res["outputs"]) != len(rows) or "errors" in res:
            raise AssertionError(f"serve5: job {name}'s results are not 1:1 with its inputs")
        # the record's row count and the results' token counts and
        # reasons against the rows' finish data
        fin = [finished.get(jid, {}).get(i) for i in range(len(rows))]
        if rec["num_rows"] != len(rows) or len(finished.get(jid, {})) != len(rows) or (
                [f and f[0] for f in fin] != cols["gen_tokens"]) or (
                [f and f[1] for f in fin] != cols["finish_reason"]):
            raise AssertionError(f"serve5: job {name}'s record ({rec['num_rows']} rows) or "
                                 f"results disagree with its rows' finish data: {fin}")
        for i, (o, (n, reason)) in enumerate(zip(res["outputs"], fin)):
            if name == "A":
                errs = schema_errors(schema, o)
                if errs or reason not in ("schema_complete", "stop"):
                    raise AssertionError(f"serve5: job A row {i} ({reason}): {errs}: {o!r}")
            elif not (reason == "stop" or (reason == "length" and n == 64)):
                raise AssertionError(f"serve5: job {name} row {i}: {reason!r}, {n} tokens")
        if progress.get(jid) != len(rows):
            raise AssertionError(f"serve5: job {name}'s progress stream ended at "
                                 f"{progress.get(jid)}, not {len(rows)}")
        n_in = sum(len(x) for x in encode_chat_batch(tok, rows, kw.get("system_prompt"),
                                                   mcfg.chat_template))
        n_out = sum(len(tok.encode(o)) for o in res["outputs"] if o)
        if (rec["input_tokens"], rec["output_tokens"]) != (n_in, n_out):
            raise AssertionError(f"serve5: job {name} record counts {rec['input_tokens']} in, "
                                 f"{rec['output_tokens']} out; the rows sum to {n_in}, {n_out}")
        perf = rec["perf"]
        if perf["cobatch"]["session_job"] != ids["A"]:
            raise AssertionError(f"serve5: job {name} did not run in job A's session: {perf}")
        # output_tokens: the outputs' text encoded again, as the record
        # counts them (random weights: mostly bytes that decode to
        # nothing); generated_tokens: the rows' finish data
        out["jobs"][name] = {
            "rows": len(rows), "status": rec["status"],
            "wall_s": _record_s(rec, "datetime_created", "datetime_completed"),
            "run_s": _record_s(rec, "datetime_started", "datetime_completed"),
            "input_tokens": n_in, "output_tokens": n_out,
            "generated_tokens": sum(f[0] for f in fin),
            "jobstore_flush_ms": 1e3 * perf.get("jobstore_flush", {}).get("total_s", 0.0),
            "jobstore_finalize_ms": 1e3 * perf["jobstore_finalize"]["total_s"],
            "finish_reasons": {r: cols["finish_reason"].count(r)
                               for r in sorted(set(cols["finish_reason"]))},
            "max_new_tokens": rec["sampling_params"]["max_new_tokens"],
        }
    # the session's whole timer: the perf of the job that finished last
    last = max((engine.get_job(j) for j in ids.values()),
               key=lambda r: r["datetime_completed"])["perf"]
    n_in = sum(j["input_tokens"] for j in out["jobs"].values())
    n_gen = sum(j["generated_tokens"] for j in out["jobs"].values())
    # the records hold the session's times, not a job's: rates are the
    # session's (every job's tokens over them)
    out["session"] = {"prefill_s": last["prefill"]["total_s"],
                      "decode_s": decode_seconds(last),
                      "prompt_tok_s": n_in / last["prefill"]["total_s"],
                      "decode_tok_s": n_gen / decode_seconds(last),
                      "decode_calls": last["decode"]["count"]}
    runner5 = engine._runner_cache[mcfg.name][0]
    got = leaf_checksums(torch, runner5.params)
    if got != want:
        bad = sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))
        raise AssertionError(f"serve5: loaded leaves differ from serve 1's: {bad[:8]}")
    out["leaves_bit_equal"] = len(got)
    # both carry kernels at this serve's shape (KVH=8 behind the classify
    # prompt's shared pages), on the loaded runner after the jobs: a
    # decode step of two sets of 8 of job A's rows with and without the
    # prefix group, as serve 2 checks its own
    prompts = [np.asarray(p, np.int32) for p in encode_chat_batch(
        tok, rows_a, prompt, mcfg.chat_template)]
    template = shared_head(prompts, runner5.ecfg.kv_page_size)
    if len(template) // PS != facade_prefix_pages():
        raise AssertionError(f"serve5: job A's prompts share {len(template)} tokens, not "
                             f"the kernel phase's {facade_prefix_pages()} pages")
    split_checks = [check_split_decode(torch, runner5, template, prompts[i : i + 8], rng,
                                       f"serve5 rows {i}-{i + 7}") for i in (0, 8)]
    out["shared_prefix_tokens"] = len(template)
    out["split_vs_full_rel_l2"] = [c[0] for c in split_checks]
    out["split_vs_full_layer0_attn_max_abs"] = [c[1] for c in split_checks]
    del split_checks
    out["launches"] = launches
    for k in kernels:
        if launches[k.name] <= 0:
            raise AssertionError(f"serve5: kernel {k.name} was not launched by the jobs")
    for k in absent:
        if launches[k.name]:
            raise AssertionError(f"serve5: kernel {k.name} launched {launches[k.name]} times")
    print("serve5: " + json.dumps(out), flush=True)
    print(f"serve5: card={card} submit_s={submit_s:.2f} submit_to_running_s={to_running:.2f} "
          f"checkpoint write_s={write_s:.1f} load_s={load.get('s', float('nan')):.1f} "
          f"wall_s={wall:.2f} rows_per_s={out['rows_per_s']:.2f} session prompt_tok_s="
          f"{out['session']['prompt_tok_s']:.1f} decode_tok_s="
          f"{out['session']['decode_tok_s']:.1f} " + " ".join(
              f"[{n}: wall_s={j['wall_s']:.2f} flush+finalize_ms="
              f"{j['jobstore_flush_ms'] + j['jobstore_finalize_ms']:.1f}]"
              for n, j in out["jobs"].items()), flush=True)
    # the engine's runner must go before the next serve
    engine.close(timeout=30)
    engine._runner_cache.clear()
    so._instance._engine = None
    api.reset_engine()
    return out


# ---------------------------------------------------------------------
# serve 7: online serving over HTTP beside a batch job
# ---------------------------------------------------------------------


def metrics_histogram(text: str, name: str) -> dict:
    """Count, sum and the p50/p99 bucket bounds of a Prometheus
    histogram in ``/metrics`` text (every series summed)."""
    buckets, count, total = {}, 0.0, 0.0
    for line in text.splitlines():
        if line.startswith(name + "_bucket{"):
            le = line.split('le="')[1].split('"')[0]
            val = float(line.split("}")[1].split()[0])
            buckets[float(le)] = buckets.get(float(le), 0.0) + val
        elif line.startswith(name + "_count"):
            count += float(line.split()[1])
        elif line.startswith(name + "_sum"):
            total += float(line.split()[1])

    def q(frac):
        for le in sorted(buckets):
            if count and buckets[le] >= frac * count:
                return le
        return None

    return {"count": int(count), "sum_s": total, "p50_le_s": q(0.5), "p99_le_s": q(0.99)}


def stage_seconds(text: str, stage: str) -> tuple:
    """(seconds, samples) of one stage in ``/metrics`` text's
    ``sutro_stage_seconds`` histogram (every scheduler's timer feeds it)."""
    sel = '{stage="%s"}' % stage
    got = {}
    for line in text.splitlines():
        for part in ("_sum", "_count"):
            if line.startswith(f"sutro_stage_seconds{part}{sel}"):
                got[part] = float(line.split()[-1])
    return got.get("_sum", 0.0), int(got.get("_count", 0))


def metric_total(text: str, name: str) -> float:
    return sum(float(line.split()[-1]) for line in text.splitlines()
               if line.startswith(name) and not line.startswith("#")
               and line[len(name)] in "{ ")


def quantiles(xs) -> dict:
    xs = np.asarray(xs, np.float64)
    if not len(xs):
        return {"n": 0}
    return {"n": int(len(xs)), "p50_s": float(np.percentile(xs, 50)),
            "p99_s": float(np.percentile(xs, 99)), "max_s": float(xs.max())}


def serve_online(torch, kernels, absent, card: str, ckpt_root: Path, *, model="qwen3-8b",
                 device="cuda", geometry=None, n_rows=256, n_sessions=16, n_stream=12,
                 n_oneshot=4, n_new=64, system_chars=1000, burst_after=64, seed=0) -> dict:
    """Serve 7: the port's online-serving path on the checkpoint serve 5
    wrote, over HTTP. A new ``LocalEngine`` (serve 1's geometry,
    ``prefix_split``, ``interactive_slots=8``, the prefix store on, as by
    default, ``kv_tiers=True``, and an admission budget of the pool's
    tokens, ``decode_batch_size * max_model_len``) behind
    ``start_server_thread`` on 127.0.0.1. Batch job B: ``n_rows`` rows of 16-500 characters under
    one ~1,024-token system prompt S, ``n_new`` new tokens, greedy,
    priority 1, through ``Sutro(backend="remote")``, its progress read
    as NDJSON. Once B passes ``burst_after`` rows: ``n_sessions`` chat
    sessions, 0.25
    s apart, 3 turns each with a sticky ``session_id`` (S as the system
    prompt, user turns of 32-128 characters, ``n_new`` tokens,
    temperature 0; ``n_stream`` stream over SSE, the rest are collected),
    and ``n_oneshot`` one-shot ``/v1/completions``. After turn 2 every
    session idles and ``gateway.checkpoint_idle(0)`` demotes their pages
    to the host tier, so turn 3 promotes them. Then 4 requests replayed
    one at a time on the idle engine, streamed and collected; a
    graceful shutdown with two streams in flight; and, on the engine's
    runner, a warm request's first-step logits against its cold prefill
    and ``check_split_decode`` over two sets of 8 of B's rows behind S's
    shared pages (one prefix group, then two live in one step). The
    runner's head has its columns zeroed before any job, but for the
    printable ASCII bytes' and the stop ids', so that greedy picks
    characters: the replies have text, and a client can time their
    deltas (each replay runs again with a stop string taken from its
    reply, and must end ``stop`` just before it, streamed and
    collected); the logits checks run on the whole head, restored.
    ``kernels`` must launch on the path, ``absent`` must not (both empty
    on the CPU, where the plain versions run)."""
    import threading
    import traceback
    import urllib.error
    import urllib.request

    from sutro_tpu_torch.engine import kvtier
    from sutro_tpu_torch.engine.api import LocalEngine
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.kvcache import pages_needed
    from sutro_tpu_torch.engine.scheduler import ContinuousBatcher
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    from sutro_tpu_torch.sdk import Sutro
    from sutro_tpu_torch.server import _graceful_shutdown, start_server_thread

    mcfg = MODEL_CONFIGS[model]
    geometry = geometry or ENGINES[model][0]
    # the default budget (32,768) counts S in every row's worst-case
    # total, though S's pages are shared, and held B's steps at ~12 of
    # 64 rows: this one is what the pool holds
    ecfg = EngineConfig(**geometry, prefix_split=True, weights_dir=str(ckpt_root), seed=seed,
                        interactive_slots=8, kv_tiers=True,
                        max_batch_tokens=geometry["decode_batch_size"] * geometry["max_model_len"])
    PSz = ecfg.kv_page_size
    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 7)
    text = lambda r, n: "".join(r.choice(ALPHABET, int(n)))  # noqa: E731
    system = online_system_prompt(rng, system_chars)
    rows_b = [text(rng, n) for n in rng.integers(16, 501, n_rows)]
    catalog = {"qwen3-8b": "qwen-3-8b"}.get(model, model)

    # the tier's prefix-page moves: each demoted page's payload as the
    # runner read it, and the pages each promotion uploaded into, while
    # no later demotion has taken them again
    demoted, live, moved = {}, {}, {"demote": 0, "promote": 0}

    def observe(kind, keys, page_ids, payload):
        moved[kind] += len(keys)
        for j, (key, page) in enumerate(zip(keys, page_ids)):
            if kind == "demote":
                demoted[key] = {k: v[:, j : j + 1] for k, v in payload.items()}
                live.pop(int(page), None)
            else:
                live[int(page)] = key

    ContinuousBatcher.tier_observer = staticmethod(observe)
    engine = LocalEngine(ecfg, device=device)
    srv, srv_thread, url = start_server_thread(engine)
    gw = engine.gateway
    irs = {}   # request id -> InteractiveRequest (the terminal record's text)
    real_submit = gw.submit

    def submit(sreq, trace_id=None):
        ir = real_submit(sreq, trace_id=trace_id)
        irs[ir.id] = ir
        return ir

    gw.submit = submit
    # random weights put almost every greedy token above the byte
    # tokenizer's 256 byte ids, where a token has no text: a reply would
    # be empty and a client could time no delta. Zeroing the head's
    # columns but for the printable ASCII bytes' and the stop ids', before
    # any job runs, makes greedy pick a character (one token each) or
    # stop; the head comes back whole for the logits checks
    runner = engine._get_runner(mcfg.name, mcfg)[0]
    head = runner.params.get("lm_head")
    if head is not None:
        keep = torch.as_tensor([*range(32, 127), *tok.stop_ids()], device=head.device)
        with torch.no_grad():
            whole = head.clone()
            head.zero_()
            head[:, keep] = whole[:, keep]
    c = Sutro(backend="remote", base_url=url, api_key="smoke")
    errors, lock = [], threading.Lock()
    # the card's busy share, as nvidia-smi samples it (the share of each
    # 250 ms period in which a kernel ran), beside the phases' times
    util, smi = [], None
    if device != "cpu":
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "250"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def sample():
            for line in smi.stdout:
                if line.strip().isdigit():
                    util.append((time.monotonic(), int(line)))

        threading.Thread(target=sample, daemon=True).start()
    metrics_start = c.get_metrics_text()
    for k in (*kernels, *absent):
        k.launches = 0
    t_start = time.monotonic()
    try:
        # -- batch job B, followed over its NDJSON stream ------------------
        jid = c.infer(rows_b, model=catalog, system_prompt=system, job_priority=1,
                      stay_attached=False,
                      sampling_params={"temperature": 0.0, "max_new_tokens": n_new})
        if jid is None:
            raise AssertionError("serve7: job B was refused")
        progress, tokens_seen, end = [], [], []

        def follow():
            resp = c.do_request("get", f"stream-job-progress/{jid}", stream=True)
            resp.raise_for_status()
            for line in resp.iter_lines():
                if not line:
                    continue
                u = json.loads(line)
                now = time.monotonic()
                if u.get("t") == "end":
                    end.append(u)
                elif u["update_type"] == "progress":
                    progress.append((now, int(u["result"])))
                elif u["update_type"] == "tokens" and "output_tokens" in u["result"]:
                    tokens_seen.append((now, int(u["result"]["output_tokens"])))

        follower = threading.Thread(target=follow, daemon=True)
        follower.start()
        while not progress or progress[-1][1] <= burst_after:
            if not follower.is_alive() or time.monotonic() - t_start > 600:
                raise AssertionError(f"serve7: job B stalled at {progress[-1:]}: "
                                     f"{c.get_job_status(jid)}")
            time.sleep(0.02)

        # -- the interactive burst -----------------------------------------
        t_burst = time.monotonic()
        barrier = threading.Barrier(n_sessions + 1, timeout=900)
        turn3 = threading.Event()
        ttft, itl, replies = [], [], []

        def chat(messages, sid, stream):
            t0 = time.monotonic()
            if not stream:
                out = c.chat(messages, model=catalog, max_tokens=n_new, temperature=0.0,
                             session_id=sid)
                ch = out["choices"][0]
                return out["id"], ch["message"]["content"], ch["finish_reason"]
            parts, times, rid, finish = [], [], None, None
            for chunk in c.chat(messages, model=catalog, stream=True, max_tokens=n_new,
                                temperature=0.0, session_id=sid):
                rid = chunk["id"]
                ch = chunk["choices"][0]
                if ch["delta"].get("content"):
                    parts.append(ch["delta"]["content"])
                    times.append(time.monotonic())
                finish = ch["finish_reason"] or finish
            with lock:
                if times:
                    ttft.append(times[0] - t0)
                    itl.extend(np.diff(times).tolist())
            return rid, "".join(parts), finish

        def session(i):
            r = np.random.default_rng(seed + 100 + i)
            try:
                for turn in range(3):
                    if turn == 2:
                        barrier.wait()
                        turn3.wait(900)
                    msgs = [{"role": "system", "content": system},
                            {"role": "user", "content": text(r, r.integers(32, 129))}]
                    rid, content, finish = chat(msgs, f"s{i}", i < n_stream)
                    with lock:
                        replies.append((rid, content, finish, i < n_stream, f"s{i}/{turn}"))
            except Exception:  # noqa: BLE001 — reported below
                errors.append(traceback.format_exc())
                barrier.abort()

        def oneshot(i):
            r = np.random.default_rng(seed + 200 + i)
            try:
                out = c._remote_json("post", "v1/completions", json={
                    "model": catalog, "prompt": text(r, r.integers(20, 50)),
                    "max_tokens": n_new, "temperature": 0.0})
                ch = out["choices"][0]
                with lock:
                    replies.append((out["id"], ch["text"], ch["finish_reason"], False,
                                    f"oneshot{i}"))
            except Exception:  # noqa: BLE001
                errors.append(traceback.format_exc())

        threads = []
        for i in range(n_sessions):
            threads.append(threading.Thread(target=session, args=(i,), daemon=True))
            threads[-1].start()
            if i < n_oneshot:
                threads.append(threading.Thread(target=oneshot, args=(i,), daemon=True))
                threads[-1].start()
            time.sleep(0.25)
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            raise AssertionError("serve7: a session failed before turn 3:\n" + "\n".join(errors))
        posted = gw.checkpoint_idle(0.0)
        turn3.set()
        for t in threads:
            t.join(timeout=900)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError("serve7: interactive requests failed:\n" + "\n".join(errors))
        t_burst_end = time.monotonic()
        metrics_burst = c.get_metrics_text()
        # the live monitor over HTTP, its window over the burst: the
        # interactive p99s and the stock TTFT rule's state, then two
        # ticks of its NDJSON stream. It is read after one tick past the
        # burst's end, so that the window holds the burst's last samples
        # (a burst shorter than the tick interval can end after the last
        # tick)
        ticks_at_end = c.get_monitor()["ticks"]
        deadline = time.monotonic() + 30
        while True:
            mon = c.get_monitor()
            if mon["ticks"] > ticks_at_end or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        ttft_rule = next(r for r in mon["rules"] if r["name"] == "interactive_ttft_p99")
        resp = c.do_request("get", "monitor/stream?ticks=2", stream=True)
        resp.raise_for_status()
        ticks = [json.loads(line) for line in resp.iter_lines() if line]
        monitor = {"ticks": mon["ticks"], "ttft_p99_s": mon["stats"].get("ttft_p99_s"),
                   "itl_p99_s": mon["stats"].get("itl_p99_s"),
                   "ttft_rule": {k: ttft_rule[k] for k in ("state", "value", "threshold")},
                   "stream_records": [r["t"] for r in ticks]}
        if (mon["ticks"] < 1 or monitor["ttft_p99_s"] is None or monitor["itl_p99_s"] is None
                or [r["t"] for r in ticks[:2]] != ["tick", "tick"]):
            raise AssertionError(f"serve7: the monitor over HTTP: {monitor}")
        if c.await_job_completion(jid, obtain_results=False, timeout=900) != jid:
            raise AssertionError(f"serve7: job B ended {c.get_job_status(jid)}")
        follower.join(timeout=60)
        t_b_end = time.monotonic()
        metrics_b = c.get_metrics_text()
        # B's session timer: its phases' host time, kv_demote and
        # kv_promote (tier reads, writes and int8 math) among them
        b_perf = {k: {"total_s": v["total_s"], "count": v["count"]}
                  for k, v in c._fetch_job(jid)["perf"].items()
                  if isinstance(v, dict) and "total_s" in v}

        # -- checks: B, the replies, the store, the tier -------------------
        res = c._remote_json("post", "job-results", json={
            "job_id": jid, "include_inputs": True, "include_cumulative_logprobs": True})[
                "results"]
        if res["inputs"] != rows_b or len(res["outputs"]) != n_rows or "errors" in res or not all(
                0 <= g <= n_new for g in res["gen_tokens"]):
            raise AssertionError("serve7: job B's results are not 1:1 with its rows: "
                                 f"{len(res['outputs'])} outputs, errors "
                                 f"{res.get('errors')}, gen_tokens {res['gen_tokens']}")
        if end != [{"t": "end", "status": "SUCCEEDED"}] or progress[-1][1] != n_rows:
            raise AssertionError(f"serve7: B's stream ended {end} at {progress[-1:]}")
        for rid, content, finish, streamed, label in replies:
            rec = irs[rid].channel.result
            if finish not in ("stop", "length") or rec is None or (
                    rec["finish_reason"] not in ("stop", "length")):
                raise AssertionError(f"serve7: {label} ended {finish!r}, {rec}")
            if content != rec["text"]:
                raise AssertionError(f"serve7: {label}'s deltas differ from its final text")
        if len(replies) != 3 * n_sessions + n_oneshot:
            raise AssertionError(f"serve7: {len(replies)} replies")
        finishes = {"stop": [0, 0], "length": [0, 0]}   # [streamed, collected]
        for _, _, finish, streamed, _ in replies:
            finishes[finish][0 if streamed else 1] += 1
        # no chat turn may prefill S's pages again: each skips them,
        # found warm in the store (B's shell put them there) or promoted
        # from the tier (once B is done, S's pages can be demoted with
        # the idle sessions'); and the gateway's submit-time probe must
        # find them in the store for some
        s_head = len(shared_head([np.asarray(x, np.int32) for x in encode_chat_batch(
            tok, ["first user turn", "another one"], system, mcfg.chat_template)], PSz))
        chats = [irs[rid] for rid, *_, label in replies if label.startswith("s")]
        chat_warm = [ir.warm_tokens for ir in chats]
        chat_saved = [ir.ctx.prefix_saved for ir in chats]
        if not s_head or min(chat_saved) < s_head or max(chat_warm) < s_head:
            raise AssertionError(f"serve7: chat turns skipped {min(chat_saved)} tokens and found "
                                 f"up to {max(chat_warm)} warm, not S's {s_head}")
        store = engine._prefix_stores[mcfg.name]
        tier = engine._kv_tiers[mcfg.name]
        tier.drain(30)
        ids = sorted(set(live) & set(store.owned_pages()))
        worst, checked = 0.0, len(ids)
        for i in range(0, len(ids), 8):
            got = runner.read_pages(ids[i : i + 8])
            for j, page in enumerate(ids[i : i + 8]):
                raw = demoted[live[page]]
                q = kvtier.quantize_payload(raw)
                for k in "kv":
                    deq = q[k].astype(np.float32) * q[k + "s"][..., None]
                    bound = q[k + "s"][..., None] / 2 + np.abs(deq) * 2.0 ** -8 + 1e-6
                    err = np.abs(got[k][:, j : j + 1] - raw[k])
                    worst = max(worst, float((err / bound).max()))
        if not checked or worst > 1.0:
            raise AssertionError(f"serve7: {checked} promoted pages checked, worst error "
                                 f"{worst:.3f} of the int8 round-trip bound")
        census = tier.op_census()
        store_stats = {"hits": store.hits, "misses": store.misses,
                       "tokens_saved": store.tokens_saved, "pages": store.n_pages,
                       "evictions": store.evictions, "demotions": store.demotions,
                       "promotions": store.promotions}
        if store.hits < 2 or census["promotes"] < 1 or census["demotes"] < 1 or posted < 1:
            raise AssertionError(f"serve7: store {store_stats}, tier {census}, "
                                 f"checkpoint posted {posted}")
        page_bytes = int(sum(v.nbytes for v in kvtier.quantize_payload(
            next(iter(demoted.values()))).values()))

        # -- 4 requests replayed one at a time: streamed == collected ------
        r = np.random.default_rng(seed + 300)
        replay = [
            ("v1/chat/completions", {"messages": [
                {"role": "system", "content": system},
                {"role": "user", "content": text(r, 60)}]}),
            ("v1/chat/completions", {"messages": [{"role": "user", "content": text(r, 40)}]}),
            ("v1/completions", {"prompt": text(r, 30)}),     # no prefix group
            ("v1/completions", {"prompt": text(r, 300)}),
        ]
        def ask(path, body):
            """(collected text and finish, streamed text and finish)."""
            chat = "chat" in path
            ch = c._remote_json("post", path, json=body)["choices"][0]
            collected = (ch["message"]["content"] if chat else ch["text"], ch["finish_reason"])
            resp = c.do_request("post", path, json={**body, "stream": True}, stream=True)
            resp.raise_for_status()
            parts, finish = [], None
            for raw_line in resp.iter_lines():
                line = raw_line.decode()
                if not line.startswith("data:") or line[5:].strip() == "[DONE]":
                    continue
                ch = json.loads(line[5:])["choices"][0]
                parts.append(ch["delta"].get("content", "") if chat else ch.get("text", ""))
                finish = ch["finish_reason"] or finish
            return collected, ("".join(parts), finish)

        replayed = []
        for path, body in replay:
            body = {"model": catalog, "max_tokens": n_new // 4, "temperature": 0.0, **body}
            collected, streamed = ask(path, body)
            if streamed != collected:
                raise AssertionError(f"serve7: replay of {path}: streamed and collected "
                                     f"replies differ: {streamed} {collected}")
            text_c, finish = collected
            rec = {"path": path, "finish": finish, "chars": len(text_c)}
            # the first of each route's requests again, stopped by a stop
            # string: a printable ASCII character (one byte token) new at
            # its place in the reply, the second such if there is one.
            # EOS never wins under these random weights: this is the path
            # by which a reply ends "stop"
            new = [i for i, x in enumerate(text_c) if " " <= x <= "~" and x not in text_c[:i]]
            at = new[1] if len(new) > 1 else new[0] if new else None
            if at is not None and not any("stopped_at" in r for r in replayed
                                          if r["path"] == path):
                got = ask(path, {**body, "stop": [text_c[at]]})
                if got != ((text_c[:at], "stop"),) * 2:
                    raise AssertionError(f"serve7: replay of {path} with stop "
                                         f"{text_c[at]!r}: {got}, not {text_c[:at]!r}")
                rec["stopped_at"] = at
            replayed.append(rec)
        if head is not None and (not ttft or not all(
                r["chars"] or r["finish"] == "stop" for r in replayed)):
            raise AssertionError(f"serve7: replies without text: {len(ttft)} timed, {replayed}")
        if sum("stopped_at" in r for r in replayed) != 2:
            raise AssertionError(f"serve7: a route's replays did not end 'stop': {replayed}")

        # -- graceful shutdown with two streams in flight ------------------
        started, ends = threading.Barrier(3, timeout=600), []

        def long_stream(i):
            try:
                # long enough to be in flight when the late request lands
                it = c.chat(f"tell me more {i}", model=catalog, stream=True,
                            max_tokens=2 * n_new, temperature=0.0)
                first = next(it)
                started.wait()
                rest = list(it)
                ends.append((rest[-1] if rest else first)["choices"][0]["finish_reason"])
            except Exception:  # noqa: BLE001
                errors.append(traceback.format_exc())
                started.abort()

        streams = [threading.Thread(target=long_stream, args=(i,), daemon=True) for i in range(2)]
        for t in streams:
            t.start()
        started.wait()
        shut = threading.Thread(target=_graceful_shutdown, args=(engine, srv, 120), daemon=True)
        shut.start()
        while not getattr(srv, "draining", False):
            time.sleep(0.001)
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/v1/chat/completions", method="POST",
                data=json.dumps({"model": catalog, "messages": [
                    {"role": "user", "content": "late"}]}).encode()), timeout=60)
            late = 200
        except urllib.error.HTTPError as e:
            late = e.code
        for t in (*streams, shut):
            t.join(timeout=300)
        srv_thread.join(timeout=60)
        if late != 503 or errors or srv_thread.is_alive() or shut.is_alive() or (
                sorted(ends) != sorted(e for e in ends if e in ("stop", "length"))) or len(
                ends) != 2:
            raise AssertionError(f"serve7: graceful shutdown: late request {late}, streams "
                                 f"{ends}, server alive {srv_thread.is_alive()}: {errors}")
        wall = time.monotonic() - t_start
        launches = {k.name: k.launches for k in (*kernels, *absent)}

        # -- the logits checks, on the idle engine's runner, whole head ----
        if head is not None:
            with torch.no_grad():
                head.copy_(whole)
            del whole
        # a warm request's first step against its cold prefill
        prompt = np.asarray(encode_chat_batch(
            tok, [replay[0][1]["messages"][1]["content"]], system, mcfg.chat_template)[0],
            np.int32)
        h = store.lookup_pin(prompt[: ((len(prompt) - 1) // PSz) * PSz])
        try:
            if not h.tokens:
                raise AssertionError("serve7: the replayed request is not warm in the store")
            owned = set(store.owned_pages())
            free = [p for p in range(1, runner.alloc_pages) if p not in owned]
            need = pages_needed(len(prompt), PSz)
            table = np.zeros((ecfg.max_pages_per_seq,), np.int32)
            table[: need] = h.pages + free[: need - len(h.pages)]
            warm = runner.prefill(prompt[h.tokens:], table, start=h.tokens)
            table[: need] = free[need : 2 * need]
            cold = runner.prefill(prompt, table, 0)
        finally:
            store.release(h)
        rel = float(np.linalg.norm(warm - cold) / np.linalg.norm(cold))
        if not (np.isfinite(warm).all() and rel < REL_L2):
            raise AssertionError(f"serve7: warm logits vs cold prefill: rel_l2={rel}")
        # both carry kernels and the decode at this serve's shape: a
        # decode step of two sets of 8 of B's rows with and without S's
        # shared pages as prefix groups, one group, then two live in one
        # step (pages 1.. of the pool: the store's pages are not read
        # again)
        prompts = [np.asarray(x, np.int32) for x in encode_chat_batch(
            tok, rows_b, system, mcfg.chat_template)]
        template = shared_head(prompts, PSz)
        n_pfx = online_prefix_pages(seed, system_chars, model, PSz)
        if not n_pfx or len(template) != n_pfx * PSz:
            raise AssertionError(f"serve7: B's rows share {len(template)} tokens, not the "
                                 f"{n_pfx} pages of the kernel phase's shape")
        split_checks = [check_split_decode(torch, runner, template, prompts[i : i + 8], rng,
                                           f"serve7 rows {i}-{i + 7}", n_groups=g)
                        for i, g in ((0, 1), (8, 2))]
    finally:
        if smi is not None:
            smi.terminate()
            smi.wait(timeout=30)
        ContinuousBatcher.tier_observer = None
        srv.shutdown()
        engine.close(timeout=30)
        engine._runner_cache.clear()

    def rate(t0, t1):
        pts = [(t, n) for t, n in tokens_seen if t0 <= t <= t1]
        if len(pts) < 2:
            return None
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])

    def busy(t0, t1):
        xs = [u for t, u in util if t0 <= t <= t1]
        return float(np.mean(xs)) / 100 if xs else None

    hist = {n: metrics_histogram(metrics_burst, f"sutro_interactive_{n}_seconds")
            for n in ("ttft", "itl")}
    # the tier's host time in every session up to B's end (kv_promote
    # holds the prefix promotions and the suspended rows' resumes)
    stages = {}
    for st in ("kv_demote", "kv_promote"):
        (s1, n1), (s0, n0) = stage_seconds(metrics_b, st), stage_seconds(metrics_start, st)
        stages[st] = {"total_s": s1 - s0, "count": n1 - n0}
    out = {
        "card": card, "wall_s": wall, "rows": n_rows, "sessions": n_sessions,
        "streamed": n_stream, "oneshot": n_oneshot,
        "b_wall_s": t_b_end - t_start, "burst_s": t_burst_end - t_burst, "b_perf": b_perf,
        "b_decode_tok_s_before_burst": rate(t_start, t_burst),
        "b_decode_tok_s_during_burst": rate(t_burst, min(t_burst_end, t_b_end)),
        "card_busy_share": {"before_burst": busy(t_start, t_burst),
                            "during_burst": busy(t_burst, t_burst_end),
                            "whole_serve": busy(t_start, t_start + wall)},
        "client_ttft": quantiles(ttft), "client_itl": quantiles(itl),
        "server_ttft": hist["ttft"], "server_itl": hist["itl"],
        "rows_suspended_for_interactive": metric_total(
            metrics_burst, "sutro_interactive_preemptions_total"),
        "checkpoint_posted": posted,
        "store": store_stats,
        "chat_warm_tokens": {"system_prompt_pages_tokens": s_head, "min": min(chat_warm),
                             "mean": float(np.mean(chat_warm)),
                             "turns_warm_at_submit": int(sum(w >= s_head for w in chat_warm)),
                             "min_skipped": int(min(chat_saved))},
        "tier": {**census, "int8_page_bytes": page_bytes,
                 "prefix_pages_demoted": moved["demote"],
                 "prefix_pages_promoted": moved["promote"],
                 "int8_bytes_demoted": page_bytes * moved["demote"],
                 "int8_bytes_promoted": page_bytes * moved["promote"], **stages,
                 "promoted_pages_checked": checked, "worst_err_of_bound": worst},
        "finishes_streamed_collected": finishes,
        "replayed": replayed, "warm_vs_cold_rel_l2": rel, "monitor": monitor,
        "warm_tokens": int(h.tokens), "shared_prefix_tokens": len(template),
        "split_vs_full_rel_l2": [x[0] for x in split_checks],
        "split_vs_full_layer0_attn_max_abs": [x[1] for x in split_checks],
        "launches": launches,
    }
    for k in kernels:
        if launches[k.name] <= 0:
            raise AssertionError(f"serve7: kernel {k.name} was not launched by the serve")
    for k in absent:
        if launches[k.name]:
            raise AssertionError(f"serve7: kernel {k.name} launched {launches[k.name]} times")
    print("serve7: " + json.dumps(out), flush=True)
    print(f"serve7: card={card} wall_s={wall:.2f} B rows={n_rows} b_wall_s={out['b_wall_s']:.2f} "
          f"b_decode_tok_s before={out['b_decode_tok_s_before_burst']} during="
          f"{out['b_decode_tok_s_during_burst']} card_busy_share="
          f"{json.dumps(out['card_busy_share'])} client_ttft={json.dumps(out['client_ttft'])} "
          f"client_itl={json.dumps(out['client_itl'])} server_ttft={json.dumps(hist['ttft'])} "
          f"server_itl={json.dumps(hist['itl'])} chat_warm_tokens="
          f"{json.dumps(out['chat_warm_tokens'])} suspended="
          f"{out['rows_suspended_for_interactive']} store={json.dumps(store_stats)} "
          f"tier={json.dumps(out['tier'])} finishes={json.dumps(finishes)} "
          f"warm_vs_cold_rel_l2={rel:.3e} launches={json.dumps(launches)}", flush=True)
    return out


# ---------------------------------------------------------------------
# serve 8: stage graphs, the control plane and the monitor on gpt-oss-20b
# ---------------------------------------------------------------------

# the judge stage's schema: two of two labels, mostly forced by the
# constraint's fast-forward (a random-weight model commits ~1 token a
# row a window)
RANKING_SCHEMA = {
    "type": "object",
    "properties": {"ranking": {"type": "array", "items": {"enum": ["A", "B"]},
                               "minItems": 2, "maxItems": 2}},
    "required": ["ranking"],
}


def ranking_errors(text: str) -> list:
    """What is wrong with ``text`` under ``RANKING_SCHEMA``; empty when
    it is valid."""
    try:
        obj = json.loads(text)
    except ValueError as e:
        return [f"not JSON: {e}"]
    if not isinstance(obj, dict) or set(obj) != {"ranking"}:
        return [f"not a ranking object: {obj!r}"]
    r = obj["ranking"]
    if not isinstance(r, list) or len(r) != 2 or not all(x in ("A", "B") for x in r):
        return [f"ranking {r!r}"]
    return []


def graph_stages(gen_system: str, crit_system: str, gen_new: int, crit_new: int,
                 judge_new: int, max_pairs: int, min_length: int = 8) -> list:
    """Serve 8's stage graph: gen -> critique -> keep -> pairs -> judge -> elo."""
    return [
        {"name": "gen", "kind": "map", "system_prompt": gen_system,
         "sampling_params": {"max_new_tokens": gen_new}},
        {"name": "critique", "kind": "map", "after": ["gen"], "system_prompt": crit_system,
         "prompt_template": "critique: {input}", "sampling_params": {"max_new_tokens": crit_new}},
        {"name": "keep", "kind": "filter", "after": ["critique"],
         "predicate": {"type": "min_length", "value": min_length}},
        {"name": "pairs", "kind": "pair", "after": ["keep"], "max_pairs": max_pairs},
        {"name": "judge", "kind": "map", "after": ["pairs"],
         "prompt_template": "Which reply is better, a or b? {input}",
         "output_schema": RANKING_SCHEMA, "sampling_params": {"max_new_tokens": judge_new}},
        {"name": "elo", "kind": "elo", "after": ["judge"]},
    ]


def serve_graphs(torch, kernels, absent, card: str, *, model="gpt-oss-20b", device="cuda",
                 geometry=None, n_gen=96, gen_chars=(16, 257), gen_system_chars=500,
                 crit_system_chars=1000, gen_new=48, crit_new=32, max_pairs=48, p1_rows=128,
                 p1_new=96, p0_rows=16, p0_new=16, monitor_interval=0.5, seed=0) -> dict:
    """Serve 8: stage graphs (``so.run_graph``), the control plane and the
    live monitor, through ``import sutro_tpu_torch as so`` on a new
    ``LocalEngine`` for ``model`` (``stepprofile.ENGINES``' geometry:
    64-token pages, 32 a row, B=64, windows of 8, ``prefix_split``),
    random weights from the seed and the byte tokenizer, telemetry and
    the monitor on (as by default; a tick every ``monitor_interval`` s
    over a 10 s window), and the control plane on, its row buckets
    (``n_gen + p1_rows + 16`` rows a minute) small enough to refuse one
    submit, ``wait=1``. The head's columns but for the printable ASCII
    bytes' and the stop ids' are zeroed, as in serve 7, so that replies
    are text.

    A. A dry run, then one stage graph through ``so.run_graph`` (tenant
    ``acme``, priority 1): ``gen`` (``n_gen`` rows under a ~500-token
    system prompt, ``gen_new`` tokens, greedy) -> ``critique`` ("critique:
    {input}" under a ~1,000-token system prompt that starts with gen's,
    a prefix group, ``crit_new`` tokens, fed as gen's rows land) -> ``keep`` (min_length)
    -> ``pairs`` (``max_pairs``) -> ``judge`` (``RANKING_SCHEMA``) ->
    ``elo``, the sink. Held: the dry run's price is the whole DAG's as
    ``graph_cost_bounds`` gives it; the job and every stage succeed with
    their row counts; each downstream stage's inputs are its template
    over its upstream stage's outputs (the host stages' rows recomputed
    here); critique's first result lands before gen is done; the prefix
    store saved tokens; every judge row is valid under its schema; the
    sink is the ELO (``templates.evals.elo_fit``) of the parsed
    rankings; the progress stream carries ``stages`` updates.

    B. The ladder and the buckets: job P1 (``acme``, priority 1,
    ``p1_rows`` rows, ``p1_new`` tokens) fills the batch; once it
    decodes, P0 (``beta``, priority 0, ``p0_rows`` rows, ``p0_new``
    tokens) attaches, and one more ``beta`` submit of the bucket's whole
    capacity must be refused ``QUOTA_EXCEEDED``. P1 rows must be
    suspended (``preempt_suspend``), P0 must end first, P1 with all its
    rows, and the plane's preemption count must be P1's.

    C. The monitor: mid-run (P1 running, P0 done) ``so.get_monitor()``
    must show 2 ticks or more, batch rows/s above 0, an in-flight
    doctor verdict for P1 and the ``enforcement`` section with the
    preemptions and the rejection; a rule set through
    ``monitor.set_rules`` (``jobs_running > 0.5``) must go pending ->
    firing -> resolved, its firing dumping the flight recorder next to
    P1. Neither the monitor nor the plane may degrade.

    ``kernels`` must launch in A and B, ``absent`` must not. Then, on the
    runner with its whole head: prefill logits of 4 gen prompts against
    a cache-free plain forward, and ``check_split_decode`` over two sets
    of 8 critique prompts (layers 0, windowed, and 1)."""
    import os
    import threading

    import sutro_tpu_torch as so
    from sutro_tpu_torch.engine import api, stagegraph
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.constrain import schema_constraint_factory
    from sutro_tpu_torch.engine.constrain.fsm import constraint_room
    from sutro_tpu_torch.engine.jobstore import estimate_cost
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    from sutro_tpu_torch.telemetry.monitor import DEFAULT_RULES, SLORule
    from sutro_tpu_torch.templates.evals import elo_fit

    t_serve = time.monotonic()
    mcfg = MODEL_CONFIGS[model]
    geometry = dict(geometry or ENGINES[model][0])
    rows_cap = n_gen + p1_rows + 16
    ecfg = EngineConfig(**geometry, seed=seed,
                        control=f"rows={rows_cap},tokens=1e12,wait=1,window=60,aging=3600")
    saved_env = {k: os.environ.get(k) for k in ("SUTRO_MONITOR_INTERVAL", "SUTRO_MONITOR_WINDOW")}
    os.environ["SUTRO_MONITOR_INTERVAL"] = str(monitor_interval)
    os.environ["SUTRO_MONITOR_WINDOW"] = "10"
    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 8)
    text = lambda n: "".join(rng.choice(ALPHABET, int(n)))  # noqa: E731
    # the critique prompt extends gen's (one policy preamble, then the
    # critic's instructions): its head is warm in the store once gen's
    # is prefilled
    gen_system = online_system_prompt(rng, gen_system_chars)
    crit_system = gen_system + online_system_prompt(rng, crit_system_chars - gen_system_chars)
    rows = [text(n) for n in rng.integers(*gen_chars, n_gen)]
    judge_new = constraint_room(schema_constraint_factory(RANKING_SCHEMA, tok)()) + 4
    stages = graph_stages(gen_system, crit_system, gen_new, crit_new, judge_new, max_pairs)
    catalog = {"gpt-oss-20b": "gpt-oss-20b"}.get(model, model)
    sampling = {"temperature": 0.0}

    engine = api.get_engine(ecfg, device=device)
    so._instance._engine = None
    if engine.monitor is None or engine.control is None:
        raise AssertionError(f"serve8: monitor {engine.monitor}, control {engine.control}")
    submitted = []   # every job id the engine gave a submit, in order
    real_submit = engine.submit_batch_inference

    def submit(payload):
        jid = real_submit(payload)
        submitted.append(jid)
        return jid

    engine.submit_batch_inference = submit
    # what each fed stage was given: stage -> row id -> rendered prompt
    fed = {}
    real_feed = stagegraph.StageGraphRunner._feed_rows

    def feed(self, st, rows_in):
        for rid, txt in rows_in:
            fed.setdefault(st.name, {})[int(rid)] = st.render(txt)
        return real_feed(self, st, rows_in)

    stagegraph.StageGraphRunner._feed_rows = feed
    dumps = []   # (job id, rule, telemetry.json written) per alert dump
    real_dump = engine.monitor._alert_dump

    def dump(job_id, alert):
        real_dump(job_id, alert)
        dumps.append((job_id, alert["rule"],
                      (engine.jobs._dir(job_id) / "telemetry.json").exists()))

    engine.monitor._alert_dump = dump
    t_build = time.monotonic()
    runner = engine._get_runner(mcfg.name, mcfg)[0]
    build_s = time.monotonic() - t_build
    info = runner.device_info()
    pool_gb = 2 * runner.cache.k_pages.numel() * runner.cache.k_pages.element_size() / 1e9
    # the estimate: ~20.9 B bf16 parameters, and a pool of 64 rows x 32
    # pages x 64 tokens x (24 layers x 2 x 8 x 64 x 2 B = 49,152 B a token)
    print(f"serve8: {model} built in {build_s:.1f}s: {json.dumps(info)}; weights "
          f"{info['param_bytes'] / 1e9:.2f} GB (estimate 41.8), pool {pool_gb:.2f} GB "
          f"(estimate 6.4); {torch.cuda.memory_allocated() / 1e9 if device != 'cpu' else 0:.2f} "
          "GB allocated", flush=True)
    head = runner.params.get("lm_head")
    if head is not None:
        keep_cols = torch.as_tensor([*range(32, 127), *tok.stop_ids()], device=head.device)
        with torch.no_grad():
            whole = head.clone()
            head.zero_()
            head[:, keep_cols] = whole[:, keep_cols]
    calls = {}
    count_decode_calls(runner, calls)
    watch = {"states": [], "stop": False}   # the smoke rule's states as polled

    def watcher():
        last = None
        while not watch["stop"]:
            for r in engine.monitor.snapshot_doc()["rules"]:
                if r["name"] == "smoke_jobs_running" and r["state"] != last:
                    last = r["state"]
                    watch["states"].append(last)
            time.sleep(0.02)

    for k in (*kernels, *absent):
        k.launches = 0
    t_start = time.monotonic()
    try:
        # -- A: a dry run, then the graph ----------------------------------
        est = so.run_graph(rows, stages=stages, model=catalog, job_priority=1, dry_run=True,
                           tenant="acme", sampling_params=sampling)
        dry = engine.get_job(submitted[-1])
        graph = stagegraph.parse_graph(stages, default_model=catalog)
        extra_in, _ = stagegraph.graph_cost_bounds(graph, n_gen, ecfg.max_new_tokens)
        root_in = sum(len(x) for x in encode_chat_batch(tok, rows, gen_system, mcfg.chat_template))
        n_rows_est = stagegraph.estimate_stage_rows(graph, n_gen)
        est_out = sum(n_rows_est[s.name] * int(s.sampling_params["max_new_tokens"])
                      for s in graph.stages if s.kind == "map")
        want_cost = estimate_cost(mcfg.name, root_in + extra_in, est_out)
        if (dry["status"] != "SUCCEEDED" or dry["input_tokens"] != root_in + extra_in
                or est != want_cost or dry["cost_estimate"] != want_cost):
            raise AssertionError(f"serve8: dry run priced {est} for {dry['input_tokens']} input "
                                 f"tokens, not {want_cost} for {root_in} + {extra_in}")
        progress = []

        t_graph = time.monotonic()
        jid = so.run_graph(rows, stages=stages, model=catalog, job_priority=1, tenant="acme",
                           stay_attached=False, sampling_params=sampling)
        if jid is None:
            raise AssertionError(f"serve8: the graph was refused: {engine.get_job(submitted[-1])}")
        follower = threading.Thread(
            target=lambda: progress.extend(engine.stream_job_progress(jid)), daemon=True)
        follower.start()
        status = so.await_job_completion(jid, obtain_results=False, timeout=1800)
        graph_wall = time.monotonic() - t_graph
        follower.join(timeout=60)
        rec = engine.get_job(jid)
        if rec["status"] != "SUCCEEDED" or status != jid:
            raise AssertionError(f"serve8: the graph ended {rec['status']}: "
                                 f"{rec.get('failure_reason')} {rec.get('failure_log')}")
        res = {s["name"]: engine.job_results(f"{jid}/stages/{s['name']}",
                                             include_inputs=s["name"] == "gen")
               for s in stages}
        for name, r in res.items():
            if "errors" in r:
                raise AssertionError(f"serve8: stage {name} quarantined rows: {r['errors']}")
        gen_out = res["gen"]["outputs"]
        if res["gen"]["inputs"] != rows or len(gen_out) != n_gen:
            raise AssertionError("serve8: gen's rows are not the graph's inputs 1:1")
        # each downstream stage's inputs: its template over its upstream
        # stage's outputs, the host stages recomputed here
        want_crit = {i: "critique: " + o for i, o in enumerate(gen_out)}
        crit_out = res["critique"]["outputs"]
        keep = [o for o in crit_out if len(o) >= 8]
        pairs = []
        for i in range(len(keep)):
            for j in range(i + 1, len(keep)):
                if len(pairs) < max_pairs:
                    pairs.append(json.dumps({"a": keep[i], "b": keep[j], "a_row": i,
                                             "b_row": j}, sort_keys=True))
        want_judge = {i: "Which reply is better, a or b? " + p for i, p in enumerate(pairs)}
        judge_out = res["judge"]["outputs"]
        bad = {i: ranking_errors(o) for i, o in enumerate(judge_out) if ranking_errors(o)}
        players, elo, _ = elo_fit([json.loads(o)["ranking"] for o in judge_out
                                   if not ranking_errors(o)])
        want_elo = [json.dumps({"player": p, "elo": round(float(e), 6)}, sort_keys=True)
                    for p, e in zip(players, elo)]
        sink = engine.job_results(jid)["outputs"]
        checks = {
            "critique fed": fed.get("critique") == want_crit and len(crit_out) == n_gen,
            "keep": res["keep"]["outputs"] == keep,
            "pairs": res["pairs"]["outputs"] == pairs,
            "judge fed": bool(pairs) and fed.get("judge") == want_judge
            and len(judge_out) == len(pairs),
            "judge schema": not bad,
            "elo": res["elo"]["outputs"] == want_elo == sink,
        }
        if not all(checks.values()):
            raise AssertionError(f"serve8: stage checks {checks}; bad judge rows {bad}")
        want_rows = {"gen": n_gen, "critique": n_gen, "keep": len(keep), "pairs": len(pairs),
                     "judge": len(pairs), "elo": len(players)}
        roll = rec["stages_state"]
        for name, n in want_rows.items():
            s = roll[name]
            if (s["status"], s["rows_done"], s["rows_total"], s["quarantined"]) != (
                    "succeeded", n, n, 0):
                raise AssertionError(f"serve8: stage {name} rolled up {s}, not {n} rows")
        tel = so.get_job_telemetry(jid)["attrs"]
        st_t = tel["stages"]
        if not st_t["critique"]["first_result_s"] < st_t["gen"]["done_s"]:
            raise AssertionError(f"serve8: critique's first result {st_t['critique']} after gen "
                                 f"was done {st_t['gen']}")
        saved = tel.get("prefix", {}).get("saved_tokens", 0)
        if saved <= 0:
            raise AssertionError(f"serve8: the prefix store saved no tokens: {tel.get('prefix')}")
        stage_updates = [u for u in progress if u.get("update_type") == "stages"]
        if not stage_updates or any(v["status"] != "succeeded"
                                    for v in stage_updates[-1]["result"].values()):
            raise AssertionError(f"serve8: the progress stream's stage updates: "
                                 f"{stage_updates[-1:]}")
        graph_perf = {k: v for k, v in (rec.get("perf") or {}).items()
                      if isinstance(v, dict) and "total_s" in v}

        # -- B: the ladder and the buckets; C: the monitor ------------------
        engine.monitor.set_rules([*DEFAULT_RULES, SLORule(
            "smoke_jobs_running", metric="jobs_running", op=">", threshold=0.5, clear=0.5,
            for_ticks=3, clear_ticks=2, workload="batch")])
        watch_t = threading.Thread(target=watcher, daemon=True)
        watch_t.start()
        rows_p1 = [text(n) for n in rng.integers(16, 257, p1_rows)]
        rows_p0 = [text(n) for n in rng.integers(16, 257, p0_rows)]
        t_b = time.monotonic()
        p1 = so.infer(rows_p1, model=catalog, job_priority=1, tenant="acme", stay_attached=False,
                      sampling_params={"temperature": 0.0, "max_new_tokens": p1_new})
        n_calls = sum(calls[k] for k in DECODE_ENTRIES)
        while sum(calls[k] for k in DECODE_ENTRIES) < n_calls + 2:
            if engine.job_status(p1) not in ("QUEUED", "STARTING", "RUNNING") or (
                    time.monotonic() - t_b > 600):
                raise AssertionError(f"serve8: P1 did not decode: {engine.get_job(p1)}")
            time.sleep(0.01)
        p0 = so.infer(rows_p0, model=catalog, job_priority=0, tenant="beta", stay_attached=False,
                      sampling_params={"temperature": 0.0, "max_new_tokens": p0_new})
        t_refused = time.monotonic()
        so.infer(["x"] * rows_cap, model=catalog, job_priority=0, tenant="beta",
                 stay_attached=False, sampling_params={"temperature": 0.0, "max_new_tokens": 4})
        refused_s = time.monotonic() - t_refused
        refused = engine.get_job(submitted[-1])
        if refused["status"] != "FAILED" or (refused.get("failure_reason") or {}).get(
                "code") != "QUOTA_EXCEEDED":
            raise AssertionError(f"serve8: the over-bucket submit ended {refused['status']}: "
                                 f"{refused.get('failure_reason')}")
        if so.await_job_completion(p0, obtain_results=False, timeout=1800) != p0:
            raise AssertionError(f"serve8: P0 ended {engine.get_job(p0)}")
        t_p0 = time.monotonic()
        # C: the monitor mid-run, P1 still running
        mon, deadline = None, time.monotonic() + 120
        while True:
            doc = so.get_monitor()
            enf = doc.get("enforcement") or {}
            ok = (doc["ticks"] >= 2 and doc["stats"].get("rates", {}).get("rows_per_s", 0) > 0
                  and doc["verdicts"].get(p1, {}).get("in_flight")
                  and enf.get("preemptions", 0) >= 1 and enf.get("rejections", 0) >= 1)
            if ok:
                mon = doc
                break
            if engine.job_status(p1) != "RUNNING" or time.monotonic() > deadline:
                raise AssertionError(f"serve8: the monitor mid-run: ticks {doc['ticks']}, rates "
                                     f"{doc['stats'].get('rates')}, verdicts "
                                     f"{doc['verdicts']}, enforcement {enf}")
            time.sleep(monitor_interval / 2)
        if so.await_job_completion(p1, obtain_results=False, timeout=1800) != p1:
            raise AssertionError(f"serve8: P1 ended {engine.get_job(p1)}")
        t_p1 = time.monotonic()
        r1 = engine.job_results(p1, include_inputs=True, include_cumulative_logprobs=True)
        r0 = engine.job_results(p0, include_inputs=True)
        if r1["inputs"] != rows_p1 or "errors" in r1 or not all(
                0 <= g <= p1_new for g in r1["gen_tokens"]) or r0["inputs"] != rows_p0:
            raise AssertionError(f"serve8: P1's or P0's results are not 1:1 with their rows: "
                                 f"P1 errors {r1.get('errors')}, gen_tokens {r1['gen_tokens']}")
        rec1, rec0 = engine.get_job(p1), engine.get_job(p0)
        from datetime import datetime

        if not (datetime.fromisoformat(rec0["datetime_completed"])
                < datetime.fromisoformat(rec1["datetime_completed"])):
            raise AssertionError(f"serve8: P0 ended {rec0['datetime_completed']}, after P1 "
                                 f"{rec1['datetime_completed']}")
        preempted = (so.get_job_telemetry(p1)["attrs"].get("interactive") or {}).get(
            "preempted_rows", 0)
        snap = engine.control.snapshot()
        if not preempted or snap["preemptions"] != preempted or snap["rejections"] != 1:
            raise AssertionError(f"serve8: P1 preempted {preempted}, the plane counted "
                                 f"{snap['preemptions']} preemptions, {snap['rejections']} "
                                 "rejections")
        # the rule resolves a few ticks after P1 leaves the engine
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                "firing" in watch["states"] and watch["states"][-1] == "ok"):
            time.sleep(0.05)
        watch["stop"] = True
        watch_t.join(timeout=10)
        final = engine.monitor_doc()
        events = [e for e in final["alerts"]["events"] if e["rule"] == "smoke_jobs_running"]
        seq = watch["states"]
        fired = [d for d in dumps if d[1] == "smoke_jobs_running"]
        if (seq[:1] != ["ok"] or "pending" not in seq or "firing" not in seq
                or seq.index("pending") > seq.index("firing") or seq[-1] != "ok"
                or [e["state"] for e in events] != ["firing", "resolved"]
                or not any(j == p1 and ok for j, _, ok in fired)):
            raise AssertionError(f"serve8: the smoke rule went {seq}, events {events}, "
                                 f"dumps {fired}")
        if engine.monitor.failed is not None or snap["degraded_reason"] is not None or not (
                snap["enabled"]):
            raise AssertionError(f"serve8: degraded: monitor {engine.monitor.failed}, control "
                                 f"{snap['degraded_reason']}")
        wall = time.monotonic() - t_start
        launches = {k.name: k.launches for k in (*kernels, *absent)}

        # -- the logits checks, on the runner with its whole head -----------
        if head is not None:
            with torch.no_grad():
                head.copy_(whole)
            del whole
        gen_prompts = [np.asarray(x, np.int32) for x in encode_chat_batch(
            tok, rows[:4], gen_system, mcfg.chat_template)]
        rel = check_prefill_logits(torch, runner, gen_prompts, "serve8")
        crit_prompts = [np.asarray(x, np.int32) for x in encode_chat_batch(
            tok, ["critique: " + o for o in gen_out[:16]], crit_system, mcfg.chat_template)]
        template = shared_head(crit_prompts, ecfg.kv_page_size)
        split_checks = [check_split_decode(torch, runner, template, crit_prompts[i : i + 8], rng,
                                           f"serve8 critique rows {i}-{i + 7}", layers=(0, 1))
                        for i in (0, 8)]
    finally:
        watch["stop"] = True
        stagegraph.StageGraphRunner._feed_rows = real_feed
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        engine.close(timeout=30)
        engine._runner_cache.clear()
        so._instance._engine = None
        api.reset_engine()

    def stage_rate(name):
        s = st_t[name]
        first = s["starved_s"] if name != "gen" else 0.0
        return s["rows"] / max(s["done_s"] - first, 1e-9) if s["done_s"] else None

    out = {
        "card": card, "model": model, "serve_s": time.monotonic() - t_serve, "wall_s": wall,
        "build_s": build_s, "device_info": info,
        "graph_wall_s": graph_wall, "dry_run_cost": est, "dry_run_input_tokens": root_in + extra_in,
        "stage_rows": want_rows,
        "stage_times": {n: {"first_result_s": s["first_result_s"], "done_s": s["done_s"],
                            "rows": s["rows"], "rows_per_s": stage_rate(n)}
                        for n, s in st_t.items() if n in ("gen", "critique", "judge")},
        "graph_tokens": {"input": rec["input_tokens"], "output": rec["output_tokens"]},
        "graph_perf": graph_perf, "prefix_saved_tokens": saved,
        # over the session's device calls; prompt tokens as billed (each
        # row's shared system prompt counted)
        "decode_tok_s": rec["output_tokens"] / decode_seconds(graph_perf),
        "prefill_tok_s": rec["input_tokens"] / graph_perf["prefill"]["total_s"],
        "stage_updates": len(stage_updates),
        "judge_rows_valid": len(judge_out), "elo": [json.loads(x) for x in sink],
        "ladder": {"p1_rows": p1_rows, "p0_rows": p0_rows, "rows_suspended": preempted,
                   "p0_wall_s": t_p0 - t_b, "p1_wall_s": t_p1 - t_b,
                   "refused_submit_s": refused_s,
                   "refusal": refused["failure_reason"]["message"]},
        "monitor": {"ticks": mon["ticks"], "rates": mon["stats"].get("rates"),
                    "verdict_p1": mon["verdicts"][p1]["verdict"],
                    "enforcement": {k: mon["enforcement"][k]
                                    for k in ("preemptions", "rejections", "buckets")},
                    "smoke_rule_states": seq, "alert_events": events,
                    "alert_dumps": [list(d) for d in fired]},
        "prefill_rel_l2": rel,
        "split_vs_full_rel_l2": [x[0] for x in split_checks],
        "split_vs_full_attn_max_abs": [x[1] for x in split_checks],
        "shared_prefix_tokens": len(template),
        "launches": launches,
    }
    for k in kernels:
        if launches[k.name] <= 0:
            raise AssertionError(f"serve8: kernel {k.name} was not launched by the serve")
    for k in absent:
        if launches[k.name]:
            raise AssertionError(f"serve8: kernel {k.name} launched {launches[k.name]} times")
    print("serve8: " + json.dumps(out), flush=True)
    return out


def graphs_summary(out: dict) -> dict:
    """Serve 8's headline figures, for a line near the end of the output."""
    return {k: out[k] for k in ("card", "serve_s", "wall_s", "graph_wall_s", "stage_rows",
                                "stage_times",
                                "decode_tok_s", "prefill_tok_s", "prefix_saved_tokens",
                                "ladder", "prefill_rel_l2", "split_vs_full_rel_l2",
                                "launches")} | {
        "monitor": {k: out["monitor"][k] for k in ("ticks", "rates", "verdict_p1",
                                                   "smoke_rule_states", "alert_events")}}


def online_summary(out: dict) -> dict:
    """Serve 7's headline figures, for a line near the end of the output."""
    pick = lambda d: {k: d.get(k) for k in ("n", "p50_s", "p99_s")}  # noqa: E731
    return {
        "card": out["card"], "wall_s": out["wall_s"], "b_wall_s": out["b_wall_s"],
        "burst_s": out["burst_s"],
        "b_decode_tok_s": [out["b_decode_tok_s_before_burst"],
                           out["b_decode_tok_s_during_burst"]],
        "client_ttft": pick(out["client_ttft"]), "client_itl": pick(out["client_itl"]),
        "card_busy_share": out["card_busy_share"],
        "suspended": out["rows_suspended_for_interactive"],
        "tokens_saved": out["store"]["tokens_saved"],
        "kv_promote": out["tier"]["kv_promote"], "kv_demote": out["tier"]["kv_demote"],
        "finishes": out["finishes_streamed_collected"], "monitor": out["monitor"],
    }


# ---------------------------------------------------------------------
# serve 9: the replica fleet on two qwen3-8b replicas
# ---------------------------------------------------------------------

# each port kernel's launch counters, and what a torch.profiler trace
# calls the CUDA kernel those launches run (the paged decode's bf16
# entry serves the plain and the carry counters; its int8 entry is the
# same template over signed char pages)
TRACE_KERNELS = (
    (("paged_decode", "paged_decode_carry"),
     lambda n: "paged_decode_split_kernel" in n and "char" not in n),
    (("paged_decode_int8",), lambda n: "paged_decode_split_kernel" in n and "char" in n),
    (("kv_write",), lambda n: "kv_write_kernel" in n),
    (("flash_prefill",), lambda n: "flash_prefill_kernel" in n),
    (("prefix_carry",), lambda n: "prefix_carry_kernel" in n),
    (("grouped_matmul",), lambda n: "grouped_matmul_wgmma_kernel" in n),
)


def job_trace_figures(trace_file: str, deltas: dict, wall_s: float) -> dict:
    """A job's ``torch.profiler`` trace (Chrome JSON): the card's busy ms
    (the union of its kernel intervals, ``stepprofile._busy_us``) and
    idle share over the job's wall, the five kernels with the most
    device time, and each port kernel's events beside its launch
    counters' delta over the job."""
    from sutro_tpu_torch.engine.stepprofile import _busy_us

    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name.setdefault(e["name"], []).append(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
    port = {}
    for counters, match in TRACE_KERNELS:
        port["+".join(counters)] = {
            "trace_events": sum(len(v) for n, v in by_name.items() if match(n)),
            "launches": sum(deltas.get(c, 0) for c in counters)}
    return {
        "events": len(events), "kernel_events": len(kernels),
        "cpu_ops": sum(e.get("cat") == "cpu_op" for e in events),
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)) if wall_s else None,
        "top_kernels": [{"name": n[:90], "count": len(ds), "ms": sum(ds) / 1e3}
                        for n, ds in top],
        "port_kernels": port,
    }


def serve_fleet(torch, kernels, absent, card: str, ckpt_root: Path, *, model="qwen3-8b",
                device="cuda", geometry=None, n_rows=32, n_failover=384, n_new=32,
                n_sessions=8, chat_new=16, system_chars=1000, flush_every=None,
                seed=0) -> dict:
    """Serve 9: the replica fleet. Two ``LocalEngine`` replicas, r0 and
    r1, on the checkpoint serve 5 wrote (``ckpt_root``), each with serve
    1's geometry at half its slots (``decode_batch_size`` 32; an
    admission budget of the pool's tokens), ``prefix_split``,
    ``interactive_slots=4`` and the prefix store, sharing one
    ``SUTRO_HOME``, each behind ``start_server_thread``; r0 with a
    ``profile_dir``. The port's router over both
    (``fleet.start_fleet_thread``, probes every 0.2 s) and
    ``Sutro(backend="fleet")`` at it. Both heads keep only the printable
    ASCII bytes' and the stop ids' columns (serve 7's trick: replies
    have text), restored for the logits check.

    - Routing and traces: job A (``n_rows`` rows of 16-500 characters,
      ``n_new`` tokens, greedy) through the router lands on r0, its
      progress read through the router's NDJSON relay; A's rows run
      directly on r1 must give A's outputs (both read through the
      router's ``/job-results``). A alone is traced: its
      ``{profile_dir}/{job}/trace.json`` gives the card's busy ms and
      idle share over A's wall, the top kernels, and each port kernel's
      events, which must equal its launch counters' delta over A. Then
      r0 drains: job B through the router must go to r1, and B's rows
      run directly on r0 (rejoined) must give B's outputs.
    - Warm affinity: ``n_sessions`` chat sessions of 2 turns each
      (serve 7's system prompt S, ``chat_new`` tokens, greedy, streamed)
      through the router, each turn's sessions at once: every turn 2
      must go to its turn 1's replica (the router's trace of each
      request names it), the router must count a prefix hit for each,
      and the replicas' stores must hit. ``GET /trace/{id}`` of one chat
      must stitch the router's spans and the replica's; ``/metrics``
      must show the replicas' TTFT under the ``replica`` label.
    - A replica dying mid-stream: a server of its own on r0 behind a
      router of its own (stall timeout 10 s), a ``fleet.replica_crash``
      at the second token frame of an SSE chat: the client must get
      frames, then the structured error frame (code 502) and ``[DONE]``.
    - Failover: job F (``n_failover`` rows of 16-300 characters,
      ``n_new`` tokens, greedy) through the router; once its owner has
      flushed its first partial chunk a ``runner.decode`` fault fails it
      there, and the owner's server shuts down. The breaker must open,
      the router fail the job over, and F end SUCCEEDED on the survivor
      with every row id once and the rows stored before the kill
      byte-equal in the results; the resumed rows are compared with an
      unkilled run of them on the survivor (printed, not held: bf16 GEMMs
      at another batch shape round differently).
    - Observability: ``so.get_fleet()`` (the doctor not ``healthy``),
      ``so.get_fleet_monitor()``, ``so.get_replay_log()`` (the chats),
      whose records ``fleet.replay`` sends to the router again.
    - On the survivor's runner with its whole head, ``check_split_decode``
      behind S's pages over 8 of the chats' prompts.

    ``kernels`` must launch on the path, ``absent`` must not (both empty
    on the CPU, where the plain versions run)."""
    import os
    import threading
    import traceback
    import urllib.request

    from sutro_tpu_torch import fleet
    from sutro_tpu_torch.engine import api, faults, profiling
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.fleet import replay as replay_mod
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    from sutro_tpu_torch.sdk import Sutro
    from sutro_tpu_torch.server import start_server_thread
    from sutro_tpu_torch.telemetry import traceexport

    mcfg = MODEL_CONFIGS[model]
    if geometry is None:   # serve 1's geometry at half its slots
        geometry = dict(ENGINES[model][0])
        geometry["decode_batch_size"] //= 2
    base = dict(geometry, prefix_split=True, weights_dir=str(ckpt_root), seed=seed,
                interactive_slots=4,
                max_batch_tokens=geometry["decode_batch_size"] * geometry["max_model_len"])
    PSz = base["kv_page_size"]
    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 9)
    text = lambda r, n: "".join(r.choice(ALPHABET, int(n)))  # noqa: E731
    catalog = {"qwen3-8b": "qwen-3-8b"}.get(model, model)
    system = online_system_prompt(np.random.default_rng(seed + 7), system_chars)
    rows_a = [text(rng, n) for n in rng.integers(16, 501, n_rows)]
    rows_b = [text(rng, n) for n in rng.integers(16, 501, n_rows)]
    rows_f = [text(rng, n) for n in rng.integers(16, 301, n_failover)]
    user = [[text(rng, n) for n in rng.integers(32, 129, 2)] for _ in range(n_sessions)]
    sampling = {"temperature": 0.0, "max_new_tokens": n_new}
    profile_dir = Path(os.environ["SUTRO_HOME"]) / "profiles"

    engines, builds, servers, urls = [], [], {}, {}
    whole = None
    t_start = time.monotonic()
    for i in range(2):
        eng = api.LocalEngine(EngineConfig(
            **base, profile_dir=str(profile_dir) if i == 0 else None), device=device)
        engines.append(eng)
        t0 = time.monotonic()
        runner = eng._get_runner(mcfg.name, mcfg)[0]
        if device != "cpu":
            torch.cuda.synchronize()
        builds.append({"build_s": time.monotonic() - t0,
                       "param_bytes": runner.device_info()["param_bytes"],
                       "pool_bytes": 2 * runner.cache.k_pages.numel()
                       * runner.cache.k_pages.element_size()})
        head = runner.params.get("lm_head")
        if head is not None:
            keep = torch.as_tensor([*range(32, 127), *tok.stop_ids()], device=head.device)
            with torch.no_grad():
                if whole is None:
                    whole = head.clone()   # one checkpoint: both heads are equal
                head.zero_()
                head[:, keep] = whole[:, keep]
        srv, _, url = start_server_thread(eng)
        servers[f"r{i}"], urls[f"r{i}"] = srv, url
    allocated = torch.cuda.memory_allocated() if device != "cpu" else 0
    print(f"serve9: two {model} replicas built in "
          f"{[round(b['build_s'], 2) for b in builds]} s: {json.dumps(builds)}; "
          f"{allocated / 1e9:.2f} GB allocated on the card", flush=True)
    # both replicas share this process, and so its one interpreter lock:
    # under a decode window's host work a warm probe took over the
    # router's default second (max(0.25, probe_timeout / 2)), and a
    # timed-out probe scores the replica cold
    router, fsrv, _, furl = fleet.start_fleet_thread([urls["r0"], urls["r1"]],
                                                    probe_interval=0.2, probe_timeout=10.0)
    c = Sutro(backend="fleet", base_url=furl, api_key="smoke")
    store = engines[0].jobs   # either handle: the jobstore is shared
    by_rid = {"r0": engines[0], "r1": engines[1]}

    def wait_for(pred, what, timeout=900):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"serve9: timed out waiting for {what}")
            time.sleep(0.02)

    def counts():
        return {k.name: k.launches for k in (*kernels, *absent)}

    def results(jid):
        return c._remote_json("post", "job-results", json={"job_id": jid})["results"]

    def job_wall(eng, jid):
        rec = eng.get_job(jid)
        return _record_s(rec, "datetime_started", "datetime_completed"), rec

    def direct(eng, rows):
        jid = eng.submit_batch_inference({"model": catalog, "inputs": rows,
                                          "sampling_params": sampling})
        wait_for(lambda: eng.job_status(jid) in ("SUCCEEDED", "FAILED"), f"job {jid}")
        if eng.job_status(jid) != "SUCCEEDED":
            raise AssertionError(f"serve9: {jid} ended {eng.get_job(jid)}")
        return jid

    for k in (*kernels, *absent):
        k.launches = 0
    helpers, t_kill, marks = [], None, {}
    mark = lambda name: marks.__setitem__(name, time.monotonic() - t_start)  # noqa: E731
    try:
        wait_for(lambda: router.membership.snapshot()["n_healthy"] == 2,
                 "both replicas healthy", 60)

        # -- routing and traces --------------------------------------------
        before = counts()
        jid_a = c.infer(rows_a, model=catalog, stay_attached=False, sampling_params=sampling)
        owner_a = router.job_owner(jid_a)
        prog_a = [int(u["result"]) for u in c._iter_progress(jid_a)
                  if u.get("update_type") == "progress"]
        if owner_a != "r0" or c.get_job_status(jid_a) != "SUCCEEDED" or prog_a[-1:] != [n_rows]:
            raise AssertionError(f"serve9: job A on {owner_a}, {c.get_job_status(jid_a)}, "
                                 f"progress {prog_a[-3:]}")
        trace_file = profile_dir / jid_a / profiling.TRACE_FILE
        wait_for(trace_file.exists, "job A's trace", 300)
        deltas_a = {k: v - before[k] for k, v in counts().items()}
        wall_a, rec_a = job_wall(engines[0], jid_a)
        exported = profiling.last_trace()
        if exported["file"] != str(trace_file):
            raise AssertionError(f"serve9: the last trace is {exported}, not {trace_file}")
        tel_a = c._remote_json("get", f"job-telemetry/{jid_a}")["telemetry"]
        if tel_a["attrs"].get("profile_trace") != str(profile_dir / jid_a):
            raise AssertionError(f"serve9: job A's profile_trace attr is "
                                 f"{tel_a['attrs'].get('profile_trace')}")
        t0 = time.monotonic()
        traced = job_trace_figures(str(trace_file), deltas_a, wall_a)
        traced.update(file_bytes=exported["bytes"], export_s=exported["export_s"],
                      parse_s=time.monotonic() - t0)
        bad = {n: v for n, v in traced["port_kernels"].items()
               if v["trace_events"] != v["launches"]}
        if bad or (device != "cpu" and not (traced["port_kernels"]["flash_prefill"][
                "launches"] and traced["port_kernels"]["kv_write"]["launches"] and traced[
                "port_kernels"]["paged_decode+paged_decode_carry"]["launches"])):
            raise AssertionError(f"serve9: job A's trace against its launch counters: "
                                 f"{traced['port_kernels']}")
        engines[0].ecfg.profile_dir = None   # A alone is traced
        jid_a1 = direct(engines[1], rows_a)
        wall_a1, rec_a1 = job_wall(engines[1], jid_a1)
        out_a = results(jid_a)["outputs"]
        if out_a != results(jid_a1)["outputs"] or len(out_a) != n_rows:
            raise AssertionError("serve9: job A's outputs differ from its rows' on r1")
        # r0 drains: the router sends B to r1, then r0 rejoins and B's
        # rows run directly on it
        engines[0].gateway.begin_drain()
        try:
            wait_for(lambda: router.membership.snapshot()["n_draining"] == 1,
                     "the router to see r0 drain", 60)
            jid_b = c.infer(rows_b, model=catalog, stay_attached=False,
                            sampling_params=sampling)
            owner_b = router.job_owner(jid_b)
        finally:
            engines[0].gateway.draining = False
        prog_b = [int(u["result"]) for u in c._iter_progress(jid_b)
                  if u.get("update_type") == "progress"]
        if owner_b != "r1" or c.get_job_status(jid_b) != "SUCCEEDED" or prog_b[-1:] != [n_rows]:
            raise AssertionError(f"serve9: job B on {owner_b}, {c.get_job_status(jid_b)}, "
                                 f"progress {prog_b[-3:]}")
        b0 = direct(engines[0], rows_b)
        if results(jid_b)["outputs"] != results(b0)["outputs"]:
            raise AssertionError("serve9: job B's outputs differ from its rows' on r0")
        wait_for(lambda: router.membership.snapshot()["n_healthy"] == 2, "r0 to rejoin", 60)
        wall_b, rec_b = job_wall(engines[1], jid_b)
        mark("routing_and_trace")
        print(f"serve9: routing: A on {owner_a} {wall_a:.2f}s traced, its rows on r1 "
              f"{wall_a1:.2f}s untraced, B on {owner_b} {wall_b:.2f}s; A's trace "
              f"{json.dumps(traced)}", flush=True)

        # -- warm affinity: chat sessions of 2 turns -------------------------
        # S warm on both replicas first (a chat straight to each), so
        # that turn 1 ties on warmth and spreads by load, and only a
        # session's own pages can pull its turn 2
        for rid in ("r0", "r1"):
            with urllib.request.urlopen(urllib.request.Request(
                    urls[rid] + "/v1/chat/completions", method="POST",
                    headers={"Content-Type": "application/json"},
                    data=json.dumps({"model": catalog, "max_tokens": 2, "messages": [
                        {"role": "system", "content": system},
                        {"role": "user", "content": "warm"}]}).encode()), timeout=300) as r:
                r.read()
        hits0 = {r: e._prefix_stores[mcfg.name].hits for r, e in by_rid.items()}
        phits0 = router.counters["prefix_hits"]
        errors, replies = [], {}

        def chat(i, turn):
            try:
                msgs = [{"role": "system", "content": system},
                        {"role": "user", "content": user[i][turn]}]
                parts = []
                for chunk in c.chat(msgs, model=catalog, stream=True, max_tokens=chat_new,
                                    temperature=0.0, session_id=f"fleet-s{i}"):
                    parts.append(chunk["choices"][0]["delta"].get("content") or "")
                replies[(i, turn)] = "".join(parts)
            except Exception:  # noqa: BLE001 — reported below
                errors.append(traceback.format_exc())

        t_chat = time.monotonic()
        for turn in range(2):
            threads = [threading.Thread(target=chat, args=(i, turn), daemon=True)
                       for i in range(n_sessions)]
            for t in threads:
                t.start()
                if turn == 0:
                    # turn 1 ties on S's warmth: arrivals 0.25 s apart
                    # let each pick see the load the earlier ones put on
                    # (at once, every pick reads the same idle loads)
                    time.sleep(0.25)
            for t in threads:
                t.join(timeout=600)
            if errors or len(replies) != n_sessions * (turn + 1):
                raise AssertionError("serve9: chats failed:\n" + "\n".join(errors))
        chat_s = time.monotonic() - t_chat
        served = {}   # session -> [replica of turn 1, of turn 2]
        chat_tids, probe_s = [], []
        for tid in router.obs.traces.ids():
            tr = router.obs.traces.get(tid)
            a = tr.attrs
            if a.get("kind") == "chat" and str(a.get("session_id", "")).startswith("fleet-s"):
                served.setdefault(a["session_id"], []).append((a["arrival_unix"],
                                                               a.get("replica")))
                chat_tids.append(tid)
                probe_s += [sp["dur_s"] for sp in tr.to_doc()["spans"]
                            if sp["name"] == "affinity_probe"]
        sticky = {s: [r for _, r in sorted(v)] for s, v in served.items()}
        hits = {r: e._prefix_stores[mcfg.name].hits - hits0[r] for r, e in by_rid.items()}
        affinity = {"sessions": sticky, "router_prefix_hits": router.counters["prefix_hits"]
                    - phits0, "store_hits": hits,
                    "turn1_replicas": sorted({v[0] for v in sticky.values()}),
                    "chat_s": chat_s, "affinity_probe_s": quantiles(probe_s)}
        print(f"serve9: affinity: {json.dumps(affinity)}", flush=True)
        mark("affinity")
        if len(sticky) != n_sessions or any(len(v) != 2 or v[0] != v[1] or v[0] is None
                                            for v in sticky.values()) or affinity[
                "router_prefix_hits"] < n_sessions or sum(hits.values()) < n_sessions:
            raise AssertionError(f"serve9: warm affinity: {affinity}")
        if any(not replies[(i, 1)] for i in range(n_sessions)) and device != "cpu":
            raise AssertionError(f"serve9: replies without text: {replies}")
        # one chat's stitched trace: the router's spans and its replica's
        tid = chat_tids[-1]
        wait_for(lambda: router.obs.traces.get(tid).finished, "the chat's router trace", 30)
        doc = router.obs.stitch_trace(tid)
        spans = traceexport.stitched_spans(doc)
        names = {s["name"] for s in spans}
        with urllib.request.urlopen(f"{furl}/trace/{tid}", timeout=30) as resp:
            chrome = json.loads(resp.read())
        stitched = {"trace_id": tid, "processes": chrome["otherData"]["processes"],
                    "spans": len(spans), "names": sorted(names)}
        if (len(doc["processes"]) != 2 or not {"route_pick", "upstream_connect", "first_byte",
                                               "admit_gateway"} <= names
                or min(s["t0_s"] for s in spans) < 0):
            raise AssertionError(f"serve9: the stitched trace: {stitched}")
        time.sleep(0.5)   # past the router's scrape interval
        metrics = c.get_metrics_text()
        labelled = [ln for ln in metrics.splitlines()
                    if ln.startswith("sutro_interactive_ttft_seconds")
                    and ('replica="r0"' in ln or 'replica="r1"' in ln)]
        if not labelled or 'sutro_fleet_replicas{state="healthy"} 2' not in metrics:
            raise AssertionError("serve9: /metrics through the router has no replica series")

        # -- a replica dying mid-stream --------------------------------------
        srv_x, _, url_x = start_server_thread(engines[0])
        router_x, fsrv_x, _, furl_x = fleet.start_fleet_thread([url_x], probe_interval=0.2,
                                                              stall_timeout=10.0)
        helpers.append((router_x, fsrv_x, srv_x))
        wait_for(lambda: router_x.membership.snapshot()["n_healthy"] == 1, "r0 alone", 60)
        faults.install(faults.parse_plan(json.dumps([
            {"site": "fleet.replica_crash", "kind": "crash", "job": "stream:", "nth": 2,
             "times": 1}])))
        lines, times = [], []
        t0 = time.monotonic()
        try:
            req = urllib.request.Request(
                furl_x + "/v1/chat/completions", method="POST",
                headers={"Content-Type": "application/json"},
                data=json.dumps({"model": catalog, "stream": True, "temperature": 0.0,
                                 "max_tokens": chat_new, "messages": [
                                     {"role": "user", "content": user[0][0]}]}).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                for raw in resp:
                    if raw.strip():
                        lines.append(raw.decode().strip())
                        times.append(time.monotonic())
        finally:
            faults.clear()
        errs = [i for i, ln in enumerate(lines) if '"error"' in ln]
        stream = {"frames": len(lines), "total_s": times[-1] - t0 if times else None}
        if errs:
            err = json.loads(lines[errs[-1]][len("data: "):])["error"]
            stream.update(error=err, error_after_last_frame_s=times[errs[-1]]
                          - times[errs[-1] - 1] if errs[-1] else None,
                          error_s=times[errs[-1]] - t0)
        print(f"serve9: mid-stream crash: {json.dumps(stream)}", flush=True)
        mark("stream_crash")
        if (not errs or errs[-1] < 1 or stream["error"]["code"] != 502
                or lines[-1] != "data: [DONE]" or stream["error_s"] > 30
                or router_x.counters["failover_stream_error"] != 1):
            raise AssertionError(f"serve9: the mid-stream crash: {stream}, {lines[-4:]}")

        # -- failover ------------------------------------------------------
        if flush_every is not None:
            real_flush_every, api._PARTIAL_FLUSH_EVERY = api._PARTIAL_FLUSH_EVERY, flush_every
        first_chunk = api._PARTIAL_FLUSH_EVERY
        try:
            jid_f = c.infer(rows_f, model=catalog, stay_attached=False,
                            sampling_params=sampling)
            owner = router.job_owner(jid_f)
            survivor = "r1" if owner == "r0" else "r0"
            wait_for(lambda: len(store.read_partial(jid_f)) >= first_chunk
                     or store.status(jid_f).is_terminal(), "F's first partial chunk")
            faults.configure("runner.decode:oom:nth=1,times=1")
            wait_for(lambda: store.status(jid_f).is_terminal(), "F to fail on its owner")
        finally:
            faults.clear()
            if flush_every is not None:
                api._PARTIAL_FLUSH_EVERY = real_flush_every
        if store.status(jid_f).value != "FAILED":
            raise AssertionError(f"serve9: F ended {store.status(jid_f)} on {owner}")
        partial = store.read_partial(jid_f)
        t_kill = time.monotonic()
        servers[owner].shutdown()
        servers[owner].server_close()
        wait_for(lambda: router.counters["failover_batch"] >= 1, "the failover", 120)
        t_moved = time.monotonic()
        wait_for(lambda: c.get_job_status(jid_f) == "SUCCEEDED", "F on the survivor")
        t_done = time.monotonic()
        fleet_doc = c.get_fleet()
        res_f = store.read_results(jid_f)
        ids = list(res_f["row_id"])
        lost = n_failover - len(set(ids) & set(range(n_failover)))
        dup = len(ids) - len(set(ids))
        by_row = dict(zip(ids, res_f["outputs"]))
        kept = sum(by_row.get(i) == row["outputs"] for i, row in partial.items())
        failover = {"owner": owner, "survivor": survivor, "rows": n_failover,
                    "rows_stored_before_kill": len(partial), "stored_rows_equal": kept,
                    "rows_lost": lost, "rows_duplicated": dup,
                    "kill_to_failover_s": t_moved - t_kill,
                    "kill_to_succeeded_s": t_done - t_kill,
                    "router_owner": router.job_owner(jid_f),
                    "failovers": fleet_doc["failovers"],
                    "doctor": fleet_doc["doctor"]["verdict"],
                    "n_healthy": fleet_doc["n_healthy"]}
        print(f"serve9: failover: {json.dumps(failover)}", flush=True)
        if (lost or dup or len(ids) != n_failover or kept != len(partial)
                or len(partial) < first_chunk or failover["router_owner"] != survivor
                or fleet_doc["failovers"]["batch"] < 1 or fleet_doc["doctor"]["verdict"]
                == "healthy" or fleet_doc["n_healthy"] != 1):
            raise AssertionError(f"serve9: failover: {failover}")
        mark("failover")
        # the resumed rows again as a job of their own on the survivor:
        # how many match the resumed run's tokens (printed, not held)
        resumed = [i for i in range(n_failover) if i not in partial]
        jid_u = direct(by_rid[survivor], [rows_f[i] for i in resumed])
        unkilled = results(jid_u)["outputs"]
        failover["resumed_rows"] = len(resumed)
        failover["resumed_equal_to_unkilled"] = sum(
            by_row[i] == u for i, u in zip(resumed, unkilled))
        mark("unkilled_run")

        # -- observability -------------------------------------------------
        wait_for(lambda: router.monitor is None or router.monitor.snapshot_doc()["ticks"] >= 1,
                 "a fleet monitor tick", 30)
        mon = c.get_fleet_monitor()
        records = c.get_replay_log()
        chats = [r for r in records if str(r.get("session_id", "")).startswith("fleet-s")]
        if len(chats) != 2 * n_sessions or not all(r.get("body") for r in chats):
            raise AssertionError(f"serve9: the replay log holds {len(chats)} of the chats")
        replayed = replay_mod.replay(furl, chats, speedup=4.0, timeout=300.0)
        if replayed["ok"] != 2 * n_sessions or replayed["errors"]:
            raise AssertionError(f"serve9: the replay: {replayed}")
        monitor = None if mon is None else {
            "ticks": mon["ticks"], "verdict": mon["verdicts"]["fleet"]["verdict"],
            "rules": {r["name"]: r["state"] for r in mon["rules"]}}
        wall = time.monotonic() - t_start
        mark("observability_and_replay")
        launches = counts()

        # -- the split decode behind S on the survivor's whole head ------------
        runner = by_rid[survivor]._get_runner(mcfg.name, mcfg)[0]
        head = runner.params.get("lm_head")
        if head is not None:
            with torch.no_grad():
                head.copy_(whole)
        prompts = [np.asarray(x, np.int32) for x in encode_chat_batch(
            tok, [u[0] for u in user], system, mcfg.chat_template)]
        template = shared_head(prompts, PSz)
        split = check_split_decode(torch, runner, template, prompts[:8], rng,
                                   "serve9 chat prompts")
    finally:
        faults.clear()
        for r_, f_, s_ in helpers:
            r_.stop()
            f_.shutdown()
            try:
                s_.shutdown()
                s_.server_close()
            except OSError:
                pass
        router.stop()
        fsrv.shutdown()
        for rid, srv in servers.items():
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass
        for eng in engines:
            eng.close(timeout=60)
            eng._runner_cache.clear()
        whole = None

    out = {
        "card": card, "wall_s": wall, "replicas": builds,
        "allocated_bytes": allocated,
        "phase_ends_s": marks,
        "routing": {"a": {"owner": owner_a, "wall_s": wall_a, "rows": n_rows,
                          "output_tokens": rec_a["output_tokens"], "traced": True},
                    "a_direct_on_r1": {"wall_s": wall_a1, "traced": False,
                                       "output_tokens": rec_a1["output_tokens"]},
                    "b": {"owner": owner_b, "wall_s": wall_b,
                          "output_tokens": rec_b["output_tokens"]},
                    # the untraced routed job's output tokens over its wall
                    "routed_tok_s": rec_b["output_tokens"] / wall_b,
                    "traced_tok_s": rec_a["output_tokens"] / wall_a,
                    # a cross-run estimate, not one run's share: the
                    # traced run's device time over the wall of the same
                    # rows run untraced on r1 (the profiler's host cost
                    # is not the card's)
                    "cross_run_busy_share": traced["device_busy_ms"] / 1e3 / wall_a1},
        "trace": traced, "affinity": affinity, "stitched": stitched,
        "stream_error": stream, "failover": failover, "monitor": monitor,
        "replay": {k: replayed[k] for k in ("n", "sent", "ok", "errors", "wall_s", "ttft")},
        "split_vs_full_rel_l2": split[0], "split_vs_full_layer0_attn_max_abs": split[1],
        "launches": launches,
    }
    for k in kernels:
        if launches[k.name] <= 0:
            raise AssertionError(f"serve9: kernel {k.name} was not launched by the serve")
    for k in absent:
        if launches[k.name]:
            raise AssertionError(f"serve9: kernel {k.name} launched {launches[k.name]} times")
    print("serve9: " + json.dumps(out), flush=True)
    return out


def fleet_summary(out: dict) -> dict:
    """Serve 9's headline figures, for a line near the end of the output."""
    t, fo = out["trace"], out["failover"]
    return {
        "card": out["card"], "wall_s": out["wall_s"],
        "build_s": [r["build_s"] for r in out["replicas"]],
        "routed_tok_s": out["routing"]["routed_tok_s"],
        "traced_job": {"wall_s": out["routing"]["a"]["wall_s"],
                       "untraced_wall_s": out["routing"]["a_direct_on_r1"]["wall_s"],
                       "device_busy_ms": t["device_busy_ms"],
                       "device_idle_share": t["device_idle_share"],
                       "cross_run_busy_share": out["routing"]["cross_run_busy_share"],
                       "trace_bytes": t["file_bytes"], "export_s": t["export_s"]},
        "failover_s": fo["kill_to_succeeded_s"], "rows_lost": fo["rows_lost"],
        "rows_duplicated": fo["rows_duplicated"],
        "stream_error_s": out["stream_error"].get("error_s"),
        "affinity_hits": out["affinity"]["router_prefix_hits"],
        "stitched_spans": out["stitched"]["spans"],
        "replay": {k: out["replay"][k] for k in ("sent", "ok", "errors")},
        "launches": out["launches"],
    }



def fleet_checkpoint(torch, home: Path, model: str = "qwen3-8b", seed: int = 0) -> Path:
    """Serve 9's or 10's checkpoint when it runs alone (``--serve9-only``,
    ``--serve10-only``): ``model``'s random weights from the seed (pass
    the ``cut_model`` key for the serves' depth), written as serve 5
    writes them; returns the weights root."""
    import gc

    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS[model]
    geometry = dict(ENGINES[model][0], decode_batch_size=1)   # weights only: a small pool
    runner = ModelRunner(mcfg, EngineConfig(**geometry, seed=seed), device="cuda")
    need = float(sum(t.numel() * t.element_size() for _, t in flat_leaves(runner.params)))
    root = checkpoint_root(home, need)
    t0 = time.monotonic()
    ckpt = write_checkpoint(torch, runner.params, mcfg, root / mcfg.name)
    print(f"serve9: checkpoint of {ckpt['bytes'] / 1e9:.2f} GB written in "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return root

EMBED_MODEL = "qwen3-emb-0.6b"          # catalog name qwen-3-embedding-0.6b
EMBED_CHECK_ROWS = 8


def write_embed_csvs(rng, tok, template: str, root: Path, n_files: int,
                     rows_per_file: int) -> list:
    """Serve 6's dataset: ``n_files`` CSV files of ``rows_per_file`` rows
    (columns ``id`` and ``text``) of random text of at least 16 tokens,
    each row's prompt (the chat template around it) at most 1,024
    tokens. Returns the texts in file order."""
    import csv

    from sutro_tpu_torch.engine.tokenizer import encode_chat_batch

    frame = len(encode_chat_batch(tok, [""], None, template)[0])
    texts = []
    root.mkdir(parents=True, exist_ok=True)
    for f in range(n_files):
        with open(root / f"part-{f}.csv", "w", newline="", encoding="utf-8") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow(["id", "text"])
            for n in rng.integers(16, 1024 - frame + 1, rows_per_file):
                text = "".join(rng.choice(ALPHABET, int(n)))
                w.writerow([len(texts), text])
                texts.append(text)
    return texts


def _embed_rows_check(torch, runner, token_rows) -> dict:
    """``EMBED_CHECK_ROWS`` rows of mixed length embedded three ways on
    the engine's runner: one batch through the kernel, the same forward
    with the plain attention, and each row alone through the kernel.
    Each pair must agree to a cosine of at least 0.999."""
    rows = [list(map(int, r)) for r in token_rows]
    batch = runner.embed_batch(rows)
    with plain_kernels():
        plain = runner.embed_batch(rows)
    alone = np.stack([runner.embed_batch([r])[0] for r in rows])
    out = {}
    for name, other in (("plain_attention", plain), ("alone", alone)):
        cos = (batch * other).sum(1) / (np.linalg.norm(batch, axis=1)
                                        * np.linalg.norm(other, axis=1))
        out[name] = {"worst_cosine": float(cos.min()),
                     "max_abs": float(np.abs(batch - other).max())}
        if cos.min() < 0.999:
            raise AssertionError(f"serve6: batch vs {name}: cosine {cos.min()} < 0.999")
    out["lengths"] = [len(r) for r in rows]
    return out


def serve_embed(torch, kernels, absent, card: str, home: Path, seed: int = 0,
                n_files: int = 2, rows_per_file: int = 2048, n_other: int = 256,
                yield_after: int = 512) -> dict:
    """Serve 6: embedding jobs through ``import sutro_tpu_torch as so`` on
    ``qwen-3-embedding-0.6b`` (random weights from the seed) at serve 1's
    geometry (``decode_batch_size`` 64, so batches of 64 rows). Job E1:
    ``n_files`` CSV files of ``rows_per_file`` rows, uploaded as a dataset
    and submitted as ``dataset-<id>`` at ``job_priority=1``. Job E2:
    ``n_other`` rows as a list at ``job_priority=0``, submitted once E1 has
    passed ``yield_after`` rows, so E1 yields at its next batch, requeues and resumes
    from its flushed rows. Every ``embed_batch`` call's rows are
    recorded to show it."""
    import hashlib

    import sutro_tpu_torch as so
    from sutro_tpu_torch.engine import api, runner as runner_mod
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer, encode_chat_batch
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS[EMBED_MODEL]
    fields = ENGINES[EMBED_MODEL][0]
    pool = (1 + fields["decode_batch_size"] * fields["max_pages_per_seq"]) * fields[
        "kv_page_size"] * mcfg.num_layers * 2 * mcfg.num_kv_heads * mcfg.head_dim * 2
    weights = 2 * (mcfg.vocab_size * mcfg.hidden_size + mcfg.num_layers * (
        mcfg.hidden_size * (mcfg.num_heads + 2 * mcfg.num_kv_heads) * mcfg.head_dim
        + mcfg.num_heads * mcfg.head_dim * mcfg.hidden_size
        + 3 * mcfg.hidden_size * mcfg.intermediate_size))
    print(f"serve6: {EMBED_MODEL} runner: ~{weights / 1e9:.2f} GB of bf16 weights and a "
          f"{pool / 1e9:.2f} GB pool; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
          f"before it, {torch.cuda.mem_get_info()[0] / 1e9:.1f} GB free", flush=True)
    (home / "engine.json").write_text(json.dumps({**fields, "seed": seed}))
    tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
    rng = np.random.default_rng(seed + 6)
    texts = write_embed_csvs(rng, tok, mcfg.chat_template, home / "embed-csv", n_files,
                             rows_per_file)
    others = ["".join(rng.choice(ALPHABET, int(n))) for n in rng.integers(16, 1001, n_other)]
    key = lambda ids: hashlib.sha1(np.asarray(ids, np.int32).tobytes()).digest()  # noqa: E731
    e1_tokens = encode_chat_batch(tok, texts, None, mcfg.chat_template)
    e1_keys = {key(ids) for ids in e1_tokens}
    if len(e1_keys) != len(texts):
        raise AssertionError("serve6: E1's rows are not distinct")

    calls = []   # per embed_batch call: its rows' keys
    real_embed = runner_mod.ModelRunner.embed_batch

    def recording_embed(self, rows):
        calls.append([key(r) for r in rows])
        return real_embed(self, rows)

    model = "qwen-3-embedding-0.6b"
    t_ds = time.monotonic()
    ds = so.create_dataset()
    names = so.upload_to_dataset(ds, [str(home / "embed-csv")], verbose=False)
    upload_s = time.monotonic() - t_ds
    engine = so.Sutro().engine
    statuses = {}
    real_set_status = engine.jobs.set_status

    def set_status(job_id, status, **kw):
        statuses.setdefault(job_id, []).append(status.value)
        return real_set_status(job_id, status, **kw)

    engine.jobs.set_status = set_status
    runner_mod.ModelRunner.embed_batch = recording_embed
    for k in (*kernels, *absent):
        k.launches = 0
    try:
        t_submit = time.monotonic()
        e1 = so.infer(ds, column="text", model=model, job_priority=1, stay_attached=False)
        submit_s = time.monotonic() - t_submit
        if e1 is None:
            raise AssertionError("serve6: job E1 was refused")
        while engine.job_status(e1) in ("QUEUED", "STARTING"):
            time.sleep(0.005)
        to_running = time.monotonic() - t_submit
        jm = engine.metrics.job(e1)
        while jm.rows_completed <= yield_after and engine.job_status(e1) == "RUNNING":
            time.sleep(0.002)
        e2_at = jm.rows_completed
        t_e2 = time.monotonic()
        e2 = so.infer(others, model=model, job_priority=0, stay_attached=False)
        for name, jid in (("E2", e2), ("E1", e1)):
            if so.await_job_completion(jid, timeout=900, obtain_results=False) != jid:
                raise AssertionError(f"serve6: job {name} ended {engine.job_status(jid)}: "
                                     f"{engine.get_job(jid)['failure_reason']}")
        wall = time.monotonic() - t_submit
        launches = {k.name: k.launches for k in (*kernels, *absent)}
    finally:
        runner_mod.ModelRunner.embed_batch = real_embed
        engine.jobs.set_status = real_set_status

    out = {"card": card, "dataset": {"id": ds, "files": names, "upload_s": upload_s},
           "submit_s": submit_s, "submit_to_running_s": to_running, "wall_s": wall,
           "e2_submitted_at_rows": e2_at, "embed_batch_calls": len(calls), "jobs": {}}
    for name, jid, rows, t0 in (("E1", e1, texts, t_submit), ("E2", e2, others, t_e2)):
        rec = engine.get_job(jid)
        res = engine.job_results(jid, include_inputs=True)
        if rec["status"] != "SUCCEEDED" or res["inputs"] != rows or len(
                res["outputs"]) != len(rows) or "errors" in res:
            raise AssertionError(f"serve6: job {name}'s results are not 1:1 with its inputs")
        vecs = np.asarray(res["outputs"], np.float64)
        norms = np.linalg.norm(vecs, axis=1)
        if vecs.shape != (len(rows), mcfg.hidden_size) or not np.isfinite(vecs).all() or (
                np.abs(norms - 1.0).max() > 1e-3):
            raise AssertionError(f"serve6: job {name}'s vectors: shape {vecs.shape}, "
                                 f"norms {norms.min()}..{norms.max()}")
        perf = rec["perf"]
        job_dir = engine.jobs._dir(jid)
        json_bytes = sum(f.stat().st_size for f in job_dir.rglob("*.jsonl*")
                         if f.name != "inputs.jsonl")
        n_in = rec["input_tokens"]
        out["jobs"][name] = {
            "rows": len(rows), "input_tokens": n_in,
            "wall_s": _record_s(rec, "datetime_created", "datetime_completed"),
            "embed_s": perf["embed"]["total_s"], "embed_calls": perf["embed"]["count"],
            "jobstore_flush_ms": 1e3 * perf.get("jobstore_flush", {}).get("total_s", 0.0),
            "jobstore_flushes": perf.get("jobstore_flush", {}).get("count", 0),
            "jobstore_finalize_ms": 1e3 * perf["jobstore_finalize"]["total_s"],
            "json_bytes_written": json_bytes,
            "norm_max_dev": float(np.abs(norms - 1.0).max()),
            "statuses": statuses.get(jid, []),
        }
        j = out["jobs"][name]
        j["rows_per_s"] = len(rows) / j["wall_s"]
        j["input_tok_s"] = n_in / j["wall_s"]
        j["embed_rows_per_s"] = len(rows) / j["embed_s"]
        j["embed_input_tok_s"] = n_in / j["embed_s"]
    # E1 yielded: E2's rows were embedded between two of E1's batches,
    # E1 went back to QUEUED and ran again, and no row of E1 was
    # embedded twice
    e2_calls = [i for i, c in enumerate(calls) if not set(c) & e1_keys]
    e1_calls = [i for i, c in enumerate(calls) if set(c) <= e1_keys]
    if len(e1_calls) + len(e2_calls) != len(calls) or not e2_calls or not (
            e1_calls[0] < e2_calls[0] and e2_calls[-1] < e1_calls[-1]):
        raise AssertionError(f"serve6: E2's batches {e2_calls} did not run between E1's")
    st1 = out["jobs"]["E1"]["statuses"]
    if st1.count("RUNNING") < 2 or "QUEUED" not in st1[st1.index("RUNNING"):]:
        raise AssertionError(f"serve6: E1 did not yield and resume: {st1}")
    e1_rows = [k for i in e1_calls for k in calls[i]]
    if len(e1_rows) != len(set(e1_rows)) or set(e1_rows) != e1_keys:
        raise AssertionError(f"serve6: E1 embedded {len(e1_rows)} rows for {len(e1_keys)} "
                             "distinct rows: a flushed row was embedded again, or one was lost")
    out["e1_batches_before_yield"] = sum(1 for i in e1_calls if i < e2_calls[0])
    out["launches"] = launches
    for k in kernels:   # flash prefill: one launch a layer of each call
        if launches[k.name] != mcfg.num_layers * len(calls):
            raise AssertionError(f"serve6: {k.name} launched {launches[k.name]} times, not "
                                 f"{mcfg.num_layers} x {len(calls)} embed_batch calls")
    for k in absent:
        if launches[k.name]:
            raise AssertionError(f"serve6: kernel {k.name} launched {launches[k.name]} times")
    # three ways of embedding 8 of E1's rows of mixed length
    runner6 = engine._runner_cache[EMBED_MODEL][0]
    order = np.argsort([len(r) for r in e1_tokens])
    pick = [e1_tokens[i] for i in order[np.linspace(0, len(order) - 1,
                                                    EMBED_CHECK_ROWS).astype(int)]]
    out["rows_check"] = _embed_rows_check(torch, runner6, pick)
    # the getters of the façade on E1
    diag = so.diagnose_job(e1)
    rl = diag["processes"]["rank0"].get("roofline") or {}
    if "H100" not in str(rl.get("device_kind")) or "reason" in rl:
        raise AssertionError(f"serve6: the doctor did not grade against the H100 row: {rl}")
    trace = so.get_trace(e1)
    n_events = sum(1 for ev in trace["traceEvents"] if ev.get("ph") == "X")
    if not n_events:
        raise AssertionError("serve6: get_trace gave no trace events")
    out["doctor"] = {"verdict": diag["verdict"], "evidence": diag.get("evidence", [])[:4],
                     "roofline": rl}
    out["trace_events"] = n_events
    print("serve6: " + json.dumps(out), flush=True)
    print(f"serve6: card={card} submit_to_running_s={to_running:.2f} wall_s={wall:.2f} "
          + " ".join(f"[{n}: rows={j['rows']} rows_per_s={j['rows_per_s']:.1f} "
                     f"input_tok_s={j['input_tok_s']:.0f} embed_rows_per_s="
                     f"{j['embed_rows_per_s']:.1f} flush_ms={j['jobstore_flush_ms']:.1f} "
                     f"finalize_ms={j['jobstore_finalize_ms']:.1f} json_bytes="
                     f"{j['json_bytes_written']}]" for n, j in out["jobs"].items())
          + f" doctor={diag['verdict']} launches={json.dumps(launches)} "
          f"worst_cosine={min(v['worst_cosine'] for k, v in out['rows_check'].items() if k != 'lengths'):.6f}",
          flush=True)
    engine.close(timeout=30)
    engine._runner_cache.clear()
    so._instance._engine = None
    api.reset_engine()
    del runner6
    return out


def _port_kernels():
    """Every kernel wrapper of the port (their launch counters)."""
    from sutro_tpu_torch.ops import (
        flash_prefill, grouped_matmul, kv_write, paged_decode, prefix_carry,
    )

    return (paged_decode.KERNEL, paged_decode.CARRY, paged_decode.INT8, prefix_carry.KERNEL,
            kv_write.KERNEL, flash_prefill.KERNEL, grouped_matmul.KERNEL)


# each of serve 10's two ranks may hold this share of the card, 38.4 GiB
# of an H100's 79.2: 29.4 GiB of weights and pools (qwen3-8b and
# qwen-3-embedding-0.6b at 32 rows of DP_PAGES pages), the rest for
# activations (an embedding batch's K/V stack is 3.5 GiB), leaving room
# for the three processes' CUDA contexts
DP_MEMORY_FRACTION = 0.485
# 1,664 tokens a row: S (~1,060 tokens with the chat template), a
# 500-character row and 32 new tokens
DP_PAGES = 26


def dp_rank(args) -> int:
    """``chip_smoke.py --dp-rank N --device D --models A,B``: one rank of
    serve 10, a process of its own (``SUTRO_DP_WORLD``, ``SUTRO_DP_RANK``
    and ``SUTRO_DP_COORD`` in its environment, ``$SUTRO_HOME/engine.json``
    its engine). It builds the engine's runners for the models (loaded
    from ``weights_dir``), zeroes every kernel's launch counter, serves
    the engine over HTTP and prints one ``ready`` line with its URL,
    build seconds, device bytes and a digest of its weights'
    ``leaf_checksums``. Until ``$SUTRO_HOME/stop`` appears (or its parent
    is gone) it writes the counters to ``$SUTRO_HOME/launches.json``
    every 0.1 s; then it prints them and exits."""
    import faulthandler
    import hashlib
    import logging
    import os
    import signal

    import torch

    from sutro_tpu_torch.engine import api
    from sutro_tpu_torch.engine.config import load_engine_config
    from sutro_tpu_torch.engine.runner import set_matmul_precision
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    from sutro_tpu_torch.server import start_server_thread

    rank = int(args[args.index("--dp-rank") + 1])
    device = args[args.index("--device") + 1]
    models = args[args.index("--models") + 1].split(",")
    for m in models:   # a model cut to fewer layers (``cut_model``)
        base, _, layers = m.rpartition("-l")
        if base and layers.isdigit():
            cut_model(base, int(layers))
    tag = f"serve10-rank{rank}"
    home = Path(os.environ["SUTRO_HOME"])
    parent = os.getppid()
    # SIGUSR1 prints every thread's stack (serve 10 asks before it gives
    # up on a rank), and the channel's own log lines go to the log too
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    logging.basicConfig(level=logging.INFO, format=f"{tag} %(name)s: %(message)s")
    if device != "cpu":
        # two ranks share the card: each caps its allocator, so that the
        # blocks one process caches cannot starve the other's next job
        torch.cuda.set_per_process_memory_fraction(DP_MEMORY_FRACTION)
    set_matmul_precision()
    kernels = _port_kernels()
    eng = api.LocalEngine(load_engine_config(), device=device)
    t0 = time.monotonic()
    digest = hashlib.sha256()
    for m in models:
        runner = eng._get_runner(m, MODEL_CONFIGS[m])[0]
        digest.update(json.dumps(sorted(leaf_checksums(torch, runner.params).items())).encode())
    if device != "cpu":
        torch.cuda.synchronize()
    ready = {"build_s": time.monotonic() - t0, "weights_digest": digest.hexdigest()[:16],
             "allocated_bytes": torch.cuda.memory_allocated() if device != "cpu" else 0}
    for k in kernels:
        k.launches = 0
    srv, _, url = start_server_thread(eng)
    print(f"{tag}: ready " + json.dumps({"url": url, **ready}), flush=True)
    counts_path = home / "launches.json"

    def dump():
        tmp = counts_path.with_suffix(".tmp")
        tmp.write_text(json.dumps({k.name: k.launches for k in kernels}))
        tmp.replace(counts_path)

    try:
        while not (home / "stop").exists():
            if os.getppid() != parent:
                raise SystemExit(f"{tag}: the parent process is gone")
            dump()
            time.sleep(0.1)
    finally:
        dump()
        srv.shutdown()
        srv.server_close()
        eng.close(timeout=60)
    print(f"{tag}: launches " + counts_path.read_text(), flush=True)
    if device != "cpu":
        print(f"{tag}: peak device bytes " + json.dumps({
            "allocated": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.max_memory_reserved()}), flush=True)
    return 0


def embed_checkpoint(torch, root: Path, model: str = EMBED_MODEL, device="cuda",
                     geometry=None, seed: int = 0) -> dict:
    """The embedding model's random weights from the seed, written under
    ``root`` as serve 5 writes qwen3-8b's (serve 10's ranks load it)."""
    import gc

    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    mcfg = MODEL_CONFIGS[model]
    # weights only (a small pool), in the checkpoint's bfloat16
    geometry = dict(geometry or ENGINES[model][0], decode_batch_size=1, param_dtype="bfloat16")
    runner = ModelRunner(mcfg, EngineConfig(**geometry, seed=seed), device=device)
    t0 = time.monotonic()
    ckpt = write_checkpoint(torch, runner.params, mcfg, root / mcfg.name)
    ckpt["write_s"] = time.monotonic() - t0
    del runner
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return ckpt


def serve_dp(torch, kernels, absent, card: str, ckpt_root: Path, *, model="qwen3-8b",
             embed_model=EMBED_MODEL, device="cuda", geometry=None, ref_geometry=None,
             n_gen=256, n_kill=384, n_emb=1024, n_new=32, kill_after=64,
             system_chars=1000, rank_env=None, timeout=300, seed=0) -> dict:
    """Serve 10: one batch job across two data-parallel engine ranks
    (``engine/dphost.py``), each a process of its own on the same card
    (``dp_rank``), both loading ``model`` from the checkpoint serve 5
    wrote (``ckpt_root``) and ``embed_model`` from one written here, at
    serve 9's geometry (``decode_batch_size`` 32, an admission budget of
    the pool's tokens, ``prefix_split``) with rows of ``DP_PAGES`` pages,
    each process capped at ``DP_MEMORY_FRACTION`` of the card. Rank 0 coordinates on a free
    local port. Every job's payload goes to both ranks through the
    remote SDK, as a launcher of rank processes would send it.

    - Job G: ``n_gen`` rows of 16-500 characters under serve 7's system
      prompt S (a prefix group on both ranks: the carry kernels), ``n_new``
      tokens, greedy. Rank 0's merged results must hold every row once in
      input order; its telemetry document a ``workers`` section of rank
      1 with spans and counters; ``diagnose_job`` a verdict over both
      processes; ``get_job_fleet`` both ranks.
    - Job E: ``n_emb`` rows through the embedding job's dp branch: every
      row once, every vector finite.
    - Job K: ``n_kill`` rows with no system prompt. Once rank 0's live
      fleet view shows ``kill_after`` of rank 1's rows merged, rank 1's
      process is killed (SIGKILL): K must end SUCCEEDED on rank 0 with
      every row once, rank 1 ``lost`` in the fleet view and in
      ``fleet.json``, and at least one row requeued.
    - The single-host reference: after the ranks exit, one
      ``LocalEngine`` in this process (``ref_geometry``, no ``SUTRO_DP_*``
      variable) runs G's, K's and E's rows, submitted together (K
      attaches to G's session): the share of G's and K's rows
      with equal tokens, and E's largest absolute difference and lowest
      cosine, are printed (not held: bf16 at another batch composition
      may flip near-ties).

    Each rank's launch counters are read from its ``launches.json``
    (rank 1's last before its kill): ``kernels`` must launch on both
    ranks, ``absent`` on neither (both empty on the CPU). A rank that
    fails, hangs past ``timeout`` or exits non-zero (but for the kill)
    fails the serve; no rank outlives it."""
    import os
    import signal
    import socket
    import subprocess
    import threading

    from sutro_tpu_torch.engine import api
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.jobstore import JobStore
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS
    from sutro_tpu_torch.sdk import Sutro

    t_start = time.monotonic()
    catalog = {"qwen3-8b": "qwen-3-8b", EMBED_MODEL: "qwen-3-embedding-0.6b"}
    gen_name, emb_name = catalog.get(model, model), catalog.get(embed_model, embed_model)
    if geometry is None:
        # serve 9's (serve 1's geometry at half its slots), with rows of
        # DP_PAGES pages: each rank also holds the embedding model, whose
        # pool takes the same geometry
        geometry = dict(ENGINES[model][0], max_pages_per_seq=DP_PAGES)
        geometry["decode_batch_size"] //= 2
        geometry["max_model_len"] = DP_PAGES * geometry["kv_page_size"]
    base = dict(geometry, prefix_split=True, weights_dir=str(ckpt_root), seed=seed,
                max_batch_tokens=geometry["decode_batch_size"] * geometry["max_model_len"])
    emb_ckpt = embed_checkpoint(torch, ckpt_root, embed_model, device, geometry, seed)
    print(f"serve10: {embed_model} checkpoint of {emb_ckpt['bytes'] / 1e9:.2f} GB written in "
          f"{emb_ckpt['write_s']:.1f}s", flush=True)
    rng = np.random.default_rng(seed + 10)
    text = lambda r, n: "".join(r.choice(ALPHABET, int(n)))  # noqa: E731
    system = online_system_prompt(np.random.default_rng(seed + 7), system_chars)
    rows_g = [text(rng, n) for n in rng.integers(16, 501, n_gen)]
    rows_k = [text(rng, n) for n in rng.integers(16, 501, n_kill)]
    rows_e = [text(rng, n) for n in rng.integers(16, 501, n_emb)]
    sampling = {"temperature": 0.0, "max_new_tokens": n_new}

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    smoke_home = Path(os.environ["SUTRO_HOME"])
    homes, procs, readers, lines = [], [], [], [[], []]
    ready = [threading.Event(), threading.Event()]

    def read(r, proc):
        with open(homes[r] / "rank.log", "w") as log:
            for line in proc.stdout:
                log.write(line)
                log.flush()
                lines[r].append(line.rstrip("\n"))
                if line.startswith(f"serve10-rank{r}:"):
                    print(line.rstrip("\n"), flush=True)
                    if ": ready " in line:
                        ready[r].set()

    def give_up(message):
        """The ranks' stacks and their logs' tails, then the failure."""
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(2.0)
        for r in range(len(procs)):
            print(f"serve10: rank {r}'s log, last 60 lines:\n" + "\n".join(lines[r][-60:]),
                  flush=True)
        raise AssertionError(message)

    def wait_for(pred, what, limit=timeout, status=None):
        t0 = deadline = time.monotonic()
        deadline += limit
        said = t0
        while not pred():
            for r, p in enumerate(procs):
                if p.poll() is not None and not ended.get(r):
                    give_up(f"serve10: rank {r} exited {p.returncode} while waiting for {what}")
            now = time.monotonic()
            if now > deadline:
                give_up(f"serve10: timed out waiting for {what}")
            if status is not None and now - said > 30:
                said = now
                print(f"serve10: {now - t0:.0f}s waiting for {what}: {status()}", flush=True)
            time.sleep(0.05)

    def launches(r):
        return json.loads((homes[r] / "launches.json").read_text())

    ended, out = {}, {"card": card}   # ranks whose exit is expected
    try:
        for r in range(2):
            home_r = smoke_home / f"dp-rank{r}"
            home_r.mkdir(parents=True, exist_ok=True)
            (home_r / "engine.json").write_text(json.dumps(base))
            homes.append(home_r)
            env = dict(os.environ, SUTRO_HOME=str(home_r), SUTRO_DP_WORLD="2",
                       SUTRO_DP_RANK=str(r), SUTRO_DP_COORD=f"127.0.0.1:{port}",
                       SUTRO_MONITOR="0", PYTHONUNBUFFERED="1",
                       PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
                       **(rank_env or {}).get(r, {}))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(r),
                 "--device", device, "--models", f"{model},{embed_model}"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
            readers.append(threading.Thread(target=read, args=(r, procs[r]), daemon=True))
            readers[r].start()
        wait_for(lambda: all(e.is_set() for e in ready), "both ranks ready")
        info = [json.loads(next(x for x in lines[r] if ": ready " in x).split(": ready ", 1)[1])
                for r in range(2)]
        out["ranks_ready_s"] = time.monotonic() - t_start
        out["ranks"] = info
        if info[0]["weights_digest"] != info[1]["weights_digest"]:
            raise AssertionError(f"serve10: the ranks hold different weights: {info}")
        clients = [Sutro(backend="remote", base_url=i["url"], api_key="smoke") for i in info]
        store0 = JobStore(root=homes[0] / "jobs")

        def run_job(rows, name, **kw):
            """The payload to rank 1, then rank 0; (rank 0's id, rank 1's
            id, the seconds from the submit to rank 0's SUCCEEDED)."""
            t0 = time.monotonic()
            jid1, jid0 = (c.infer(rows, model=name, stay_attached=False, **kw)
                          for c in clients[::-1])
            return jid0, jid1, t0

        def finish(jid0, jid1, t0, what):
            def status():
                return {"rank0": clients[0].get_job_status(jid0),
                        "rank1": None if ended.get(1) else clients[1].get_job_status(jid1),
                        "fleet": {k: v for k, v in clients[0].get_job_fleet(jid0).items()
                                  if k in ("rows", "ranks", "counters")}}

            wait_for(lambda: clients[0].get_job_status(jid0) in ("SUCCEEDED", "FAILED",
                                                                 "CANCELLED"), what,
                     status=status)
            wall = time.monotonic() - t0
            if clients[0].get_job_status(jid0) != "SUCCEEDED":
                give_up(f"serve10: {what} ended {clients[0]._fetch_job(jid0)}")
            return wall

        def merged(jid0, n, what):
            res = store0.read_results(jid0)
            ids = list(res["row_id"])
            lost = n - len(set(ids) & set(range(n)))
            dup = len(ids) - len(set(ids))
            if lost or dup or ids != list(range(n)) or any(o is None for o in res["outputs"]):
                raise AssertionError(f"serve10: {what}: {lost} rows lost, {dup} duplicated, "
                                     f"in order {ids == sorted(ids)}")
            return res["outputs"], {"rows_lost": lost, "rows_duplicated": dup}

        # -- job G: generation under S on both ranks ---------------------------
        jid0, jid1, t0 = run_job(rows_g, gen_name, system_prompt=system, sampling_params=sampling)
        wall = finish(jid0, jid1, t0, "job G")
        wait_for(lambda: clients[1].get_job_status(jid1) == "SUCCEEDED", "rank 1's part of G")
        outs_g, ok_g = merged(jid0, n_gen, "job G")
        tele = clients[0].get_job_telemetry(jid0)
        workers = [w for w in tele.get("workers", []) if w.get("rank") == 1]
        diag = clients[0].diagnose_job(jid0)
        fleet_g = clients[0].get_job_fleet(jid0)
        rank1_rows = (workers[0].get("counters") or {}).get("rows_ok", 0) if workers else 0
        out["g"] = {"rows": n_gen, "wall_s": wall, "rows_per_s": n_gen / wall, **ok_g,
                    "rank_rows": [n_gen - rank1_rows, rank1_rows],
                    "worker_spans": len(workers[0].get("spans", [])) if workers else 0,
                    "worker_counters": workers[0].get("counters") if workers else None,
                    "stages": tele.get("stages"), "verdict": diag.get("verdict"),
                    "doctor_processes": sorted(diag.get("processes") or {}),
                    "fleet_ranks": sorted(fleet_g.get("ranks") or {}),
                    "fleet_rows": fleet_g.get("rows")}
        print("serve10: job G " + json.dumps(out["g"]), flush=True)
        if (len(workers) != 1 or not out["g"]["worker_spans"] or not rank1_rows
                or diag.get("verdict") in (None, "insufficient_data")
                or out["g"]["doctor_processes"] != ["rank0", "rank1"]
                or out["g"]["fleet_ranks"] != ["0", "1"]
                or fleet_g["rows"]["done"] != n_gen):
            raise AssertionError(f"serve10: job G's dp surfaces: {out['g']}")

        # -- job E: embeddings through the dp branch ---------------------------
        jid0, jid1, t0 = run_job(rows_e, emb_name)
        wall = finish(jid0, jid1, t0, "job E")
        wait_for(lambda: clients[1].get_job_status(jid1) == "SUCCEEDED", "rank 1's part of E")
        outs_e, ok_e = merged(jid0, n_emb, "job E")
        vecs = np.asarray(outs_e, np.float32)
        fleet_e = clients[0].get_job_fleet(jid0)
        workers = [w for w in clients[0].get_job_telemetry(jid0).get("workers", [])
                   if w.get("rank") == 1]
        rank1_rows = (workers[0].get("counters") or {}).get("rows_ok", 0) if workers else 0
        out["e"] = {"rows": n_emb, "wall_s": wall, "rows_per_s": n_emb / wall, **ok_e,
                    "dim": int(vecs.shape[1]), "fleet_ranks": sorted(fleet_e.get("ranks") or {}),
                    "rank_rows": [n_emb - rank1_rows, rank1_rows]}
        if (not np.isfinite(vecs).all() or out["e"]["fleet_ranks"] != ["0", "1"]
                or not rank1_rows):
            raise AssertionError(f"serve10: job E: {out['e']}")
        print("serve10: job E " + json.dumps(out["e"]), flush=True)
        launches_pre_k = [launches(0), launches(1)]

        # -- job K: rank 1 killed mid-job --------------------------------------
        jid0, jid1, t0 = run_job(rows_k, gen_name, sampling_params=sampling)
        assigned1 = len(range(1, n_kill, 2))

        at_kill = {}

        def rank1_merged():
            f = clients[0].get_job_fleet(jid0)
            r1 = (f.get("ranks") or {}).get("1")
            if clients[0].get_job_status(jid0) == "SUCCEEDED":
                raise AssertionError(f"serve10: job K ended before rank 1's kill: {f}")
            at_kill.update(f)
            return r1 is not None and assigned1 - r1["rows_remaining"] >= kill_after

        wait_for(rank1_merged, f"{kill_after} of rank 1's rows of K merged")
        rank1_launches = launches(1)
        ended[1] = True
        procs[1].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        procs[1].wait(timeout=60)
        wall = finish(jid0, jid1, t0, "job K after rank 1's kill")
        t_done = time.monotonic()
        outs_k, ok_k = merged(jid0, n_kill, "job K")
        fleet_k = clients[0].get_job_fleet(jid0)
        disk = json.loads((homes[0] / "jobs" / jid0 / "fleet.json").read_text())
        out["k"] = {"rows": n_kill, "wall_s": wall, "rows_per_s": n_kill / wall, **ok_k,
                    "kill_after_rows": kill_after, "kill_to_succeeded_s": t_done - t_kill,
                    "rank1_state": fleet_k["ranks"]["1"]["state"],
                    "rank1_state_on_disk": disk["ranks"]["1"]["state"],
                    "counters": fleet_k["counters"],
                    # rank 1's merged rows as the view showed them at the kill
                    "rank_rows": [n_kill - (assigned1 - at_kill["ranks"]["1"]["rows_remaining"]),
                                  assigned1 - at_kill["ranks"]["1"]["rows_remaining"]]}
        print("serve10: job K " + json.dumps(out["k"]), flush=True)
        if (out["k"]["rank1_state"] != "lost" or out["k"]["rank1_state_on_disk"] != "lost"
                or fleet_k["counters"]["requeued_rows"] < 1 or disk["counters"]["requeued_rows"] < 1):
            raise AssertionError(f"serve10: job K's fleet view after the kill: {out['k']}")

        # -- the ranks' ends ---------------------------------------------------
        (homes[0] / "stop").write_text("")
        ended[0] = True
        procs[0].wait(timeout=120)
        if procs[0].returncode != 0:
            raise AssertionError(f"serve10: rank 0 exited {procs[0].returncode}: "
                                 + "\n".join(lines[0][-30:]))
        out["launches_by_rank"] = {"rank0": launches(0), "rank1_before_kill": rank1_launches,
                                   "rank0_before_k": launches_pre_k[0],
                                   "rank1_before_k": launches_pre_k[1]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for t in readers:
            t.join(timeout=30)
    out["ranks_s"] = time.monotonic() - t_start

    # -- the single-host reference ---------------------------------------------
    t0 = time.monotonic()
    ref_geometry = ref_geometry or dict(ENGINES[model][0])
    eng = api.LocalEngine(EngineConfig(**dict(
        ref_geometry, prefix_split=True, weights_dir=str(ckpt_root), seed=seed,
        max_batch_tokens=ref_geometry["decode_batch_size"] * ref_geometry["max_model_len"])),
        device=device)
    try:
        # submitted together: K attaches to G's session (one batch)
        jids = {key: eng.submit_batch_inference(payload) for key, payload in (
            ("g", {"model": gen_name, "inputs": rows_g, "system_prompt": system,
                   "sampling_params": sampling}),
            ("k", {"model": gen_name, "inputs": rows_k, "sampling_params": sampling}),
            ("e", {"model": emb_name, "inputs": rows_e}),
        )}
        ref = {}
        for key, jid in jids.items():
            wait_for(lambda: eng.job_status(jid) in ("SUCCEEDED", "FAILED"), f"reference {key}")
            if eng.job_status(jid) != "SUCCEEDED":
                raise AssertionError(f"serve10: reference {key}: {eng.get_job(jid)}")
            ref[key] = eng.job_results(jid)["outputs"]
    finally:
        eng.close(timeout=60)
        eng._runner_cache.clear()
    rvec = np.asarray(ref["e"], np.float32)
    cos = (vecs * rvec).sum(1) / np.maximum(
        np.linalg.norm(vecs, axis=1) * np.linalg.norm(rvec, axis=1), 1e-30)
    out["single_host"] = {
        "wall_s": time.monotonic() - t0,
        "g_token_equal": sum(a == b for a, b in zip(outs_g, ref["g"])),
        "k_token_equal": sum(a == b for a, b in zip(outs_k, ref["k"])),
        "e_max_abs_diff": float(np.abs(vecs - rvec).max()), "e_min_cosine": float(cos.min()),
    }
    out["single_host"]["g_share"] = out["single_host"]["g_token_equal"] / n_gen
    out["single_host"]["k_share"] = out["single_host"]["k_token_equal"] / n_kill
    print("serve10: single host " + json.dumps(out["single_host"]), flush=True)
    out["wall_s"] = time.monotonic() - t_start
    by_rank = out["launches_by_rank"]
    out["launches"] = {k.name: by_rank["rank0"][k.name] + by_rank["rank1_before_kill"][k.name]
                       for k in (*kernels, *absent)}
    for k in kernels:
        for r in ("rank0", "rank1_before_kill"):
            if by_rank[r][k.name] <= 0:
                raise AssertionError(f"serve10: kernel {k.name} was not launched on {r}")
    for k in absent:
        if out["launches"][k.name]:
            raise AssertionError(f"serve10: kernel {k.name} launched {out['launches'][k.name]} "
                                 "times")
    print("serve10: " + json.dumps(out), flush=True)
    return out


def dp_summary(out: dict) -> dict:
    """Serve 10's headline figures, for a line near the end of the output."""
    sh = out["single_host"]
    return {
        "card": out["card"], "wall_s": out["wall_s"], "ranks_ready_s": out["ranks_ready_s"],
        "rows_per_s": {j: out[j]["rows_per_s"] for j in ("g", "e", "k")},
        "g_rank_rows": out["g"]["rank_rows"], "g_verdict": out["g"]["verdict"],
        "kill_to_succeeded_s": out["k"]["kill_to_succeeded_s"],
        "rows_lost": sum(out[j]["rows_lost"] for j in ("g", "e", "k")),
        "rows_duplicated": sum(out[j]["rows_duplicated"] for j in ("g", "e", "k")),
        "requeued_rows": out["k"]["counters"]["requeued_rows"],
        "token_equal_share": {"g": sh["g_share"], "k": sh["k_share"]},
        "e_max_abs_diff": sh["e_max_abs_diff"], "e_min_cosine": sh["e_min_cosine"],
        "launches": out["launches"],
    }


# ---------------------------------------------------------------------------
# Serve 11: a device mesh (tp=2, two rank processes) on qwen3-30b-a3b
# ---------------------------------------------------------------------------

MESH_TP = 2
# serve 11's greedy job: rows and new tokens (reduced from 64 x 32 so the
# whole smoke, with the dp_ep phase, stays under 1,000 s of command)
MESH_ROWS = 32
MESH_NEW = 16
# the depth of serve 11's ep/sp/pp phases (qwen3-30b-a3b's widths)
PHASE_LAYERS = 4
# the depth of serves 4, 7, 9 and 10 (their checks read routing,
# failover, rank recovery and constraints, none of which needs 36 or 48
# layers); serves 1, 2, 3, 5, 6, 8 and 11 keep the full depth
CUT_LAYERS = 8


def cut_model(name: str, layers: int = CUT_LAYERS) -> str:
    """Register ``name`` at ``layers`` layers, widths unchanged, as the
    engine key ``<name>-l<layers>`` in this process's config table and
    ``stepprofile.ENGINES`` (serve 10's rank processes register it too);
    returns the key."""
    import dataclasses

    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    key = f"{name}-l{layers}"
    if key not in MODEL_CONFIGS:
        MODEL_CONFIGS[key] = dataclasses.replace(MODEL_CONFIGS[name], name=key,
                                                 num_layers=layers)
        if name in ENGINES:
            ENGINES[key] = ENGINES[name]
    return key


def first_layers(params, layers: int) -> dict:
    """The parameter dict cut to its first ``layers`` layers (views)."""
    return {**params, "layers": {k: v[:layers] for k, v in params["layers"].items()}}


def leaf_checksums(torch, params, mesh=None, rank=None) -> dict:
    """name -> (dtype, shape, sum of the leaf's 16/32-bit words, sum of
    each word times its position mod 65521 plus 1): a changed, moved or
    swapped word changes the pair. With a ``mesh``, of rank ``rank``'s
    block of each leaf under the mesh's sharding rules, as the rank holds
    it (its words in row-major order). Computed on the leaf's device
    over slices of the leading axis, 2^26 words at a time."""
    from sutro_tpu_torch.parallel.sharding import leaf_spec, spec_slices

    chunk = 1 << 26
    out = {}
    for name, t in flat_leaves(params):
        path = name.split(".")
        shape = tuple(t.shape)
        sl = ((slice(None),) * len(shape) if mesh is None
              else spec_slices(leaf_spec(path, shape), shape, mesh, rank))
        rows = range(*sl[0].indices(shape[0]))
        step = max(1, chunk // max(1, int(np.prod(shape[1:]))))
        s1 = s2 = pos = 0
        local = shape[1:]
        for lo in range(rows.start, rows.stop, step):
            blk = t[lo: min(lo + step, rows.stop)][(slice(None),) + tuple(sl[1:])].contiguous()
            local = blk.shape[1:]
            words = blk.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
            for a in range(0, words.numel(), chunk):
                w = words[a: a + chunk].to(torch.int64)
                p = torch.arange(pos, pos + w.numel(), device=w.device, dtype=torch.int64)
                s1 += int(w.sum())
                s2 += int((w * (p % 65521 + 1)).sum())
                pos += w.numel()
        out[name] = (str(t.dtype), (len(rows), *local), s1, s2)
    return out


def rank_checksums(runner) -> dict:
    """A rank's own blocks (``ModelRunner.on_ranks``)."""
    import torch

    return leaf_checksums(torch, runner.params)


def rank_launches(runner, zero: bool = False) -> dict:
    """A rank's kernel launch counters (zeroed after the read with
    ``zero``)."""
    out = {k.name: k.launches for k in _port_kernels()}
    if zero:
        for k in _port_kernels():
            k.launches = 0
    return out


_RANK_ROUTES = {}


def install_routes(runner, routes, B: int, T: int) -> None:
    """Replay, on this rank, the expert choices a single device's
    prefill of the same ``[B, T]`` batch recorded (``routes``: one
    ``[B*T, K]`` array a layer), in the order this rank's schedule calls
    the router: every layer over the whole batch (tp, ep), this data
    rank's rows (dp with ep or tp, when dp divides B), this rank's chunk
    of the sequence (sp), or its stage's layers microbatch by microbatch
    (pp). ``remove_routes`` ends it."""
    import torch

    per = [np.asarray(r).reshape(B, T, -1) for r in routes]
    if runner.pp > 1:
        S, s = runner.pp, runner.mesh.coords()["pipe"]
        Lb = len(per) // S
        M = min(runner.ecfg.pp_microbatches or S, B)
        mb = B // M
        order = [per[lay][m * mb:(m + 1) * mb] for m in range(M)
                 for lay in range(s * Lb, (s + 1) * Lb)]
    elif runner.sp > 1:
        from sutro_tpu_torch.ops.ring_attention import seq_chunk

        sl = seq_chunk(runner.mesh, T)
        order = [p[:, sl] for p in per]
    else:
        # the MoE layers route only this data rank's rows when ``data``
        # divides the batch (ops/moe_ep.py), every row otherwise
        dp, order = runner.mesh.shape["data"], per
        if dp > 1 and B % dp == 0 and runner.mesh.shape["expert"] * runner.mesh.shape["model"] > 1:
            d = runner.mesh.coords()["data"]
            order = [p[d * B // dp:(d + 1) * B // dp] for p in per]
    replay = [torch.as_tensor(np.ascontiguousarray(x.reshape(-1, x.shape[-1]))).to(runner.device)
              for x in order]
    flips = []
    ctx = routing(replay=replay, flips=flips)
    ctx.__enter__()
    _RANK_ROUTES["on"] = (ctx, flips)


def remove_routes(runner) -> int:
    """End ``install_routes``; returns the token-layers whose own router
    would have picked other experts."""
    ctx, flips = _RANK_ROUTES.pop("on")
    ctx.__exit__(None, None, None)
    return int(sum(flips))


def _pack_table(rows, room: int, page_size: int, max_pages: int) -> np.ndarray:
    """Each row on its own pages 1.., with ``room`` tokens to spare."""
    from sutro_tpu_torch.engine.kvcache import make_page_table, pages_needed

    pages, nxt = [], 1
    for r in rows:
        n = pages_needed(len(r) + room, page_size)
        pages.append(list(range(nxt, nxt + n)))
        nxt += n
    return make_page_table(pages, max_pages)


def mesh_reference(torch, runner, prompts, results=None, greedy=(), n_rows: int = MESH_ROWS,
                   n_new: int = MESH_NEW, seed: int = 0) -> dict:
    """What serve 11 is held against, taken on serve 2's single-device
    runner: the kernel run's prefill logits of 4 rows with its expert
    choices (``routing``), one decode step of those rows over the pages
    that prefill wrote (``decode_check_inputs``; the full table, with its
    expert choices), the checksums of each tp rank's block of every
    leaf, and the first ``n_new`` tokens of the greedy rows of serve 2's
    job (``results``; without them a greedy batch of ``n_rows`` rows
    runs here)."""
    from sutro_tpu_torch.engine.scheduler import GenRequest
    from sutro_tpu_torch.parallel.mesh import make_mesh

    rows = [np.asarray(p) for p in prompts[:4]]
    table = _pack_table(rows, 0, runner.ecfg.kv_page_size, runner.ecfg.max_pages_per_seq)
    routes = []
    with routing(record=routes):
        logits = runner.prefill_batch(rows, table)
    step = decode_check_inputs(rows, table, logits, runner.ecfg.kv_page_size)
    dec_routes = []
    with torch.no_grad(), routing(record=dec_routes):
        t = [torch.as_tensor(step[k], device=runner.device) for k in ("ids", "past", "table")]
        dec, _, _ = runner._trunk_decode(t[0], t[1][:, None], t[1], t[2])
    t0 = time.monotonic()
    spec = make_mesh(1, 1, MESH_TP, [runner.device] * MESH_TP)
    sums = [leaf_checksums(torch, runner.params, spec, r) for r in range(MESH_TP)]
    sum_s = time.monotonic() - t0
    if results is None:
        greedy = range(n_rows)
        results, _, _, _ = run_batch(
            torch, runner, [GenRequest(row_id=i, prompt_ids=p, max_new_tokens=n_new,
                                       temperature=0.0) for i, p in enumerate(prompts[:n_rows])],
            [], seed, check_row=lambda _r, _x: None)
    tokens = {i: list(results[i].token_ids[:n_new]) for i in greedy if i < n_rows}
    print(f"serve2: serve 11's reference: {len(rows)} rows' logits, {len(routes)} router "
          f"calls, checksums of {MESH_TP} tp blocks in {sum_s:.1f}s, {len(tokens)} greedy rows",
          flush=True)
    return dict(prompts=[np.asarray(p) for p in prompts], rows=rows, table=table,
                logits=logits, routes=[r.cpu().numpy() for r in routes], decode_step=step,
                decode_logits=dec[:, 0].float().cpu().numpy(),
                decode_routes=[r.cpu().numpy() for r in dec_routes],
                B=len(rows), T=max(len(r) for r in rows), checksums=sums, tokens=tokens,
                checksum_s=sum_s)


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def decode_check_inputs(rows, table, logits, page_size: int) -> dict:
    """One decode step after ``rows``' prefill into ``table``: each row's
    greedy next token at its length, and one shared-prefix group over
    the rows' common template (row 0's pages; every row a member, its
    own copy of the template's K/V left unread)."""
    common = min(len(r) for r in rows)
    for i in range(common):
        if any(r[i] != rows[0][i] for r in rows):
            common = i
            break
    n_pfx = common // page_size
    return dict(ids=logits.argmax(-1).astype(np.int32)[:, None],
                past=np.array([len(r) for r in rows], np.int32), table=table,
                pages=np.asarray(table[0, :n_pfx], np.int32),
                pfx_len=np.full(len(rows), n_pfx * page_size, np.int32))


def rank_decode_check(runner, step: dict, routes, want) -> dict:
    """On every rank of serve 11's runner: the decode step of
    ``decode_check_inputs`` over the pages its prefill wrote (the KV
    write at the rank's ``KVH/tp*Dh``) three ways, each with serve 2's
    expert choices (``routes``): split (the prefix carry, then the paged
    decode started from it), over the full table (the paged decode), and
    over the full table through the plain versions (``plain_kernels``).
    Returns each one's logits rel-L2 against serve 2's full-table step
    ``want``."""
    import torch

    dev = runner.device
    ids, past, table, pages, pfx_len = (torch.as_tensor(step[k], device=dev) for k in
                                        ("ids", "past", "table", "pages", "pfx_len"))
    replay = [torch.as_tensor(r).to(dev) for r in routes]
    out = {}
    with torch.no_grad():
        for name, pfx, plain in (("split", ((pages, pfx_len),), False),
                                 ("full_table", None, False), ("plain", None, True)):
            with (plain_kernels(decode=True) if plain else contextlib.nullcontext()), \
                    routing(replay=replay):
                lg, _, _ = runner._trunk_decode(ids, past[:, None], past, table, pfx=pfx)
            out[name] = rel_l2(lg[:, 0].float().cpu().numpy(), want)
    return out


def mesh_phase(torch, name: str, axes: dict, mcfg, devices, rows, seed: int = 0,
               steps: int = 8, odd_rows=None, need=()) -> dict:
    """One short phase of serve 11 on another axis: ``rows`` prefilled
    and one fused window decoded on one device, then on a mesh of
    ``axes`` over ``devices``, each rank replaying the single device's
    expert choices; then, with ``odd_rows``, a prefill of those rows the
    same way. The prefill logits must agree within REL_L2, every rank
    sample the same tokens, and each kernel named in ``need`` launch on
    every rank; the window's tokens against the single device's and its
    collectives are reported."""
    import dataclasses
    import gc

    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.kvcache import pages_needed
    from sutro_tpu_torch.engine.runner import ModelRunner

    PS = 64
    MP = max(pages_needed(len(r) + steps + 1, PS) for r in (*rows, *(odd_rows or ())))
    table = _pack_table(rows, steps + 1, PS, MP)
    ecfg = EngineConfig(kv_page_size=PS, max_pages_per_seq=MP, decode_batch_size=len(rows),
                        max_model_len=MP * PS, decode_multi_step=steps, seed=seed)
    B, T = len(rows), max(len(r) for r in rows)
    single = ModelRunner(mcfg, ecfg, device=devices[0])
    routes = []
    with routing(record=routes):
        want = single.prefill_batch(rows, table)
    args = (want.argmax(-1).astype(np.int32), np.array([len(r) for r in rows], np.int32),
            table, 11, np.zeros(B, np.float32), np.ones(B, np.float32), steps)
    want_toks, _ = single.decode_multi(*args)
    routes = [r.cpu().numpy() for r in routes]
    odd_routes = []
    if odd_rows:
        odd_table = _pack_table(odd_rows, 0, PS, MP)
        with routing(record=odd_routes):
            want_odd = single.prefill_batch(odd_rows, odd_table)
        odd_routes = [r.cpu().numpy() for r in odd_routes]
    del single
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()   # rank 0's peak is this phase's
    t0 = time.monotonic()
    mesh = ModelRunner(mcfg, dataclasses.replace(ecfg, **axes), device=devices)
    build_s = time.monotonic() - t0
    try:
        mesh.on_ranks(rank_launches, True)
        mesh.on_ranks(install_routes, routes, B, T)
        got = mesh.prefill_batch(rows, table)
        flips = sum(mesh.on_ranks(remove_routes))
        before = mesh.mesh_report()
        toks, _ = mesh.decode_multi(*args)
        after = mesh.mesh_report()
        if odd_rows:
            mesh.on_ranks(install_routes, odd_routes, len(odd_rows),
                          max(len(r) for r in odd_rows))
            got_odd = mesh.prefill_batch(odd_rows, odd_table)
            flips += sum(mesh.on_ranks(remove_routes))
        launches = mesh.on_ranks(rank_launches)
        report = mesh.mesh_report()
    finally:
        mesh.close()
    rel = rel_l2(got, want)
    out = dict(axes=axes, rows=B, tokens=T, layers=mcfg.num_layers, build_s=build_s,
               logits_rel_l2=rel, flips=flips,
               window_tokens_equal=float((toks == want_toks).mean()),
               window_collectives=[a["collectives"] - b["collectives"]
                                   for a, b in zip(after, before)],
               window_collective_host_ms=[1e3 * (a["collective_s"] - b["collective_s"])
                                          for a, b in zip(after, before)],
               launches_by_rank=launches, peak_gb=[r["peak_bytes"] / 1e9 for r in report],
               token_mismatches=sum(r["token_mismatches"] for r in report))
    if odd_rows:
        out["odd_rows"] = len(odd_rows)
        out["odd_logits_rel_l2"] = rel_l2(got_odd, want_odd)
    print(f"serve11 {name}: " + json.dumps(out), flush=True)
    if not (np.isfinite(got).all() and rel < REL_L2):
        raise AssertionError(f"serve11 {name}: prefill logits disagree with one device: {rel}")
    if odd_rows and not (np.isfinite(got_odd).all() and out["odd_logits_rel_l2"] < REL_L2):
        raise AssertionError(f"serve11 {name}: the odd batch's prefill logits disagree with "
                             f"one device: {out['odd_logits_rel_l2']}")
    if out["token_mismatches"]:
        raise AssertionError(f"serve11 {name}: the ranks sampled different tokens")
    idle = {k: [r for r, by in enumerate(launches) if not by[k]] for k in need}
    if any(idle.values()):
        raise AssertionError(f"serve11 {name}: kernels not launched on every rank: {idle}")
    return out


def serve_mesh(torch, kernels, card: str, ref: dict, *, model="qwen3-30b-a3b", devices=None,
               geometry=None, n_rows: int = MESH_ROWS, n_new: int = MESH_NEW,
               job_rows: int = 16,
               phase_layers: int = PHASE_LAYERS, sp_tokens: int = 8192, seed: int = 0) -> dict:
    """Serve 11: ``model`` at full width and depth on a tp=2 mesh of two
    rank processes (this process is rank 0; the runner starts rank 1),
    on ``cuda:(r % device_count)``: both ranks share one card over gloo
    (the runner caps each one's allocator at its share of the card), or
    take a card each over NCCL. Held against serve 2 (``ref``,
    ``mesh_reference``):

    - each rank's checksums of its blocks equal serve 2's blocks';
    - the prefill logits of serve 2's 4 check rows, every rank replaying
      serve 2's expert choices, within REL_L2 of serve 2's;
    - one decode step of those rows over the pages that prefill wrote,
      split (the prefix carry), over the full table, and through the
      plain versions, each within REL_L2 of serve 2's (``rank_decode_check``);
    - serve 2's first ``n_rows`` templated rows (``prefix_split``), greedy,
      ``n_new`` tokens: every row returned once at its length, every
      kernel of ``kernels`` launched on every rank, every rank sampling
      the same tokens in every call; the rows token-equal to serve 2's
      are counted, not held;
    - a ``LocalEngine`` job of ``job_rows`` rows with the mesh runner
      resident must end SUCCEEDED;
    - then the ep, sp, pp and dp_ep phases (``mesh_phase``) on
      ``phase_layers`` layers of the same widths: ep=2 (64 experts a
      rank), sp=2 (a ring prefill of ``sp_tokens`` tokens), pp=2 (two
      stages, two microbatches), and dp=2 x ep=2 on four ranks (the
      rows split over ``data`` in the MoE layers, then an odd batch of 3
      rows that replicates its tokens).

    Returns what ``mesh_summary`` prints."""
    from sutro_tpu_torch.engine.stepprofile import ENGINES
    from sutro_tpu_torch.models.configs import MODEL_CONFIGS

    t_start = time.monotonic()
    mcfg = MODEL_CONFIGS[model]
    fields = geometry or ENGINES[model][0]
    if devices is None:
        n = torch.cuda.device_count()
        devices = [f"cuda:{r % n}" for r in range(MESH_TP)]
    return _serve_mesh(torch, kernels, card, ref, mcfg, fields, devices, n_rows, n_new,
                       job_rows, phase_layers, sp_tokens, seed, t_start)


def _serve_mesh(torch, kernels, card, ref, mcfg, fields, devices, n_rows, n_new, job_rows,
                phase_layers, sp_tokens, seed, t_start) -> dict:
    import dataclasses
    import gc

    out = _mesh_job(torch, kernels, card, ref, mcfg, fields, devices, n_rows, n_new, job_rows,
                    seed)
    gc.collect()   # the tp=2 runner's last references went with _mesh_job's frame
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        print(f"serve11: after the tp=2 runner, {torch.cuda.memory_allocated() / 1e9:.3f} GB "
              "still allocated here", flush=True)
    # the other axes, a few layers of the same widths each
    model = mcfg.name
    small = dataclasses.replace(mcfg, name=f"{model}-l{phase_layers}", num_layers=phase_layers)
    rows4 = [np.asarray(p) for p in ref["prompts"][:4]]
    long_row = [np.tile(ref["prompts"][0], -(-sp_tokens // len(ref["prompts"][0])))[:sp_tokens]]
    if str(devices[0]).startswith("cuda"):
        n = torch.cuda.device_count()
        devices4 = [f"cuda:{r % n}" for r in range(4)]
    else:
        devices4 = [devices[0]] * 4
    need = ("grouped_matmul", "flash_prefill", "paged_decode", "kv_write")
    out["phases"] = {
        "ep": mesh_phase(torch, "ep", {"ep": 2}, small, devices, rows4, seed),
        "sp": mesh_phase(torch, "sp", {"sp": 2}, small, devices, long_row, seed),
        "pp": mesh_phase(torch, "pp", {"pp": 2, "pp_microbatches": 2}, small, devices, rows4,
                         seed),
        "dp_ep": mesh_phase(torch, "dp_ep", {"dp": 2, "ep": 2, "tp": 1}, small, devices4,
                            rows4, seed, odd_rows=rows4[:3],
                            need=need if torch.cuda.is_available() else ()),
    }
    out["serve_s"] = time.monotonic() - t_start
    print("serve11: " + json.dumps({k: v for k, v in out.items() if k != "phases"}), flush=True)
    return out


def _mesh_job(torch, kernels, card, ref, mcfg, fields, devices, n_rows, n_new, job_rows,
              seed) -> dict:
    """Serve 11's tp=2 runner: its checks, the job and the LocalEngine
    job (``serve_mesh``); the runner is stopped on return."""
    from sutro_tpu_torch.engine.api import LocalEngine, resolve_model
    from sutro_tpu_torch.engine.config import EngineConfig
    from sutro_tpu_torch.engine.runner import ModelRunner
    from sutro_tpu_torch.engine.scheduler import GenRequest
    from sutro_tpu_torch.engine.tokenizer import ByteTokenizer

    model = mcfg.name
    ecfg = EngineConfig(**fields, seed=seed, tp=MESH_TP)
    if torch.cuda.is_available():   # rank 0's peak is this serve's alone
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    runner = ModelRunner(mcfg, ecfg, device=devices)
    build_s = time.monotonic() - t0
    out = dict(card=card, model=model, devices=[str(d) for d in devices],
               backend=runner.mesh.backend, build_s=build_s)
    try:
        ready = runner.mesh_report()
        out["ready_s"] = [r["ready_s"] for r in ready]
        print(f"serve11: {model} L={mcfg.num_layers} on tp={MESH_TP} over {out['devices']} "
              f"({out['backend']}), ranks ready {out['ready_s']} s, built in {build_s:.1f}s",
              flush=True)
        # every rank's blocks are bit for bit serve 2's
        got_sums = runner.on_ranks(rank_checksums)
        for r, (got, want) in enumerate(zip(got_sums, ref["checksums"])):
            bad = sorted(k for k in want if got.get(k) != want[k])
            if bad or set(got) != set(want):
                raise AssertionError(f"serve11: rank {r}'s blocks differ from serve 2's: {bad}")
        out["checksummed_leaves"] = len(ref["checksums"][0])
        # prefill logits with serve 2's expert choices on every rank
        runner.on_ranks(install_routes, ref["routes"], ref["B"], ref["T"])
        logits = runner.prefill_batch(ref["rows"], ref["table"])
        out["flips"] = sum(runner.on_ranks(remove_routes))
        rel = out["logits_rel_l2"] = rel_l2(logits, ref["logits"])
        print(f"serve11: prefill logits vs serve 2's (its routing on both ranks): "
              f"rel_l2={rel:.3e} argmax_agree="
              f"{int((logits.argmax(-1) == ref['logits'].argmax(-1)).sum())}/{ref['B']}",
              flush=True)
        if not (np.isfinite(logits).all() and rel < REL_L2):
            raise AssertionError(f"serve11: prefill logits disagree with serve 2's: {rel}")
        # a decode step over the pages the mesh's KV write filled
        dec = runner.on_ranks(rank_decode_check, ref["decode_step"], ref["decode_routes"],
                              ref["decode_logits"])
        out["decode_rel_l2"] = dec
        print(f"serve11: decode step vs serve 2's over the pages just written, by rank: "
              f"{json.dumps(dec)}", flush=True)
        if not all(np.isfinite(v) and v < REL_L2 for r in dec for v in r.values()):
            raise AssertionError(f"serve11: decode logits disagree with serve 2's: {dec}")

        # serve 2's templated rows, greedy
        prompts = ref["prompts"][:n_rows]
        reqs = [GenRequest(row_id=i, prompt_ids=p, max_new_tokens=n_new, temperature=0.0)
                for i, p in enumerate(prompts)]

        def full(_runner, r):
            if r.error or r.finish_reason != "length" or len(r.token_ids) != n_new:
                raise AssertionError(f"serve11: row {r.row_id}: {r.finish_reason!r} "
                                     f"{len(r.token_ids)} tokens {r.error!r}")

        runner.on_ranks(rank_launches, True)
        before = runner.mesh_report()
        calls = {}
        count_decode_calls(runner, calls)
        results, launches, batcher, wall = run_batch(torch, runner, reqs, kernels, seed,
                                                     check_row=full)
        for name in DECODE_ENTRIES:   # the counting wrappers go
            delattr(runner, name)
        if sorted(results) != list(range(n_rows)):
            raise AssertionError("serve11: rows missing or returned twice")
        if calls["decode_multi_async_with_groups"] <= 0:
            raise AssertionError(f"serve11: no fused window ran with the prefix group: {calls}")
        by_rank = runner.on_ranks(rank_launches)
        for k in kernels:
            idle = [r for r, c in enumerate(by_rank) if c[k.name] <= 0]
            if idle:
                raise AssertionError(f"serve11: kernel {k.name} not launched on ranks {idle}")
        after = runner.mesh_report()
        if any(r["token_mismatches"] for r in after) or not all(
                r["token_checks"] > b["token_checks"] for r, b in zip(after, before)):
            raise AssertionError(f"serve11: the ranks' sampled tokens differ: {after}")
        n_gen = sum(len(r.token_ids) for r in results.values())
        equal = [i for i, toks in ref["tokens"].items() if results[i].token_ids == toks]
        timer = batcher.timer.summary()
        out.update(
            rows=n_rows, generated_tokens=n_gen, wall_s=wall,
            decode_tok_s=n_gen / decode_seconds(timer), decode_calls=calls,
            launches={name: sum(c[name] for c in by_rank) for name in by_rank[0]},
            launches_by_rank=by_rank,
            token_equal_to_serve2=f"{len(equal)}/{len(ref['tokens'])}",
            token_checks=[r["token_checks"] for r in after],
        )
        # one fused window alone: the collectives it issues and their host time
        B = 8
        table = np.zeros((B, ecfg.max_pages_per_seq), np.int32)
        table[:, 0] = np.arange(1, B + 1)
        w_args = (np.ones(B, np.int32), np.full(B, 5, np.int32), table, 3,
                  np.zeros(B, np.float32), np.ones(B, np.float32), ecfg.decode_multi_step)
        runner.decode_multi(*w_args)
        a = runner.mesh_report()
        t0 = time.monotonic()
        runner.decode_multi(*w_args)
        w_s = time.monotonic() - t0
        b = runner.mesh_report()
        out["window"] = dict(
            steps=ecfg.decode_multi_step, rows=B, wall_ms=1e3 * w_s,
            collectives=[y["collectives"] - x["collectives"] for x, y in zip(a, b)],
            collective_host_ms=[1e3 * (y["collective_s"] - x["collective_s"])
                                for x, y in zip(a, b)])

        # the job API on the mesh: a LocalEngine with this runner resident
        key, _, _ = resolve_model("qwen-3-30b-a3b" if model == "qwen3-30b-a3b" else model)
        tok = ByteTokenizer(vocab_size=mcfg.vocab_size)
        eng = LocalEngine(ecfg, device=devices)
        try:
            eng._tok_cache[key] = tok
            eng._runner_cache[key] = (runner, tok)
            rng = np.random.default_rng(seed + 11)
            rows = ["".join(rng.choice(ALPHABET, int(n))) for n in rng.integers(16, 200, job_rows)]
            t0 = time.monotonic()
            jid = eng.submit_batch_inference({
                "model": key, "inputs": rows,
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 16}})
            while eng.job_status(jid) not in ("SUCCEEDED", "FAILED", "CANCELLED"):
                if time.monotonic() - t0 > 600:
                    raise AssertionError(f"serve11: job {jid} stuck in {eng.job_status(jid)}")
                time.sleep(0.05)
            job_s = time.monotonic() - t0
            status = eng.job_status(jid)
            if status != "SUCCEEDED":
                raise AssertionError(f"serve11: the LocalEngine job ended {status}: "
                                     f"{eng.get_job(jid)}")
            res = eng.job_results(jid)
            if len(res["outputs"]) != job_rows:
                raise AssertionError(f"serve11: the job returned {len(res['outputs'])} rows")
            gen = int(sum(res.get("gen_tokens") or [16 * job_rows]))
            out["job"] = dict(id=jid, status=status, rows=job_rows, wall_s=job_s,
                              tok_s=gen / job_s)
        finally:
            eng._runner_cache.clear()
            eng.close(timeout=60)
        peak = runner.mesh_report()
        out["peak_gb"] = [r["peak_bytes"] / 1e9 for r in peak]
        print(f"serve11: job of {n_rows} rows x {n_new} tokens in {out['wall_s']:.1f}s "
              f"({out['decode_tok_s']:.1f} decode tok/s over both ranks), "
              f"{out['token_equal_to_serve2']} token-equal to serve 2, window "
              f"{out['window']}, LocalEngine job {out['job']}, peak GB {out['peak_gb']}",
              flush=True)
    finally:
        runner.close()
    return out


def mesh_summary(out: dict) -> dict:
    return dict(
        backend=out["backend"], devices=out["devices"], ready_s=out["ready_s"],
        peak_gb=out["peak_gb"], job_tok_s=out["job"]["tok_s"],
        decode_tok_s=out["decode_tok_s"],
        window_collectives=out["window"]["collectives"],
        window_collective_host_ms=out["window"]["collective_host_ms"],
        logits_rel_l2=out["logits_rel_l2"], flips=out["flips"],
        decode_rel_l2=out["decode_rel_l2"][0],
        token_equal_to_serve2=out["token_equal_to_serve2"],
        phases_rel_l2={k: v["logits_rel_l2"] for k, v in out["phases"].items()},
        phases_flips={k: v["flips"] for k, v in out["phases"].items()},
        dp_ep_odd_rel_l2=out["phases"]["dp_ep"]["odd_logits_rel_l2"],
        serve_s=out["serve_s"],
    )


def nccl_shared_card_probe(timeout: float = 120.0) -> str:
    """What NCCL says when two ranks share one card (``--nccl-probe``):
    two processes build a 2-rank mesh on ``cuda:0`` with the backend
    forced to NCCL; each rank's outcome is returned."""
    import multiprocessing
    import tempfile

    d = tempfile.mkdtemp(prefix="sutro-nccl-probe-")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_nccl_probe_rank, args=(r, d), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    lines = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join(5)
            lines.append(f"rank {r}: still waiting after {timeout:.0f}s (killed)")
        else:
            f = Path(d) / f"rank{r}.txt"
            lines.append(f"rank {r}: " + (f.read_text() if f.exists() else f"exit {p.exitcode}"))
    return " | ".join(lines)


def _nccl_probe_rank(rank: int, d: str) -> None:
    import torch

    from sutro_tpu_torch.parallel.mesh import file_store, make_mesh

    try:
        mesh = make_mesh(1, 1, 2, ["cuda:0", "cuda:0"])
        mesh.backend = "nccl"
        mesh.connect(file_store(str(Path(d) / "store"), 2), rank, timeout=60)
        x = torch.ones(1, device="cuda:0")
        mesh.world.all_reduce(x)
        torch.cuda.synchronize()
        msg = f"NCCL all-reduce ran: {x.item()}"
    except Exception as e:  # the probe reports what NCCL raised
        msg = f"{type(e).__name__}: {' '.join(str(e).split())[:600]}"
    (Path(d) / f"rank{rank}.txt").write_text(msg)


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


def pair_timing(torch, dev) -> dict:
    """The two kernels redesigned last, timed through their wrappers
    alone (``carry_timings``, ``gmm_timings`` without the plain loop), so
    that the same code times a parent tree's package (``--package``)."""
    from sutro_tpu_torch.ops import cuda_build, grouped_matmul, prefix_carry

    cuda_build.build([prefix_carry.KERNEL, grouped_matmul.KERNEL])
    rng = np.random.default_rng(4321)
    return {"prefix_carry": carry_timings(rng, torch, dev, prefix_carry),
            "grouped_matmul": gmm_timings(rng, torch, dev, grouped_matmul, with_plain=False)}


def main() -> int:
    args = sys.argv[1:]
    if "--package" in args:   # time another tree's sutro_tpu_torch (--pair-timing)
        sys.path.insert(0, str(Path(args[args.index("--package") + 1]).resolve()))
    if "--dp-rank" in args:   # one rank process of serve 10, started by serve 10
        return dp_rank(args)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import os
    import shutil
    import tempfile

    # the engine's state (jobs, engine.json, the checkpoint) lives in a
    # temporary SUTRO_HOME, removed at exit: nothing goes to ~/.sutro
    home = Path(tempfile.mkdtemp(prefix="sutro-smoke-home-"))
    os.environ["SUTRO_HOME"] = str(home)
    try:
        return run(torch, args, home)
    finally:
        shutil.rmtree(home, ignore_errors=True)


def run(torch, args, home: Path) -> int:
    import shutil

    import sutro_tpu_torch

    from sutro_tpu_torch.engine.runner import set_matmul_precision
    from sutro_tpu_torch.ops import (
        cuda_build, flash_prefill, grouped_matmul, kv_write, paged_decode, prefix_carry,
    )

    set_matmul_precision()
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    if "--pair-timing" in args:
        package = str(Path(sutro_tpu_torch.__file__).resolve().parent)
        print(json.dumps({"pair_timing": pair_timing(torch, dev), "package": package,
                          "card": card}), flush=True)
        return 0
    dense_path = [paged_decode.KERNEL, kv_write.KERNEL, flash_prefill.KERNEL]
    templated_path = [grouped_matmul.KERNEL, prefix_carry.KERNEL,
                      paged_decode.CARRY, kv_write.KERNEL, flash_prefill.KERNEL]
    # serve 4's n-gram phase: no template, so the plain paged decode
    ngram_path = [grouped_matmul.KERNEL, paged_decode.KERNEL, kv_write.KERNEL,
                  flash_prefill.KERNEL]
    int8_path = [paged_decode.INT8, flash_prefill.KERNEL]
    # serve 5: a classify job (a system prompt of > 1 page: prefix
    # groups) with plain jobs attached, on the dense model
    facade_path = [paged_decode.KERNEL, paged_decode.CARRY, prefix_carry.KERNEL,
                   kv_write.KERNEL, flash_prefill.KERNEL]
    facade_absent = [grouped_matmul.KERNEL, paged_decode.INT8]
    # serve 6: embedding jobs run flash prefill alone
    embed_path = [flash_prefill.KERNEL]
    embed_absent = [paged_decode.KERNEL, paged_decode.CARRY, paged_decode.INT8,
                    kv_write.KERNEL, prefix_carry.KERNEL, grouped_matmul.KERNEL]
    # no silent bf16 route under an int8 pool
    int8_absent = [paged_decode.KERNEL, paged_decode.CARRY, kv_write.KERNEL]
    # serve 8: stage graphs on gpt-oss-20b run every bf16 kernel (its
    # prefix groups the carry, rows outside them the plain decode)
    graph_path = [flash_prefill.KERNEL, paged_decode.KERNEL, paged_decode.CARRY,
                  prefix_carry.KERNEL, kv_write.KERNEL, grouped_matmul.KERNEL]
    graph_absent = [paged_decode.INT8]

    t0 = time.monotonic()
    logs = cuda_build.build(dense_path + templated_path + int8_path)
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:   # the mangled name, as SASS lists it
                fn = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"build[{name}]: {fn}: {line.strip()}", flush=True)
    print(f"build: {len(logs)} sources compiled in {time.monotonic() - t0:.1f}s", flush=True)
    # the four redesigned kernels: tensor-core, cp.async and TMA instructions
    for k in (flash_prefill.KERNEL, paged_decode.KERNEL, prefix_carry.KERNEL,
              grouped_matmul.KERNEL):
        for fn, n in cuda_build.sass_counts(k).items():
            print(f"sass[{k.source.name}]: {fn}: HMMA/HGMMA={n['mma']} LDGSTS={n['cp_async']} "
                  f"UTMALDG={n['tma']}", flush=True)

    cut8b = cut_model("qwen3-8b")
    if "--serve9-only" in args:   # the build, then serve 9 on its own checkpoint
        s9 = serve_fleet(torch, facade_path, facade_absent, card,
                         fleet_checkpoint(torch, home, cut8b), model=cut8b)
        print("serve9 summary: " + json.dumps(fleet_summary(s9)))
        print(f"card: {card}")
        return 0
    if "--serve10-only" in args:   # the build, then serve 10 on its own checkpoint
        s10 = serve_dp(torch, facade_path, facade_absent, card,
                       fleet_checkpoint(torch, home, cut8b), model=cut8b)
        print("serve10 summary: " + json.dumps(dp_summary(s10)))
        print(f"card: {card}")
        return 0
    if "--nccl-probe" in args:    # what NCCL says of two ranks on one card
        print(f"nccl probe: {nccl_shared_card_probe()}", flush=True)
    if "--serve11-only" in args:  # the build, the shard shapes, then serve 11
        check_shard_shapes(np.random.default_rng(1311), torch, dev)
        s11 = serve_mesh(torch, templated_path, card, serve11_reference(torch, dev))
        print("serve11 summary: " + json.dumps(mesh_summary(s11)))
        print(f"card: {card}")
        return 0

    records = []
    rng = np.random.default_rng(1234)
    for fn in (kernel_paged_decode, kernel_kv_write, kernel_flash_prefill,
               kernel_prefix_split, kernel_grouped_matmul, kernel_paged_decode_int8,
               kernel_gpt_oss):
        recs = fn(rng, torch, dev)
        torch.cuda.empty_cache()
        for rec in recs if isinstance(recs, list) else [recs]:
            lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            extra = {k: rec[k] for k in ("library", "split_pair_ms", "full_table_ms",
                                         "timed_cases", "split_sweep") if k in rec}
            print(f"kernel[{rec['name']}]: ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"library_ms={lib} bound_ms={rec['bound_ms']:.4f} "
                  f"({rec['bound_by']}) max_abs_err={rec['max_abs_err']:.3e} "
                  f"cases={json.dumps(rec['cases'])} {json.dumps(extra)}", flush=True)
            records.append(rec)
    check_shard_shapes(rng, torch, dev)
    if "--kernels-only" in args:
        print(f"card: {card}")
        return 0
    if "--serve8-only" in args:   # the kernel phase, then serve 8 alone
        s8 = serve_graphs(torch, graph_path, graph_absent, card)
        print("serve8 summary: " + json.dumps(graphs_summary(s8)))
        print(f"card: {card}")
        return 0

    s1, runner = serve(torch, dense_path, dev)
    served = {"qwen3-8b": s1}
    print(f"serve: card={card} prefill_tok_s={s1['prefill_tok_s']:.1f} "
          f"decode_tok_s={s1['decode_tok_s']:.1f} wall_s={s1['wall_s']:.2f}", flush=True)
    # serve 5 writes serve 1's parameters as a checkpoint, frees serve
    # 1's runner and loads them back through the engine
    runners = [runner]
    del runner
    served["qwen3-8b façade"] = serve_facade(torch, runners, facade_path, facade_absent,
                                             card, home)
    free_card(torch, "qwen3-8b")
    # serve 7: online serving over HTTP on the checkpoint serve 5 wrote
    # serves 7, 9 and 10 load its first CUT_LAYERS layers (cut8b)
    ckpt = Path(served["qwen3-8b façade"]["checkpoint"]["dir"])
    try:
        served["qwen3-8b serving"] = serve_online(torch, facade_path, facade_absent, card, ckpt,
                                                  model=cut8b)
        free_card(torch, "qwen3-8b")
        # serve 9: the replica fleet, two replicas of the same checkpoint
        served["qwen3-8b fleet"] = serve_fleet(torch, facade_path, facade_absent, card, ckpt,
                                               model=cut8b)
        free_card(torch, "qwen3-8b")
        # serve 10: two data-parallel rank processes of the same checkpoint
        served["qwen3-8b dp"] = serve_dp(torch, facade_path, facade_absent, card, ckpt,
                                         model=cut8b)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    free_card(torch, "qwen3-8b")
    # serve 8: stage graphs, the control plane and the monitor on
    # gpt-oss-20b (41.8 GB of weights and a 6.4 GB pool)
    served["gpt-oss-20b graphs"] = serve_graphs(torch, graph_path, graph_absent, card)
    free_card(torch, "gpt-oss-20b")
    # serve 6: embedding jobs through the façade, one from a dataset
    served["qwen3-emb-0.6b"] = serve_embed(torch, embed_path, embed_absent, card, home)
    # serve 2 needs the card to itself: 61 GB of weights and a 9.7 GB pool
    free_card(torch, EMBED_MODEL)
    s2, runner, ref = serve_templated(torch, templated_path, dev)
    served["qwen3-30b-a3b"] = s2
    print(f"serve2: card={card} prefill_tok_s={s2['prefill_tok_s']:.1f} "
          f"decode_tok_s={s2['decode_tok_s']:.1f} wall_s={s2['wall_s']:.2f}", flush=True)
    del runner
    free_card(torch, "qwen3-30b-a3b")
    # serve 4 at CUT_LAYERS layers of the same widths
    runner = templated_runner(torch, cut_model("qwen3-30b-a3b"), dev)
    s4 = serve_constrained(torch, runner, templated_path, ngram_path, card)
    served["qwen3-30b-a3b constrained"] = s4
    served["qwen3-30b-a3b n-gram"] = s4["ngram"]
    del runner
    free_card(torch, "qwen3-30b-a3b")
    # serve 11: qwen3-30b-a3b on a tp=2 mesh of two rank processes
    served["qwen3-30b-a3b tp=2"] = serve_mesh(torch, templated_path, card, ref)
    del ref
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
    print("serve7 summary: " + json.dumps(online_summary(served["qwen3-8b serving"])))
    print("serve8 summary: " + json.dumps(graphs_summary(served["gpt-oss-20b graphs"])))
    print("serve9 summary: " + json.dumps(fleet_summary(served["qwen3-8b fleet"])))
    print("serve10 summary: " + json.dumps(dp_summary(served["qwen3-8b dp"])))
    print("serve11 summary: " + json.dumps(mesh_summary(served["qwen3-30b-a3b tp=2"])))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
