"""Job bottleneck doctor: name WHY a job was slow, with evidence.

A copy of ``sutro_tpu/telemetry/doctor.py`` that also reads the
port's device seconds from CUDA events (``device_s``).

Input is the merged per-job telemetry document (``telemetry.job_doc``
— local flight-recorder timeline plus, for dp coordinator jobs, the
ingested per-worker sections from telemetry/distributed.py). Output is
a deterministic diagnosis document (golden-pinned by
tests/test_doctor.py):

- **per-process stage attribution** — wall time split across engine
  stages for the coordinator ("rank0") and every worker rank that
  shipped telemetry;
- **roofline grades** — decode windows carry ``batch``/``steps``/
  ``avg_ctx`` attrs (scheduler) and the job's attrs carry the runner's
  device info, so each window's attempted token rate grades against
  the chip's HBM roofline (engine/roofline.py) and prefill spans grade
  as MFU, over the call's ``device_s`` (CUDA events) where the span
  has one, else over its duration;
- **one named verdict** from a fixed taxonomy, most-specific first:

  ========================  ============================================
  verdict                   meaning
  ========================  ============================================
  ``insufficient_data``     no spans anywhere (telemetry off / evicted)
  ``warming_up``            in-flight job, no spans landed yet — a
                            partial-data marker, not a failure
  ``straggler_worker``      one rank's wall >= 1.5x the median of the
                            others — the pod waits on that slice
  ``io_bound``              flush+finalize dominate both compute and
                            the rest of the host pipeline
  ``host_bound_admit``      host-side admission work (tokenize,
                            constraint compile, accept) exceeds device
                            time — the chip starves behind the host
  ``decode_below_roofline``  device-bound but the median decode window
                            runs under 40% of the HBM roofline
  ``healthy``               none of the above
  ========================  ============================================

Partial data degrades, never fails: a dp world with silent ranks (old
workers, telemetry disabled there) is diagnosed from what arrived and
flagged ``partial`` with the missing ranks named in the evidence.

Pure analysis on purpose — no engine imports beyond the dependency-free
roofline table — so the doctor runs identically on a live engine, a
persisted ``telemetry.json``, or a synthetic document in tests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..engine import roofline

DOCTOR_VERSION = 1

#: stages whose duration is device dispatch/fetch (the chip working),
#: where a span carries no ``device_s`` (CUDA events) of its own
DEVICE_STAGES = ("prefill", "decode_window", "admit", "embed")
#: the host waiting on the chip (a pipelined window's fetch): neither
#: device work nor host work
WAIT_STAGES = ("decode_fetch",)
#: host-side pipeline stages (the chip idle or overlapped)
HOST_STAGES = ("tokenize", "constraint_compile", "accept", "flush",
               "finalize", "kv_demote", "kv_promote")
#: I/O subset of the host stages (jobstore writes)
IO_STAGES = ("flush", "finalize")
#: round envelopes — excluded from attribution (they CONTAIN stages)
ENVELOPE_STAGES = ("dp_round",)

#: the verdict taxonomy, in priority order (OBSERVABILITY.md "Doctor")
VERDICTS = (
    "insufficient_data",
    "warming_up",
    "interactive_starved",
    "stage_starved",
    "straggler_worker",
    "io_bound",
    "host_bound_admit",
    "kv_pressure",
    "resume_bound",
    "decode_below_roofline",
    "healthy",
)

#: gateway TTFT threshold mirrored here for the evidence line
#: (serving/gateway.py STARVED_TTFT_S stamps attrs["interactive"])
INTERACTIVE_STARVED_TTFT_S = 5.0

#: a stage-graph stage that spent more than this fraction of the job's
#: wall waiting for its FIRST upstream row is starved (the streaming
#: handoff degenerated into a barrier — engine/stagegraph.py stamps
#: attrs["stages"][name]["starved_s"])
STAGE_STARVED_FRAC = 0.5

#: a decode window under this fraction of the HBM roofline is "below"
ROOFLINE_OK_PCT = 40.0
#: a rank this much slower than the median of the others is a straggler
STRAGGLER_RATIO = 1.5


def _attribution(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wall/stage attribution for ONE process's span list (its own
    timeline — offsets are process-relative, so no cross-host clock
    enters here)."""
    stages: Dict[str, Dict[str, float]] = {}
    t_lo, t_hi = float("inf"), float("-inf")
    worked = 0
    for s in spans:
        name = s.get("name")
        if name in ENVELOPE_STAGES:
            # envelopes CONTAIN stages — and the coordinator's
            # dp_round spans the whole pod round including its wait on
            # workers, so counting it toward wall would make rank0
            # "slowest" by construction
            continue
        dur = float(s.get("dur_s", 0.0))
        t0 = float(s.get("t0_s", 0.0))
        t_lo = min(t_lo, t0)
        t_hi = max(t_hi, t0 + dur)
        worked += 1
        e = stages.setdefault(name, {"count": 0, "total_s": 0.0})
        e["count"] += 1
        e["total_s"] += dur
    for e in stages.values():
        e["total_s"] = round(e["total_s"], 6)
    wall = max(t_hi - t_lo, 0.0) if worked else 0.0

    def _sum(names: Tuple[str, ...]) -> float:
        return round(
            sum(stages.get(n, {}).get("total_s", 0.0) for n in names), 6
        )

    # a document without CUDA events (old dumps, the CPU) keeps the
    # device stages' totals
    device_s = _sum(DEVICE_STAGES)
    if any("device_s" in (s.get("attrs") or {}) for s in spans):
        device_s = round(sum(_device_seconds(spans)), 6)
    out = {
        "spans": len(spans),
        "wall_s": round(wall, 6),
        "device_s": device_s,
        "host_s": _sum(HOST_STAGES),
        "io_s": _sum(IO_STAGES),
        "stages": {k: stages[k] for k in sorted(stages)},
    }
    if any(n in stages for n in WAIT_STAGES):
        out["wait_s"] = _sum(WAIT_STAGES)
    return out


def _device_seconds(spans: List[Dict[str, Any]]) -> List[float]:
    """Each span's device seconds: its ``device_s`` where it has one,
    else a device stage's duration."""
    out = []
    for s in spans:
        a = s.get("attrs") or {}
        if "device_s" in a:
            out.append(float(a["device_s"]))
        elif s.get("name") in DEVICE_STAGES:
            out.append(float(s.get("dur_s", 0.0)))
    return out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2.0


def _grade_roofline(
    spans: List[Dict[str, Any]],
    device: Optional[Dict[str, Any]],
    counters: Dict[str, Any],
) -> Optional[Dict[str, Any]]:
    """Grade one process's device windows against its chip roofline.
    None when the process shipped no device info; a ``reason`` entry
    when the device kind has no public spec (CPU, emulators) — grades
    are omitted, never fabricated (engine/roofline.py contract)."""
    if not isinstance(device, dict):
        return None
    kind = str(device.get("device_kind") or "")
    if roofline.hw_specs(kind) is None:
        return {"device_kind": kind, "graded_windows": 0,
                "reason": f"no roofline spec for device kind {kind!r}"}
    n_dev = max(int(device.get("n_devices", 1)), 1)
    # fallback context depth when a window lacks avg_ctx: prompt plus
    # half the generated tail, from the job's exact counters
    rows = float(
        counters.get("rows_ok", 0)
        + counters.get("rows_quarantined", 0)
        + counters.get("rows_cancelled", 0)
    )
    ctx_fallback = None
    if rows > 0:
        ctx_fallback = (
            float(counters.get("input_tokens", 0))
            + float(counters.get("output_tokens", 0)) / 2.0
        ) / rows
    decode_pcts: List[float] = []
    mfus: List[float] = []
    for s in spans:
        attrs = s.get("attrs") or {}
        # device seconds where CUDA events measured them, else the
        # span's host duration
        dur = float(attrs.get("device_s", s.get("dur_s", 0.0)))
        if dur <= 0:
            continue
        if s.get("name") == "decode_window" and attrs.get("batch"):
            batch = int(attrs["batch"])
            steps = int(attrs.get("steps", 1))
            avg_ctx = attrs.get("avg_ctx", ctx_fallback)
            if avg_ctx is None:
                continue
            bps = roofline.decode_bytes_per_step(
                param_bytes=int(device.get("param_bytes", 0)),
                batch=batch,
                avg_ctx=float(avg_ctx),
                num_layers=int(device.get("num_layers", 0)),
                kv_heads=int(device.get("kv_heads", 0)),
                head_dim=int(device.get("head_dim", 0)),
                kv_dtype_bytes=int(device.get("kv_dtype_bytes", 2)),
            )
            g = roofline.grade_decode(
                batch * steps / dur / n_dev,
                batch=batch,
                bytes_per_step=bps,
                device_kind=kind,
            )
            if g.get("pct_hbm_roofline") is not None:
                decode_pcts.append(float(g["pct_hbm_roofline"]))
        elif s.get("name") == "prefill" and attrs.get("tokens"):
            g = roofline.grade_prefill(
                float(attrs["tokens"]) / dur / n_dev,
                n_params=int(device.get("n_params", 0)),
                device_kind=kind,
            )
            if g.get("mfu_prefill") is not None:
                mfus.append(float(g["mfu_prefill"]))
    out: Dict[str, Any] = {
        "device_kind": kind,
        "graded_windows": len(decode_pcts),
    }
    if decode_pcts:
        out["decode_pct_hbm_median"] = round(_median(decode_pcts), 1)
        out["decode_pct_hbm_best"] = round(max(decode_pcts), 1)
    if mfus:
        out["mfu_prefill_median"] = round(_median(mfus), 1)
    return out


#: statuses past which a job can no longer gain spans
_TERMINAL_STATUSES = ("SUCCEEDED", "FAILED", "CANCELLED")

# -- per-request verdicts (forensics traces, telemetry/traces.py) ------

#: the per-request taxonomy, in priority order
REQUEST_VERDICTS = (
    "insufficient_data",
    "queue_wait_bound",
    "preemption_bound",
    "stream_flush_bound",
    "healthy",
)

#: a leg must cover at least this fraction of the request wall to be
#: "bound" by it (queue wait uses the stricter QUEUE_BOUND_FRACTION)
REQUEST_BOUND_FRACTION = 0.25
QUEUE_BOUND_FRACTION = 0.4

#: stages that are the request actually computing (device + host work)
_REQUEST_COMPUTE = ("prefill", "decode_window", "decode_fetch", "admit",
                    "accept")


def diagnose_request(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Grade ONE request's trace document (telemetry/traces.py) into a
    per-request verdict: where did THIS request's wall time go —
    admission queue, preemption stalls, stream flush, or honest
    compute. Pure analysis, same contract as :func:`diagnose`: runs
    identically on a live trace, a served ``GET /trace/{id}``'s source
    document, or a synthetic one in tests."""
    spans = list(doc.get("spans") or ())
    trace_id = doc.get("trace_id")
    out: Dict[str, Any] = {
        "version": DOCTOR_VERSION,
        "trace_id": trace_id,
        "kind": doc.get("kind"),
        "outcome": doc.get("outcome"),
    }
    if not spans:
        out["verdict"] = "insufficient_data"
        out["evidence"] = [
            "no spans in this trace (telemetry disabled mid-request, "
            "or the trace ring evicted it)"
        ]
        out["legs"] = {}
        return out

    t_lo = min(float(s["t0_s"]) for s in spans)
    t_hi = max(float(s["t0_s"]) + float(s["dur_s"]) for s in spans)
    wall = max(t_hi - t_lo, 1e-9)

    def _leg(*names: str) -> float:
        return sum(
            float(s["dur_s"]) for s in spans if s["name"] in names
        )

    queue_s = _leg("queue_wait")
    compute_s = _leg(*_REQUEST_COMPUTE)
    flush_s = _leg("stream_flush")
    # suspend -> resume stall per preempted row: pair each
    # preempt_suspend with the NEXT resume carrying the same row_id
    suspends: Dict[int, float] = {}
    preempt_stall_s = 0.0
    n_preempt = 0
    for s in spans:
        a = s.get("attrs") or {}
        if s["name"] == "preempt_suspend":
            n_preempt += 1
            rid = a.get("row_id")
            if rid is not None and rid not in suspends:
                suspends[int(rid)] = float(s["t0_s"])
        elif s["name"] == "resume":
            rid = a.get("row_id")
            t0 = suspends.pop(int(rid), None) if rid is not None else None
            if t0 is not None:
                preempt_stall_s += max(float(s["t0_s"]) - t0, 0.0)
    # a suspend never resumed stalls through the end of the trace
    for t0 in suspends.values():
        preempt_stall_s += max(t_hi - t0, 0.0)

    legs = {
        "wall_s": round(wall, 6),
        "queue_s": round(queue_s, 6),
        "compute_s": round(compute_s, 6),
        "flush_s": round(flush_s, 6),
        "preempt_stall_s": round(preempt_stall_s, 6),
        "preemptions": n_preempt,
    }
    evidence: List[str] = []
    verdict: Optional[str] = None
    if queue_s > compute_s and queue_s >= QUEUE_BOUND_FRACTION * wall:
        verdict = "queue_wait_bound"
        evidence.append(
            f"admission queue wait {queue_s:.3f}s covers "
            f"{100.0 * queue_s / wall:.0f}% of the request wall "
            f"{wall:.3f}s and exceeds compute {compute_s:.3f}s: the "
            "request waited for a session slot, not for the chip"
        )
    elif (
        n_preempt
        and preempt_stall_s > max(queue_s, flush_s)
        and preempt_stall_s >= REQUEST_BOUND_FRACTION * wall
    ):
        verdict = "preemption_bound"
        evidence.append(
            f"{n_preempt} preemption(s) stalled this request "
            f"{preempt_stall_s:.3f}s of its {wall:.3f}s wall "
            "(suspended rows re-admitted row-granularly and "
            "regenerated): lower co-tenant priority pressure or raise "
            "interactive_slots headroom"
        )
    elif flush_s > compute_s and flush_s >= REQUEST_BOUND_FRACTION * wall:
        verdict = "stream_flush_bound"
        evidence.append(
            f"SSE flush {flush_s:.3f}s exceeds compute {compute_s:.3f}s "
            f"({100.0 * flush_s / wall:.0f}% of wall): the consumer "
            "(client socket) is the bottleneck, not the engine"
        )
    if verdict is None:
        verdict = "healthy"
        evidence.append(
            f"compute {compute_s:.3f}s dominates queue {queue_s:.3f}s, "
            f"flush {flush_s:.3f}s and preemption stalls "
            f"{preempt_stall_s:.3f}s over a {wall:.3f}s wall"
        )
    if n_preempt and verdict != "preemption_bound":
        evidence.append(
            f"{n_preempt} preemption(s) observed "
            f"(total stall {preempt_stall_s:.3f}s)"
        )
    out["verdict"] = verdict
    out["evidence"] = evidence
    out["legs"] = legs
    return out


def diagnose(
    doc: Dict[str, Any],
    *,
    status: Optional[str] = None,
    num_rows: Optional[int] = None,
    in_flight: bool = False,
) -> Dict[str, Any]:
    """Analyze one merged job telemetry document into a diagnosis with
    a named bottleneck verdict (see module docstring for the taxonomy)
    and human-readable evidence lines.

    ``in_flight`` marks a diagnosis over a RUNNING job's live span
    window (the monitor's continuous doctor, or ``sutro doctor`` on a
    job that hasn't terminated). It is also derived from a non-terminal
    ``status``. In flight, zero spans are expected early — the verdict
    is ``warming_up`` (a partial-data marker), never the alarming
    ``insufficient_data``; with spans present the normal verdict is
    produced but flagged partial, since attribution covers only what
    has executed so far."""
    if status is not None and str(status).upper() not in _TERMINAL_STATUSES:
        in_flight = True
    job_id = doc.get("job_id")
    counters = doc.get("counters") or {}
    attrs = doc.get("attrs") or {}

    # -- assemble per-process span lists (merged by round per rank) ----
    procs: Dict[str, Dict[str, Any]] = {
        "rank0": {
            "spans": list(doc.get("spans") or ()),
            "counters": counters,
            "device": attrs.get("device"),
        }
    }
    world = None
    for s in procs["rank0"]["spans"]:
        a = s.get("attrs") or {}
        if s.get("name") == "dp_round" and a.get("world"):
            world = int(a["world"])
    present_ranks = set()
    for w in doc.get("workers") or ():
        rank = w.get("rank")
        present_ranks.add(rank)
        name = f"rank{rank}"
        p = procs.setdefault(
            name, {"spans": [], "counters": {}, "device": None}
        )
        p["spans"].extend(w.get("spans") or ())
        if w.get("counters"):
            p["counters"] = w["counters"]
        dev = (w.get("attrs") or {}).get("device")
        if dev:
            p["device"] = dev

    processes: Dict[str, Dict[str, Any]] = {}
    for name in sorted(procs):
        p = procs[name]
        att = _attribution(p["spans"])
        rl = _grade_roofline(p["spans"], p["device"], p["counters"])
        if rl is not None:
            att["roofline"] = rl
        processes[name] = att

    missing_ranks = (
        sorted(r for r in range(1, world) if r not in present_ranks)
        if world
        else []
    )

    # -- evidence + verdict --------------------------------------------
    evidence: List[str] = []
    verdict: Optional[str] = None

    if missing_ranks:
        evidence.append(
            "partial data: no telemetry shard from rank(s) "
            + ", ".join(str(r) for r in missing_ranks)
            + f" of a world of {world} (old worker or telemetry "
            "disabled there)"
        )

    total_spans = sum(a["spans"] for a in processes.values())
    if total_spans == 0:
        if in_flight:
            verdict = "warming_up"
            evidence.append(
                "job is still in flight and no spans have landed in "
                "the live window yet — partial data, retry shortly"
            )
        else:
            verdict = "insufficient_data"
            evidence.append(
                "no spans recorded for this job (telemetry disabled, "
                "or the flight recorder evicted its window)"
            )
    elif in_flight:
        evidence.append(
            "live verdict over the flight recorder's current span "
            "window — the job is still running, so attribution covers "
            "only work executed so far"
        )

    # interactive starvation: the serving gateway stamps per-request
    # latency aggregates onto co-resident batch jobs' attrs — starved
    # requests mean the latency tier is losing to this batch traffic
    ia = attrs.get("interactive") or {}
    if verdict is None and ia.get("starved"):
        verdict = "interactive_starved"
        evidence.append(
            f"{ia['starved']} of {ia.get('requests', ia['starved'])} "
            "interactive request(s) sharing this job's decode window "
            f"waited over {INTERACTIVE_STARVED_TTFT_S:.0f}s for a "
            "first token (max TTFT "
            f"{ia.get('ttft_max_s', 0.0):.1f}s): raise "
            "EngineConfig.interactive_slots or lower the batch load"
        )
    elif ia.get("requests"):
        evidence.append(
            f"{ia['requests']} interactive request(s) co-scheduled "
            f"with this job (max TTFT {ia.get('ttft_max_s', 0.0):.1f}s"
            + (
                f"; {ia['preempted_rows']} batch row(s) preempted and "
                "re-admitted"
                if ia.get("preempted_rows")
                else ""
            )
            + ")"
        )

    # stage starvation (stage-graph jobs): a downstream stage that sat
    # idle waiting for its first upstream row for most of the job's
    # wall — the streaming handoff degenerated into a full-stage
    # barrier (upstream too slow, feed cadence too coarse, or a host
    # stage blocking the chain)
    sg = attrs.get("stages") or {}
    if verdict is None and sg:
        wall = max(
            (s.get("done_s") or 0.0 for s in sg.values()), default=0.0
        )
        starved = [
            (n, s.get("starved_s") or 0.0)
            for n, s in sg.items()
            if wall > 0
            and (s.get("starved_s") or 0.0) >= STAGE_STARVED_FRAC * wall
        ]
        if starved:
            verdict = "stage_starved"
            worst = max(starved, key=lambda kv: kv[1])
            evidence.append(
                f"stage {worst[0]!r} waited {worst[1]:.3f}s for its "
                f"first upstream row ({100 * worst[1] / wall:.0f}% of "
                f"the {wall:.3f}s stage-graph wall, threshold "
                f"{STAGE_STARVED_FRAC:.0%}): upstream decode dominates "
                "the DAG — lower SUTRO_STAGE_FEED_EVERY, shrink the "
                "upstream stage's max_new_tokens, or split the graph"
            )

    # straggler: a rank whose wall dwarfs the median of the others
    walls = {
        n: a["wall_s"] for n, a in processes.items() if a["spans"]
    }
    if verdict is None and len(walls) >= 2:
        slowest = max(sorted(walls), key=lambda n: walls[n])
        rest = _median([v for n, v in walls.items() if n != slowest])
        if rest > 0 and walls[slowest] >= STRAGGLER_RATIO * rest:
            verdict = "straggler_worker"
            evidence.append(
                f"{slowest} wall {walls[slowest]:.3f}s vs median "
                f"{rest:.3f}s of the other process(es) "
                f"(>= {STRAGGLER_RATIO}x): the pod waits on that slice"
            )

    device_s = round(
        sum(a["device_s"] for a in processes.values()), 6
    )
    host_s = round(sum(a["host_s"] for a in processes.values()), 6)
    io_s = round(sum(a["io_s"] for a in processes.values()), 6)
    admit_s = round(host_s - io_s, 6)  # tokenize+constraint+accept

    if verdict is None and io_s > device_s and io_s > admit_s:
        verdict = "io_bound"
        evidence.append(
            f"flush+finalize {io_s:.3f}s exceed device time "
            f"{device_s:.3f}s and the rest of the host pipeline "
            f"{admit_s:.3f}s: the jobstore I/O path is the bottleneck"
        )
    if verdict is None and admit_s > device_s:
        top = ""
        top_s = -1.0
        for a in processes.values():
            for st in ("tokenize", "constraint_compile", "accept"):
                v = a["stages"].get(st, {}).get("total_s", 0.0)
                if v > top_s:
                    top, top_s = st, v
        verdict = "host_bound_admit"
        evidence.append(
            f"host admission pipeline {admit_s:.3f}s exceeds device "
            f"time {device_s:.3f}s (largest: {top} {top_s:.3f}s): the "
            "chip starves behind the host"
        )

    # tiered-KV pool health (engine/kvtier.py stamps attrs["kv_tier"]
    # at job end): migration time competing with device time means the
    # pool is thrashing between tiers; preempted rows that mostly
    # RE-PREFILL instead of resuming by page-upload mean the host/disk
    # tiers are losing the state they exist to keep
    kvt = attrs.get("kv_tier") or {}
    if kvt:
        migrate_s = round(
            sum(
                a["stages"].get(st, {}).get("total_s", 0.0)
                for a in processes.values()
                for st in ("kv_demote", "kv_promote")
            ),
            6,
        )
        if (
            verdict is None
            and device_s > 0
            and migrate_s > 0.25 * device_s
        ):
            verdict = "kv_pressure"
            evidence.append(
                f"tier migrations spent {migrate_s:.3f}s against "
                f"{device_s:.3f}s of device time "
                f"({kvt.get('demotes', 0)} demotion(s), "
                f"{kvt.get('promotes', 0)} promotion(s)): the paged "
                "pool is thrashing across tiers — grow the HBM pool, "
                "raise kv_tier_host_pages, or lower resident sessions"
            )
        reup = kvt.get("resumes_upload", 0)
        repre = kvt.get("resumes_reprefill", 0)
        if verdict is None and repre > reup and repre > 0:
            verdict = "resume_bound"
            evidence.append(
                f"{repre} preempted row(s) re-prefilled from scratch "
                f"vs {reup} resumed by page-upload: hibernated state "
                "is falling out of the host/disk tiers before resume "
                "(raise kv_tier_host_pages or enable kv_tier_disk)"
            )
        elif reup or repre:
            evidence.append(
                f"kv tiers: {reup} page-upload resume(s), {repre} "
                f"re-prefill(s), {kvt.get('demotes', 0)} demotion(s), "
                f"{kvt.get('promotes', 0)} promotion(s)"
            )

    if verdict is None:
        pcts = [
            a["roofline"]["decode_pct_hbm_median"]
            for a in processes.values()
            if a.get("roofline", {}).get("decode_pct_hbm_median")
            is not None
        ]
        if pcts and _median(pcts) < ROOFLINE_OK_PCT:
            verdict = "decode_below_roofline"
            evidence.append(
                f"median decode window at {_median(pcts):.1f}% of the "
                f"HBM roofline (< {ROOFLINE_OK_PCT:.0f}%): decode is "
                "device-bound but far from the memory-bandwidth bound "
                "(batch too small, context too short, or kernel "
                "inefficiency)"
            )

    if verdict is None:
        verdict = "healthy"
        evidence.append(
            f"device time {device_s:.3f}s dominates host time "
            f"{host_s:.3f}s and no process stands out"
        )

    q = counters.get("rows_quarantined", 0)
    if q:
        evidence.append(
            f"{q} row(s) quarantined — see the job's failure_log for "
            "per-row causes"
        )

    # elastic dp fleet summary (engine/api stamps attrs["dp_fleet"]
    # at round end): steals corroborate — or pre-empt — a straggler
    # verdict, requeues explain wall-time spent re-running rows
    fleet = attrs.get("dp_fleet") or {}
    stolen = fleet.get("stolen_rows", 0)
    if stolen:
        evidence.append(
            f"{stolen} row(s) stolen from straggling rank(s) by idle "
            "ranks (first result won; "
            f"{fleet.get('duplicate_results_dropped', 0)} duplicate "
            "result(s) dropped) — the fleet masked a straggler"
        )
    requeued = fleet.get("requeued_rows", 0)
    if requeued:
        lost = fleet.get("lost_ranks") or []
        drained = fleet.get("drained_ranks") or []
        detail = []
        if lost:
            detail.append(
                "lost rank(s) " + ", ".join(str(r) for r in lost)
            )
        if drained:
            detail.append(
                "preemption-drained rank(s) "
                + ", ".join(str(r) for r in drained)
            )
        evidence.append(
            f"{requeued} row(s) requeued and re-run elsewhere"
            + (" (" + "; ".join(detail) + ")" if detail else "")
            + " — wall time includes the re-execution"
        )
    late = fleet.get("late_joiners") or []
    if late:
        evidence.append(
            "rank(s) " + ", ".join(str(r) for r in late)
            + " joined the round late and absorbed re-sharded rows"
        )

    # radix prefix store (engine/prefixstore.py): api stamps
    # attrs["prefix"] with saved-vs-paid shell prefill tokens. A fully
    # cold shell on a warm-capable engine is evidence (a repeat of this
    # job would hit), not a verdict — prefill may still be cheap
    # relative to decode.
    pa = attrs.get("prefix") or {}
    saved = pa.get("saved_tokens", 0)
    paid = pa.get("paid_tokens", 0)
    if saved:
        evidence.append(
            f"prefix store: {saved} shell prefill token(s) skipped "
            f"(warm KV reused; {paid} paid for the novel tail)"
        )
    elif paid:
        evidence.append(
            f"prefix_cold: {paid} shared-prefix token(s) prefilled "
            "with zero store hits — first job for this shell (repeats "
            "will reuse its KV), or the store evicted it under "
            "allocation pressure (sutro_prefix_store_evictions_total)"
        )

    return {
        "version": DOCTOR_VERSION,
        "job_id": job_id,
        "status": status,
        "num_rows": num_rows,
        "verdict": verdict,
        "evidence": evidence,
        "in_flight": in_flight,
        "partial": bool(missing_ranks) or in_flight,
        "missing_ranks": missing_ranks,
        "world": world,
        "processes": processes,
        "totals": {
            "spans": total_spans,
            "device_s": device_s,
            "host_s": host_s,
            "io_s": io_s,
        },
    }


# -- fleet-level diagnosis (fleet router /fleet + `sutro fleet status`) --

FLEET_VERDICTS = (
    "no_healthy_replicas",
    "replica_flapping",
    "fleet_degraded",
    "healthy",
)


def diagnose_fleet(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Grade a fleet membership snapshot (fleet/membership.py
    ``snapshot()``, optionally with router counters merged in) into a
    fleet-level verdict. Pure analysis, same contract as
    :func:`diagnose`: runs identically on a live router's snapshot or
    a synthetic one in tests.

    Priority order: a fleet with zero routable replicas is an outage
    regardless of why; a flapping replica (breaker cycling — probe
    flakiness, overload, or a crash loop) outranks a plainly-open one
    because it poisons routing decisions on every transition; any open
    breaker with capacity remaining is degraded-but-serving.
    """
    replicas = list(doc.get("replicas") or ())
    n_healthy = int(doc.get("n_healthy") or 0)
    evidence: List[str] = []

    flapping = [
        r.get("rid")
        for r in replicas
        if int(r.get("transitions_in_window") or 0) >= 3
    ]
    broken = [
        r.get("rid")
        for r in replicas
        if r.get("state") in ("open", "half_open")
    ]
    draining = [r.get("rid") for r in replicas if r.get("draining")]

    if not replicas or n_healthy == 0:
        verdict = "no_healthy_replicas"
        evidence.append(
            f"0 of {len(replicas)} replica(s) routable — every request "
            "is refused at the front door (check replica processes and "
            "probe reachability)"
        )
    elif flapping:
        verdict = "replica_flapping"
        evidence.append(
            f"replica(s) {sorted(flapping)} crossed >= 3 breaker "
            "transitions inside the flap window — probe flakiness, "
            "overload, or a crash loop; routing churns on every flip"
        )
    elif broken or draining:
        verdict = "fleet_degraded"
        if broken:
            evidence.append(
                f"breaker open on {sorted(broken)}; fleet serving on "
                f"{n_healthy}/{len(replicas)} replica(s)"
            )
        if draining:
            evidence.append(
                f"replica(s) {sorted(draining)} draining (SIGTERM "
                "shutdown in progress) — excluded from routing while "
                "in-flight work finishes"
            )
    else:
        verdict = "healthy"
        evidence.append(
            f"all {len(replicas)} replica(s) routable"
        )

    failovers = doc.get("failovers") or {}
    if isinstance(failovers, dict) and any(failovers.values()):
        evidence.append(
            "failovers so far: "
            + ", ".join(
                f"{k}={v}" for k, v in sorted(failovers.items()) if v
            )
        )

    return {
        "version": DOCTOR_VERSION,
        "verdict": verdict,
        "evidence": evidence,
        "n_replicas": len(replicas),
        "n_healthy": n_healthy,
        "flapping": sorted(flapping),
        "open": sorted(broken),
        "draining": sorted(draining),
    }
