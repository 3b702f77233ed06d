"""One run of one cell: set-up, the measured window, the output check,
and the result line.

The cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; each is a file the harness finds by name (``configs``'
``file``, ``portbench/traffic/<mix>.json``), the mix names its
generator (``portbench/gen/<kind>.py``), each per-layer metric is a
reader of its own (``portbench/metrics/<metric>.py``) and the check's
limits are ``portbench/limits/<cell>.json``. Nothing here names a cell,
a configuration, a mix or a metric.

Set-up: the program's kernels are built (or found built in the
checkout), the engine is made with the configuration's settings and
weights drawn on the card from the seed, jobs are submitted and the
harness waits until every decode slot is busy. The window then runs for
``--seconds`` while a submitter keeps ``queued_jobs`` jobs' rows waiting
beyond the slots. ``tok_s`` is read from the jobs' own progress records;
``--trace 1`` also traces the window and reads the per-layer metrics.
After the window: the peak memory is read, a sample of finished greedy
rows is taken, the engine is stopped and freed, and the reference runs
over the sample.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import check, program, yardstick

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "sutro_tpu")
WARMUP_LIMIT_S = 900.0
CHECK_WAIT_S = 60.0


class Refused(SystemExit):
    """A run that prints no result: stop with a reason and exit code 2."""

    def __init__(self, why: str):
        print(f"portbench: {why}", file=sys.stderr, flush=True)
        super().__init__(2)


# -- finding things by name -------------------------------------------------

class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.exists():
            raise Refused(f"no {path}")
        self.doc = json.loads(path.read_text())

    def cell(self, name: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise Refused(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise Refused(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> Dict:
        return json.loads((self.root / "portbench" / "traffic" / f"{name}.json").read_text())

    def generator(self, mix: Dict, seed: int, model: str):
        path = self.root / "portbench" / "gen" / f"{mix['kind']}.py"
        return _load(path).make(mix, seed, model)

    def limits(self, cell: str) -> Dict:
        return json.loads((self.root / "portbench" / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell: Dict, trace: bool) -> List[Dict]:
        """The cell's metrics for this kind of run."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.doc[key] if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str):
        """``portbench/metrics/<metric>.py``'s ``read``."""
        return _load(self.root / "portbench" / "metrics" / f"{metric}.py").read


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- clocks -------------------------------------------------------------------

def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# -- the jobs -----------------------------------------------------------------

class Traffic:
    """Submits the generator's jobs in order, follows each job's progress
    stream, and keeps ``queued_jobs`` jobs' rows waiting beyond the
    slots."""

    def __init__(self, eng, gen, slots: int, queued_jobs: int):
        self.eng, self.gen = eng, gen
        self.target = slots + queued_jobs * gen.rows_per_job
        self.jobs: List[Dict] = []          # {"k", "id", "payload"}
        self.records: List[tuple] = []      # (t, job index, kind, value)
        self.submits: List[tuple] = []      # host spans of submit calls
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._followers: List[threading.Thread] = []
        self._thread: Optional[threading.Thread] = None

    def rows_done(self) -> int:
        latest: Dict[int, int] = {}
        with self._lock:
            for _, j, kind, v in self.records:
                if kind == "progress":
                    latest[j] = max(latest.get(j, 0), int(v))
        return sum(latest.values())

    def submit_next(self) -> None:
        k = len(self.jobs)
        payload = self.gen.job(k)
        t0 = time.perf_counter()
        jid = self.eng.submit_batch_inference(payload)
        self.submits.append((t0, time.perf_counter()))
        self.jobs.append({"k": k, "id": jid, "payload": payload})
        th = threading.Thread(target=self._follow, args=(k, jid), daemon=True)
        th.start()
        self._followers.append(th)

    def _follow(self, k: int, jid: str) -> None:
        for rec in self.eng.stream_job_progress(jid):
            t = time.perf_counter()
            kind = rec.get("update_type")
            if kind == "tokens":
                r = rec["result"]
                v = int(r.get("input_tokens", 0)) + int(r.get("output_tokens", 0))
            elif kind == "progress":
                v = int(rec["result"])
            else:
                continue
            with self._lock:
                self.records.append((t, k, kind, v))

    def fill(self) -> None:
        while len(self.jobs) * self.gen.rows_per_job - self.rows_done() < self.target:
            self.submit_next()

    def start(self) -> None:
        def loop():
            while not self._stop.wait(0.2):
                self.fill()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def join(self) -> None:
        """Wait for every progress stream's follower (the streams end when
        the engine closes)."""
        for th in self._followers:
            th.join(timeout=30)
        if any(th.is_alive() for th in self._followers):
            raise RuntimeError("a job's progress stream did not end")

    def billed_at(self, t: float) -> float:
        """Tokens billed by time ``t``. A job's first record bills its rows'
        prompts at their admission, a step; each later record bills the
        decode steps run since the job's previous record, so the bill rises
        evenly between the two."""
        per_job: Dict[int, List[tuple]] = {}
        for tt, j, kind, v in self.records:
            if kind == "tokens":
                per_job.setdefault(j, []).append((tt, v))
        total = 0.0
        for pts in per_job.values():
            pts.sort()
            prev = None
            for tt, v in pts:
                v = max(v, prev[1]) if prev else v
                if tt > t:
                    if prev is not None:
                        total += prev[1] + (v - prev[1]) * (t - prev[0]) / (tt - prev[0])
                    break
                prev = (tt, v)
            else:
                total += prev[1]
        return total

    def await_record_after(self, t: float, timeout: float) -> None:
        """Wait until a record after ``t`` bills something (the decode call
        in flight at ``t`` has ended), and a moment more for the other
        jobs' followers to append that call's records."""
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            with self._lock:
                billed_since = self.billed_at(float("inf")) - self.billed_at(t)
            if billed_since > 0:
                time.sleep(0.5)
                return
            time.sleep(0.05)

    def rate(self, t_open: float, t_close: float) -> Optional[float]:
        """Billed tokens a second over the whole window: a call in flight
        at the open or the close counts by the share of its time inside
        the window (:meth:`billed_at`)."""
        with self._lock:
            billed = self.billed_at(t_close) - self.billed_at(t_open)
        return billed / (t_close - t_open) if billed > 0 else None

    def rows_in(self, t_open: float, t_close: float) -> int:
        with self._lock:
            def done(t):
                latest: Dict[int, int] = {}
                for tt, j, kind, v in self.records:
                    if kind == "progress" and tt <= t:
                        latest[j] = max(latest.get(j, 0), v)
                return sum(latest.values())
            return done(t_close) - done(t_open)

    def last_billed(self, k: int) -> Optional[int]:
        with self._lock:
            vals = [v for _, j, kind, v in self.records if j == k and kind == "tokens"]
        return max(vals) if vals else None


# -- the run --------------------------------------------------------------------

class RunView:
    """What a per-layer metric reader sees."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def decode_calls(self):
        return [d for d in self.spans.decode if self.t_open <= d[0] <= self.t_close]

    def prefill_calls(self):
        return [p for p in self.spans.prefill if self.t_open <= p[0] <= self.t_close]

    def decode_steps(self) -> int:
        return sum(d[2] for d in self.decode_calls())

    def decode_busy_s(self) -> Optional[float]:
        """Device seconds of the window's decode: the union of the trace's
        operations, less the parts of it that ran inside a prefill call
        (the runner's prefill entries return its results to the host, so
        their work has ended by their span's close)."""
        from .trace import union

        if not self.ops:
            return None
        pre = sorted(p[:2] for p in self.prefill_calls())
        inside = [(max(s, a), min(e, b)) for _, s, e in self.ops for a, b in pre
                  if s < b and e > a]
        return self.busy_s - union(inside)

    def kernel_seconds(self, match) -> Optional[float]:
        from .trace import by_name

        return by_name(self.ops, match) if self.ops else None


def banned_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(BANNED))


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        root: Path = ROOT, device: str = "cuda", check_rows: Optional[int] = None,
        control: Optional[str] = None) -> int:
    """Run the cell and print its result line. ``control`` (``int4``,
    ``fp8``; for setting the check's limits, never in the benchmark's
    runs) puts the reference in that precision in the program's place:
    the check judges the tokens it puts first at the served positions,
    and the program's own readings go to standard error only."""
    import torch

    bench = Bench(root)
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    limits = bench.limits(cell_name)
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{cell['chips']} cards asked, {torch.cuda.device_count()} present")
    cache = root / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TORCH_KERNEL_CACHE_PATH", str(cache / "torch_kernels"))
    home = Path(tempfile.mkdtemp(prefix="portbench-"))
    os.environ["SUTRO_HOME"] = str(home)
    try:
        return _run(bench, cell, cfg, mix, limits, seed, seconds, trace, home,
                    device, check_rows, control)
    finally:
        shutil.rmtree(home, ignore_errors=True)


def _run(bench, cell, cfg, mix, limits, seed, seconds, trace, home, device, check_rows,
         control) -> int:
    import torch

    from .weights import SeededWeights

    on_card = device == "cuda"
    program.check_model(cfg)
    eng_cfg = cfg["engine"]
    B = int(eng_cfg["decode_batch_size"])
    if on_card:
        program.build_kernels()
    weights = SeededWeights(cfg["model"], seed, device=device)
    program.install_weights(weights)
    (home / "weights" / cfg["engine_key"]).mkdir(parents=True)
    spans = program.Spans(int(eng_cfg["kv_page_size"]), int(eng_cfg.get("prefill_chunk", 512)),
                          record_gemm=trace and bool(cfg["model"].get("num_experts")))
    tracer = None
    if trace:
        from .trace import Tracer

        Tracer().warm()
        tracer = Tracer()
    eng = program.make_engine(eng_cfg, str(home / "weights"), seed, device)
    gen = bench.generator(mix, seed, cfg["engine_key"])
    traffic = Traffic(eng, gen, B, int(mix.get("queued_jobs", 2)))
    try:
        traffic.fill()
        traffic.start()
        deadline = time.perf_counter() + WARMUP_LIMIT_S
        full = 0
        while full < 2:
            if time.perf_counter() > deadline:
                raise RuntimeError("warm-up: the decode slots never all filled")
            n = len(spans.decode)
            time.sleep(0.05)
            if len(spans.decode) > n and spans.last_active == B:
                full += 1
        if on_card:
            torch.cuda.synchronize()
        setup_s = process_age_s()
        t_open = tracer.start() if tracer else time.perf_counter()
        time.sleep(seconds)
        if on_card:
            torch.cuda.synchronize()
        t_close = tracer.stop() if tracer else time.perf_counter()
        traffic.stop()
        traffic.await_record_after(t_close, CHECK_WAIT_S)
        tok_s = traffic.rate(t_open, t_close)
        if trace and tok_s is not None:
            # the profiler's cost: set beside the untraced runs' tok_s
            print(f"portbench: traced window's tok_s {tok_s / int(cell['chips'])}",
                  file=sys.stderr, flush=True)
        peak = torch.cuda.max_memory_allocated() if on_card else 0

        # the output check's rows: greedy jobs finished by the close (or
        # the first to finish within CHECK_WAIT_S of it)
        def finished(k_only_greedy: bool):
            return [j for j in traffic.jobs
                    if (gen.greedy(j["k"]) or not k_only_greedy)
                    and eng.job_status(j["id"]) == "SUCCEEDED"]
        greedy_done = finished(True)
        wait_end = time.perf_counter() + CHECK_WAIT_S
        while not greedy_done and time.perf_counter() < wait_end:
            time.sleep(0.5)
            greedy_done = finished(True)
        done = finished(False)
        view = None
        if trace:
            view = _trace_view(cfg, cell, tracer, spans, traffic, t_open, t_close, device)
        rows, mismatched, failed, attempted = _collect(cfg, eng, traffic, done, greedy_done,
                                                       seed, check_rows or int(mix["check_rows"]))
    finally:
        traffic.stop()
        program.close_engine(eng, [j["id"] for j in traffic.jobs])
        spans.close()
        traffic.join()
        traffic.eng = None
    del eng
    import gc

    gc.collect()
    weights.release()
    t_ref = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        print(f"portbench: setup {setup_s:.1f} s, window {t_close - t_open:.1f} s, "
              f"after the window {t_ref - t_close:.1f} s; device memory in use before the "
              f"reference {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
              file=sys.stderr, flush=True)

    # the reference, in float32 with TF32 off
    from .reference.qwen3 import full_fp32

    full_fp32()
    read = check.gaps(cfg, weights, rows, control) if rows else {}
    none = {"max": float("inf"), "mean": float("inf")}
    served = read.get("served", none)
    if control:
        print(f"program (not judged in a control run): logit_gap {served['max']} "
              f"mean_logit_gap {served['mean']}", file=sys.stderr, flush=True)
        served = read.get(control, none)
    print(f"portbench: reference {time.perf_counter() - t_ref:.1f} s over {len(rows)} rows, "
          f"{sum(len(r['served']) for r in rows)} served tokens", file=sys.stderr, flush=True)
    readings = {"logit_gap": served["max"], "mean_logit_gap": served["mean"]}
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    checks["billed_mismatch"] = {"value": mismatched, "limit": 0}
    checks["failed_rows"] = {"value": failed, "limit": 0}
    checks["rows_checked"] = {"value": len(rows), "limit": 1}
    correct = (all(readings[n] <= lim for n, lim in limits.items())
               and mismatched == 0 and failed == 0 and len(rows) >= 1)
    uncompared = {n: v for n, v in readings.items() if n not in limits}
    if uncompared:
        print(f"portbench: not compared: {uncompared}", file=sys.stderr, flush=True)

    metrics: Dict[str, Dict] = {}
    dev_block: Dict = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        for m in bench.metrics(cell, trace=True):
            v = bench.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_block["busy_s"] = view.busy_s
        dev_block["window_s"] = view.window_s
        breakdown = view.breakdown
    else:
        taken = {"tok_s": None if tok_s is None else tok_s / int(cell["chips"]),
                 "setup_s": setup_s}
        for m in bench.metrics(cell, trace=False):
            value = taken.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    banned = banned_modules()
    if banned:
        raise Refused(f"modules loaded that the benchmark may not load: {banned}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_block}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


def _collect(cfg, eng, traffic, done, greedy_done, seed, n_check):
    """The sample of greedy rows for the reference, and the bill check
    over every finished job."""
    mismatched = failed = attempted = 0
    candidates = []
    # a finished job's last progress record may reach its follower a
    # moment after the job's status: one shared wait for all of them
    deadline = time.perf_counter() + 30.0
    for j in done:
        res = eng.job_results(j["id"], include_cumulative_logprobs=True)
        p = j["payload"]
        prompts = check.prompt_tokens(cfg, p["inputs"], p["system_prompt"])
        gen_tokens = res.get("gen_tokens") or [0] * len(prompts)
        attempted += len(prompts)
        failed += sum(e is not None for e in res.get("errors") or [])
        want = check.billed([len(x) for x in prompts], gen_tokens)
        while traffic.last_billed(j["k"]) != want and time.perf_counter() < deadline:
            time.sleep(0.1)
        if traffic.last_billed(j["k"]) != want:
            print(f"portbench: job {j['k']} billed {traffic.last_billed(j['k'])}, rows sum to {want}",
                  file=sys.stderr, flush=True)
            mismatched += 1
        if j in greedy_done:
            for i, (ids, text, n) in enumerate(zip(prompts, res["outputs"], gen_tokens)):
                served = check.served_ids(text, int(n))
                candidates.append({"k": j["k"], "row": i, "prompt": ids,
                                   "served": served if served is not None else [],
                                   "unreadable": served is None})
    if any(c["unreadable"] for c in candidates):
        failed += sum(c["unreadable"] for c in candidates)
    candidates = [c for c in candidates if not c["unreadable"]]
    if not candidates:
        return [], mismatched, failed, attempted
    # the longest row, then rows drawn from the seed with a chance in
    # proportion to their served tokens: the check reads served positions
    longest = max(range(len(candidates)),
                  key=lambda i: len(candidates[i]["prompt"]) + len(candidates[i]["served"]))
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7])
    others = [i for i in range(len(candidates)) if i != longest]
    w = np.array([len(candidates[i]["served"]) + 1.0 for i in others])
    k = min(n_check - 1, len(others))
    rest = list(rng.choice(others, size=k, replace=False, p=w / w.sum())) if k else []
    return [candidates[i] for i in [longest, *rest]], mismatched, failed, attempted


def _trace_view(cfg, cell, tracer, spans, traffic, t_open, t_close, device):
    import torch

    from . import trace as tr

    ops = tracer.device_ops() if device == "cuda" else []
    window_s = t_close - t_open
    busy_s = tr.union([(s, e) for _, s, e in ops])
    host = {"runner.prefill": [(p[0], p[1]) for p in spans.prefill],
            "runner.decode": [(d[0], d[1]) for d in spans.decode],
            "harness.submit": list(traffic.submits)}
    idle = tr.gaps(ops, t_open, t_close)
    per_name: Dict[str, float] = {}
    for n, s, e in ops:
        per_name[n] = per_name.get(n, 0.0) + (e - s)
    breakdown = {
        "device_ops": [[n[:120], v] for n, v in
                       sorted(per_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, v] for n, v in tr.label_gaps(idle, host)[:10]],
    }
    pk = yardstick.peaks(torch.cuda.get_device_name(0)) if device == "cuda" else None
    return RunView(cfg=cfg, cell=cell, model=yardstick.Model.of(cfg), peaks=pk,
                   t_open=t_open, t_close=t_close, window_s=window_s, busy_s=busy_s,
                   ops=ops, spans=spans, traffic=traffic,
                   gemm=spans.experts_touched(t_open, t_close), breakdown=breakdown)
