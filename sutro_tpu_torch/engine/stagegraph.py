"""Server-side stage graphs: DAG batch jobs with streaming handoff.

The port of ``sutro_tpu/engine/stagegraph.py``. It needs no pandas: the
port's JSON-lines jobstore reads a row's missing error back as None
(the reference's parquet store gives NaN, which it tests with
``pd.isna``), and the ELO stage calls ``templates.evals.elo_fit``, the
pandas-free Bradley–Terry fit behind ``Rank.elo``.

A batch submit may carry a small DAG of stages (``payload["stages"]``):
*map* stages run an LM call per row with per-stage model / schema /
prompt template; *filter* stages apply a host-side predicate; *elo* and
*pair* stages are host-side reduces (rank aggregation via the
Bradley–Terry fit ``templates.evals.elo_fit``, and round-robin
match-making). The whole DAG is validated and priced at submit
(:func:`parse_graph`, :func:`graph_cost_bounds` — an invalid graph is a
structured :class:`InvalidGraph` 400, mirroring jobstore.InvalidPriority)
and executed entirely inside the engine by :class:`StageGraphRunner`.

Execution model (SGLang-style structured programs):

- Every map stage is a real nested job record (``<job>/stages/<name>``)
  with its own partial chunk store, failure_log, telemetry trace and
  results — the chunked jobstore is the inter-stage transport
  and the crash-safe resume substrate (a half-finished DAG re-derives
  all state from the per-stage partial stores).
- Same-engine map stages share ONE scheduler session
  (``ContinuousBatcher.run_multi``): a downstream stage's JobCtx starts
  empty with ``hold_open`` set and is FED rows as upstream results land
  (no full-stage barrier — downstream rows admit while upstream still
  decodes). Shared prompt shells between stages ride the radix prefix
  store instead of being re-prefilled.
- Failure domains stay row-level with the scheduler's quarantine semantics
  scoped per stage: a quarantined row propagates as an error placeholder
  (no LM call downstream) and the drop is recorded in the parent job's
  ``failure_log``.
- The single sink stage's rows copy into the parent job's partial store
  and finalize through the normal merge-on-read writer, so a stage-graph
  job's results surface exactly like a plain job's.

Off switch: a payload without ``stages`` never touches this module —
the wire bytes and result bits of plain jobs are unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import telemetry
from ..interfaces import JobStatus
from . import faults
from .jobstore import estimate_cost
from .scheduler import GenRequest

logger = logging.getLogger("sutro.engine")

# hard caps: stage graphs are SMALL programs, not data-flow frameworks
MAX_STAGES = 16
MAX_PAIRS_DEFAULT = 256
STAGE_KINDS = ("map", "filter", "elo", "pair")
_NAME_RE = re.compile(r"^[A-Za-z0-9_-]{1,32}$")
_PREDICATE_TYPES = ("not_error", "contains", "min_length")


class InvalidGraph(ValueError):
    """Malformed stage graph at submit. Structured like
    jobstore.InvalidPriority: the HTTP layer maps this to 400 with
    ``code=INVALID_GRAPH`` and a machine-readable ``reason`` tag —
    a cyclic or dangling-edge DAG is a caller error, never a server
    traceback."""

    code = "INVALID_GRAPH"
    status = 400

    def __init__(self, reason: str, message: str) -> None:
        self.reason = reason
        super().__init__(message)


class StageSpec:
    """One validated stage (normalized view over the wire dict)."""

    __slots__ = (
        "name", "kind", "after", "model", "system_prompt",
        "prompt_template", "output_schema", "sampling_params",
        "random_seed_per_input", "predicate", "max_pairs",
    )

    def __init__(self, d: Dict[str, Any]) -> None:
        self.name: str = d["name"]
        self.kind: str = d["kind"]
        self.after: List[str] = list(d.get("after") or [])
        self.model: Optional[str] = d.get("model")
        self.system_prompt: Optional[str] = d.get("system_prompt")
        self.prompt_template: str = d.get("prompt_template") or "{input}"
        self.output_schema = d.get("output_schema")
        self.sampling_params: Dict[str, Any] = dict(
            d.get("sampling_params") or {}
        )
        self.random_seed_per_input = bool(
            d.get("random_seed_per_input", False)
        )
        self.predicate: Dict[str, Any] = dict(
            d.get("predicate") or {"type": "not_error"}
        )
        self.max_pairs = int(d.get("max_pairs", MAX_PAIRS_DEFAULT))

    @property
    def parent(self) -> Optional[str]:
        return self.after[0] if self.after else None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "kind": self.kind, "after": self.after,
        }
        if self.kind == "map":
            out.update(
                model=self.model,
                system_prompt=self.system_prompt,
                prompt_template=self.prompt_template,
                output_schema=self.output_schema,
                sampling_params=self.sampling_params,
                random_seed_per_input=self.random_seed_per_input,
            )
        elif self.kind == "filter":
            out["predicate"] = self.predicate
        elif self.kind == "pair":
            out["max_pairs"] = self.max_pairs
        return out


class StageGraph:
    def __init__(self, stages: List[StageSpec], sink: str) -> None:
        self.stages = stages
        self.by_name = {s.name: s for s in stages}
        self.sink = sink

    def topo(self) -> List[StageSpec]:
        """Stages in dependency order (validated acyclic, parent-first).
        Deterministic: submit order, stably filtered."""
        done: Set[str] = set()
        out: List[StageSpec] = []
        while len(out) < len(self.stages):
            for s in self.stages:
                if s.name in done:
                    continue
                if s.parent is None or s.parent in done:
                    out.append(s)
                    done.add(s.name)
        return out

    def children(self, name: str) -> List[StageSpec]:
        return [s for s in self.stages if s.parent == name]

    def to_payload(self) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self.stages]


def parse_graph(
    raw: Any,
    default_model: str,
    resolve: Optional[Callable[[str], Any]] = None,
) -> StageGraph:
    """Validate a wire ``stages`` payload into a :class:`StageGraph`.

    Raises :class:`InvalidGraph` (HTTP 400) on any structural problem:
    cycles, dangling edges, duplicate or path-unsafe names, missing
    sink, bad arity. ``resolve`` (the engine's resolve_model) vets each
    map stage's model so an unknown model fails at submit, not at run.
    """
    if not isinstance(raw, list) or not raw:
        raise InvalidGraph(
            "not_a_list", "stages must be a non-empty list of stage dicts"
        )
    if len(raw) > MAX_STAGES:
        raise InvalidGraph(
            "too_many_stages",
            f"stage graphs are capped at {MAX_STAGES} stages, got {len(raw)}",
        )
    specs: List[StageSpec] = []
    names: Set[str] = set()
    for i, d in enumerate(raw):
        if not isinstance(d, dict):
            raise InvalidGraph(
                "not_a_dict", f"stages[{i}] must be a dict, got {type(d).__name__}"
            )
        name = d.get("name")
        if not isinstance(name, str) or not _NAME_RE.match(name):
            # the name becomes a jobstore sub-directory: the regex is a
            # path-traversal guard as much as a naming convention
            raise InvalidGraph(
                "bad_name",
                f"stages[{i}].name must match {_NAME_RE.pattern!r}, "
                f"got {name!r}",
            )
        if name in names:
            raise InvalidGraph(
                "duplicate_name", f"duplicate stage name {name!r}"
            )
        names.add(name)
        kind = d.get("kind", "map")
        if kind not in STAGE_KINDS:
            raise InvalidGraph(
                "bad_kind",
                f"stage {name!r}: kind must be one of {STAGE_KINDS}, "
                f"got {kind!r}",
            )
        after = d.get("after") or []
        if isinstance(after, str):
            after = [after]
        if not isinstance(after, list) or not all(
            isinstance(a, str) for a in after
        ):
            raise InvalidGraph(
                "bad_after", f"stage {name!r}: after must be a list of stage names"
            )
        if len(after) > 1:
            raise InvalidGraph(
                "multi_parent_unsupported",
                f"stage {name!r}: at most one upstream stage per stage "
                "(got {0})".format(len(after)),
            )
        if kind != "map" and not after:
            raise InvalidGraph(
                "missing_parent",
                f"stage {name!r}: kind {kind!r} requires an upstream "
                "stage in 'after'",
            )
        spec = StageSpec({**d, "name": name, "kind": kind, "after": after})
        if spec.kind == "map":
            if spec.model is None:
                spec.model = default_model
            if "{input}" not in spec.prompt_template:
                raise InvalidGraph(
                    "bad_template",
                    f"stage {name!r}: prompt_template must contain "
                    "'{input}'",
                )
            if resolve is not None:
                try:
                    resolve(spec.model)
                except Exception:
                    raise InvalidGraph(
                        "unknown_model",
                        f"stage {name!r}: unknown model {spec.model!r}",
                    ) from None
        if spec.kind == "filter" and (
            spec.predicate.get("type") not in _PREDICATE_TYPES
        ):
            raise InvalidGraph(
                "bad_predicate",
                f"stage {name!r}: predicate.type must be one of "
                f"{_PREDICATE_TYPES}",
            )
        specs.append(spec)
    by_name = {s.name: s for s in specs}
    # dangling edges + self loops
    for s in specs:
        for a in s.after:
            if a not in by_name:
                raise InvalidGraph(
                    "dangling_edge",
                    f"stage {s.name!r}: 'after' references unknown "
                    f"stage {a!r}",
                )
            if a == s.name:
                raise InvalidGraph(
                    "cycle", f"stage {s.name!r} depends on itself"
                )
    # cycle check (single-parent graph: walk each ancestor chain)
    for s in specs:
        seen = {s.name}
        cur = s.parent
        while cur is not None:
            if cur in seen:
                raise InvalidGraph(
                    "cycle",
                    f"stage graph contains a cycle through {cur!r}",
                )
            seen.add(cur)
            cur = by_name[cur].parent
    # exactly one sink (a stage nothing consumes): the DAG's result
    has_child = {a for s in specs for a in s.after}
    sinks = [s.name for s in specs if s.name not in has_child]
    if len(sinks) != 1:
        raise InvalidGraph(
            "multiple_sinks" if len(sinks) > 1 else "no_sink",
            "stage graph must have exactly ONE sink stage (a stage no "
            f"other stage lists in 'after'); found {sinks!r}",
        )
    return StageGraph(specs, sinks[0])


def estimate_stage_rows(graph: StageGraph, n_inputs: int) -> Dict[str, int]:
    """Upper-bound row count per stage for pricing/admission."""
    rows: Dict[str, int] = {}
    for s in graph.topo():
        if s.parent is None:
            rows[s.name] = n_inputs
        else:
            p = rows[s.parent]
            if s.kind == "pair":
                rows[s.name] = min(p * max(p - 1, 0) // 2, s.max_pairs)
            elif s.kind == "elo":
                # one output row per distinct player; bounded by the
                # corpus (rankings cannot introduce more players than
                # upstream rows mention, and pricing only needs a bound)
                rows[s.name] = p
            else:
                rows[s.name] = p
    return rows


def graph_cost_bounds(
    graph: StageGraph, n_inputs: int, default_max_new: int
) -> Tuple[int, int]:
    """(extra_input_token_bound, extra_max_new_total) the DAG adds on
    top of the plain root submit — priced up front so quota and the
    control plane's admission draw cover the WHOLE DAG, not just stage
    one. A downstream map row's prompt is bounded by its upstream
    stage's max_new_tokens plus the template/system-prompt overhead."""
    rows = estimate_stage_rows(graph, n_inputs)
    extra_in = 0
    extra_new = 0
    for s in graph.topo():
        if s.kind != "map":
            continue
        max_new = int(s.sampling_params.get("max_new_tokens", default_max_new))
        if s.parent is None:
            # root map stages ride the plain submit's own input bound;
            # only a non-default cap changes the output-side total
            extra_new += rows[s.name] * max(max_new - default_max_new, 0)
            continue
        parent = graph.by_name[s.parent]
        up_new = int(
            parent.sampling_params.get("max_new_tokens", default_max_new)
        ) if parent.kind == "map" else default_max_new
        overhead = len((s.system_prompt or "").encode("utf-8")) + len(
            s.prompt_template.encode("utf-8")
        ) + 64
        extra_in += rows[s.name] * (up_new + overhead)
        extra_new += rows[s.name] * max_new
    return extra_in, extra_new


def initial_stages_state(graph: StageGraph, n_inputs: int) -> Dict[str, Any]:
    est = estimate_stage_rows(graph, n_inputs)
    return {
        s.name: {
            "status": "pending",
            "kind": s.kind,
            "rows_done": 0,
            "rows_total": est[s.name],
            "quarantined": 0,
        }
        for s in graph.stages
    }


def stage_job_id(job_id: str, name: str) -> str:
    """Nested jobstore id: the stage's chunk store / record / trace all
    live under the parent job's directory (deleted with it, invisible
    to list_jobs). The name regex above keeps this path-safe."""
    return f"{job_id}/stages/{name}"


# ---------------------------------------------------------------------------
# Host-side stage kinds (filter / elo / pair)
# ---------------------------------------------------------------------------


def _predicate_fn(pred: Dict[str, Any]) -> Callable[[str], bool]:
    kind = pred.get("type", "not_error")
    if kind == "contains":
        needle = str(pred.get("value", ""))
        return lambda out: needle in out
    if kind == "min_length":
        n = int(pred.get("value", 1))
        return lambda out: len(out) >= n
    return lambda out: True  # not_error: error rows are pre-dropped


def _parse_rankings(outputs: List[str]) -> List[Any]:
    """Upstream rank-stage outputs -> Rank.elo input. Accepts a JSON
    array ranking or the schema-constrained ``{"ranking": [...]}``
    object; unparseable rows are skipped (they were LM output, not
    caller input — row-level tolerance, same as quarantine)."""
    rankings: List[Any] = []
    for out in outputs:
        try:
            v = json.loads(out)
        except ValueError:
            continue  # LM emitted non-JSON: skip the row, not the fit
        if isinstance(v, dict):
            v = v.get("ranking")
        if isinstance(v, list) and v:
            rankings.append(v)
    return rankings


def run_host_stage_kind(
    spec: StageSpec, ordered_outputs: List[Tuple[int, str]]
) -> List[str]:
    """Pure reduce/filter over the upstream stage's non-error outputs
    (row-id order). Deterministic — resume recomputes bit-identically."""
    if spec.kind == "filter":
        keep = _predicate_fn(spec.predicate)
        return [out for _, out in ordered_outputs if keep(out)]
    if spec.kind == "pair":
        # ELO match-making: round-robin pairings in row order, capped
        pairs: List[str] = []
        for i in range(len(ordered_outputs)):
            for j in range(i + 1, len(ordered_outputs)):
                if len(pairs) >= spec.max_pairs:
                    return pairs
                ai, a = ordered_outputs[i]
                bj, b = ordered_outputs[j]
                pairs.append(
                    json.dumps(
                        {"a": a, "b": b, "a_row": ai, "b_row": bj},
                        sort_keys=True,
                    )
                )
        return pairs
    if spec.kind == "elo":
        from ..templates.evals import elo_fit

        players, elo, _ = elo_fit(
            _parse_rankings([o for _, o in ordered_outputs])
        )
        return [
            json.dumps(
                {"player": str(p), "elo": round(float(e), 6)},
                sort_keys=True,
            )
            for p, e in zip(players, elo)
        ]
    raise ValueError(f"not a host stage kind: {spec.kind}")


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class _StageState:
    """Runtime state for one stage inside a StageGraphRunner."""

    __slots__ = (
        "spec", "id", "rec", "sess", "fed", "outbox", "collected",
        "complete", "cancelled", "upstream_done", "since_feed",
        "engine_key", "constraint_factory", "max_new", "t_first",
        "t_done", "t_first_feed", "n_quarantined",
    )

    def __init__(self, spec: StageSpec, sid: str) -> None:
        self.spec = spec
        self.id = sid
        self.rec = None
        self.sess = None                  # _GenSession (map, in-wave)
        self.fed: Set[int] = set()        # row ids handed to this stage
        self.outbox: List[Tuple[int, Dict[str, Any]]] = []
        self.collected: Dict[int, Dict[str, Any]] = {}
        self.complete = False
        self.cancelled = False
        self.upstream_done = False
        self.since_feed = 0
        self.engine_key = ""
        self.constraint_factory = None
        self.max_new = 0
        self.t_first: Optional[float] = None       # first result (s)
        self.t_done: Optional[float] = None        # stage complete (s)
        self.t_first_feed: Optional[float] = None  # first row fed (s)
        self.n_quarantined = 0

    @property
    def name(self) -> str:
        return self.spec.name

    def render(self, upstream_text: str) -> str:
        # .replace, not .format: user text may contain braces
        return self.spec.prompt_template.replace("{input}", upstream_text)


class StageGraphRunner:
    """Drive one stage-graph job to a terminal state (engine worker
    thread). Mirrors _run_job's contract: returns None normally, or the
    job's priority when the session yielded to a higher-priority job."""

    def __init__(self, eng, job_id: str, rec) -> None:
        self.eng = eng
        self.job_id = job_id
        self.rec = rec
        self.graph = parse_graph(
            rec.stages, default_model=rec.model
        )
        self.stages: Dict[str, _StageState] = {
            s.name: _StageState(s, stage_job_id(job_id, s.name))
            for s in self.graph.stages
        }
        self.by_id = {st.id: st for st in self.stages.values()}
        self.topo = [self.stages[s.name] for s in self.graph.topo()]
        self.batcher = None
        self.wave: List[_StageState] = []
        self.cancelled = False
        self.t0 = 0.0
        self.prefix_saved = 0
        self.prefix_paid = 0
        self.n_rows = 0
        self.feed_every = max(
            int(os.environ.get("SUTRO_STAGE_FEED_EVERY", "16")), 1
        )
        self.jm = eng.metrics.job(job_id)
        self._tel_on = telemetry.enabled()
        self.jtel = telemetry.job(job_id) if self._tel_on else None
        self.inputs: List[str] = []
        self.est_rows: Dict[str, int] = {}

    # -- setup / resume -------------------------------------------------

    def _ensure_stage_rec(self, st: _StageState):
        from .api import resolve_model

        try:
            return self.eng.jobs.get(st.id)
        except KeyError:
            pass  # first run (or pre-crash submit): create below
        spec = st.spec
        model = spec.model or self.rec.model
        engine_key, _, _ = resolve_model(model)
        # stage sampling OVERLAYS the parent job's: a submit-level
        # temperature/max_new applies to every stage unless that stage
        # overrides it (bit-identity with the client-side sequence,
        # where each job re-sends the same sampling dict)
        sampling = dict(self.rec.sampling_params or {})
        sampling.update(spec.sampling_params)
        sampling.setdefault(
            "max_new_tokens", self.eng.ecfg.max_new_tokens
        )
        return self.eng.jobs.create(
            job_id=st.id,
            name=spec.name,
            description=f"stage {spec.name!r} of {self.job_id}",
            model=model,
            engine_key=engine_key if spec.kind == "map" else "",
            num_rows=len(self.inputs) if (
                spec.kind == "map" and spec.parent is None
            ) else 0,
            job_priority=self.rec.job_priority,
            output_schema=spec.output_schema,
            system_prompt=spec.system_prompt,
            sampling_params=sampling if spec.kind == "map" else None,
            truncate_rows=self.rec.truncate_rows,
            random_seed_per_input=spec.random_seed_per_input,
            tenant=self.rec.tenant,
        )

    def _load_collected(self, st: _StageState) -> None:
        rows = self.eng.jobs.read_partial(st.id)
        for rid, r in rows.items():
            err = r.get("error")
            st.collected[rid] = {
                "outputs": r.get("outputs"),
                "finish_reason": r.get("finish_reason"),
                "error": err,
            }
            if err is not None:
                st.n_quarantined += 1

    def _load_states(self) -> None:
        from .api import resolve_model

        self.inputs = self.eng.jobs.read_inputs(self.job_id)
        self.est_rows = estimate_stage_rows(self.graph, len(self.inputs))
        for st in self.topo:
            if st.spec.kind == "map":
                st.engine_key = resolve_model(
                    st.spec.model or self.rec.model
                )[0]
            st.rec = self._ensure_stage_rec(st)
            if st.rec.status == JobStatus.SUCCEEDED.value:
                st.complete = True
                self._load_collected(st)

    # -- rollup / progress ---------------------------------------------

    def _rollup(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for st in self.topo:
            if st.complete:
                status = "succeeded"
                done = len(st.collected)
            elif st.cancelled:
                status = "cancelled"
                done = len(st.collected)
            elif st.sess is not None:
                status = "running"
                done = len(st.sess.done)
            else:
                status = "pending"
                done = 0
            total = (
                st.rec.num_rows
                if st.complete or (st.rec and st.rec.num_rows)
                else self.est_rows.get(st.name, 0)
            )
            out[st.name] = {
                "status": status,
                "kind": st.spec.kind,
                "rows_done": int(done),
                "rows_total": int(total),
                "quarantined": int(st.n_quarantined),
            }
        return out

    def _publish_rollup(self, durable: bool = False) -> None:
        roll = self._rollup()
        self.jm.stages(roll)
        if durable:
            try:
                self.eng.jobs.update(self.job_id, stages_state=roll)
            except Exception:  # graftlint: disable=silent-except
                pass  # progress is advisory; the run must not die on it

    # -- streaming handoff ---------------------------------------------

    def _quarantine_fed_row(
        self, st: _StageState, rid: int, msg: str
    ) -> None:
        """Feed-time quarantine (tokenize fault or upstream drop): the
        row lands in the stage's partial store as an error row without
        ever reaching the scheduler — dense row ids are preserved so
        the merge-on-read finalizer sees no gaps."""
        sess = st.sess
        sess.done[rid] = "error"
        sess.pending_flush.append(
            {"row_id": rid, "outputs": None, "cumulative_logprobs": 0.0,
             "gen_tokens": 0, "finish_reason": "error", "error": msg}
        )
        st.collected[rid] = {
            "outputs": None, "finish_reason": "error", "error": msg,
        }
        st.outbox.append((rid, st.collected[rid]))
        st.n_quarantined += 1
        if self._tel_on:
            telemetry.STAGE_ROWS_TOTAL.inc(1.0, st.name)
            telemetry.ROWS_TOTAL.inc(1.0, "quarantined")

    def _drop_row(self, st: _StageState, rid: int, src: str) -> None:
        """Row quarantine scoped per stage: an upstream-quarantined
        row drops out of this stage (no LM call), recorded in the
        PARENT job's failure_log."""
        if rid in st.fed:
            return
        st.fed.add(rid)
        msg = f"upstream row quarantined in stage {src!r}"
        self.eng.jobs.append_failure_log(
            self.job_id,
            {"event": "stage_row_skipped", "stage": st.name,
             "source_stage": src, "row_id": int(rid), "error": msg},
        )
        if rid in st.sess.done:
            return  # resumed: the placeholder already landed
        self._quarantine_fed_row(st, rid, msg)

    def _feed_rows(
        self, st: _StageState, rows: List[Tuple[int, str]]
    ) -> None:
        """Tokenize-and-admit upstream outputs into a held-open map
        stage ctx. Runs on the engine worker thread (inside run_multi's
        callback graph), so appending to ctx.pending is safe. Uses the
        same batched chat encode as a plain submit — prompt ids, and so
        results at temperature 0, are bit-identical to the client-side
        equivalent job."""
        todo = [(rid, txt) for rid, txt in rows if rid not in st.fed]
        if not todo:
            return
        st.fed.update(rid for rid, _ in todo)
        if st.t_first_feed is None:
            st.t_first_feed = time.monotonic() - self.t0
        from .tokenizer import encode_chat_batch

        sess = st.sess
        eng = self.eng
        mcfg = self._mcfg_for(st)
        rendered = [st.render(txt) for _, txt in todo]
        encoded: List[Tuple[int, Optional[List[int]], Optional[str]]] = []
        try:
            if faults.ACTIVE is not None:
                for rid, _ in todo:
                    faults.inject("tokenizer.encode", row=rid, job=st.id)
            ids_list = encode_chat_batch(
                sess.tok, rendered,
                st.rec.system_prompt, mcfg.chat_template,
                threads=eng.ecfg.tokenize_threads,
            )
            encoded = [
                (rid, ids, None)
                for (rid, _), ids in zip(todo, ids_list)
            ]
        except Exception:  # noqa: BLE001 — row isolation: per-row retry
            for (rid, _), text in zip(todo, rendered):
                try:
                    if faults.ACTIVE is not None:
                        faults.inject(
                            "tokenizer.encode", row=rid, job=st.id
                        )
                    encoded.append(
                        (rid,
                         encode_chat_batch(
                             sess.tok, [text], st.rec.system_prompt,
                             mcfg.chat_template,
                         )[0],
                         None)
                    )
                except Exception as e:  # noqa: BLE001 — quarantine row
                    encoded.append((rid, None, f"{type(e).__name__}: {e}"))
        sampling = st.rec.sampling_params or {}
        for rid, ids, err in encoded:
            if err is not None:
                if rid not in sess.done:
                    sess.on_row_event(
                        {"event": "row_quarantined", "row_id": rid,
                         "attempt": 0, "error": err}
                    )
                    self._quarantine_fed_row(st, rid, err)
                continue
            sess.input_tokens += len(ids)
            if rid in sess.done:
                continue  # resume: the row's result is already durable
            sess.ctx.pending.append(
                GenRequest(
                    row_id=rid,
                    prompt_ids=np.array(ids, np.int32),
                    max_new_tokens=st.max_new,
                    temperature=float(
                        sampling.get("temperature", eng.ecfg.temperature)
                    ),
                    top_p=float(sampling.get("top_p", eng.ecfg.top_p)),
                    top_k=int(sampling.get("top_k", eng.ecfg.top_k)),
                    constraint_factory=st.constraint_factory,
                    allow_truncate=st.rec.truncate_rows,
                    row_seed=(
                        rid if st.rec.random_seed_per_input else None
                    ),
                    stop_seqs=sess.stop_seqs,
                    presence_penalty=float(
                        sampling.get("presence_penalty", 0.0)
                    ),
                    frequency_penalty=float(
                        sampling.get("frequency_penalty", 0.0)
                    ),
                    repetition_penalty=float(
                        sampling.get("repetition_penalty", 1.0)
                    ),
                )
            )

    def _mcfg_for(self, st: _StageState):
        from .api import resolve_model

        return resolve_model(st.spec.model or self.rec.model)[1]

    def _pump(self, st: _StageState) -> None:
        """Hand newly-landed rows to downstream consumers: flush this
        stage's partial chunks first (the durability frontier moves
        upstream-first), then feed every in-wave map child. Conflated
        per-stage progress rides the metrics bus's 'stages' channel."""
        batch, st.outbox = st.outbox, []
        if batch and st.sess is not None:
            st.sess.flush()
        if batch:
            ok = [
                (rid, row["outputs"])
                for rid, row in batch
                if row["error"] is None and row["outputs"] is not None
            ]
            for child_spec in self.graph.children(st.name):
                child = self.stages[child_spec.name]
                if child.sess is None or child.complete:
                    continue  # host stages and other-wave stages wait
                for rid, row in batch:
                    if row["error"] is not None or row["outputs"] is None:
                        self._drop_row(child, rid, st.name)
                self._feed_rows(child, ok)
        self._publish_rollup(durable=bool(batch))

    def _mk_on_result(self, st: _StageState):
        sess = st.sess
        from .api import _PARTIAL_FLUSH_EVERY

        def on_result(res) -> None:
            # keep the row inspectable after sess.on_result: pre-flush
            # just below the threshold so the append never auto-clears
            if len(sess.pending_flush) >= _PARTIAL_FLUSH_EVERY - 1:
                sess.flush()
            sess.on_result(res)
            row = sess.pending_flush[-1]
            rid = int(row["row_id"])
            st.collected[rid] = {
                "outputs": row["outputs"],
                "finish_reason": row["finish_reason"],
                "error": row["error"],
            }
            st.outbox.append((rid, st.collected[rid]))
            if row["error"] is not None:
                st.n_quarantined += 1
            if st.t_first is None:
                st.t_first = time.monotonic() - self.t0
            if self._tel_on:
                telemetry.STAGE_ROWS_TOTAL.inc(1.0, st.name)
            st.since_feed += 1
            if st.since_feed >= self.feed_every:
                st.since_feed = 0
                self._pump(st)

        return on_result

    # -- host stages ----------------------------------------------------

    def _run_host_stage(self, st: _StageState) -> None:
        eng = self.eng
        parent = self.stages[st.spec.parent]
        eng.jobs.set_status(st.id, JobStatus.RUNNING)
        ordered = [
            (rid, row["outputs"])
            for rid, row in sorted(parent.collected.items())
            if row["error"] is None and row["outputs"] is not None
        ]
        outs = run_host_stage_kind(st.spec, ordered)
        rows = [
            {"row_id": i, "outputs": o, "cumulative_logprobs": 0.0,
             "gen_tokens": 0, "finish_reason": "stop", "error": None}
            for i, o in enumerate(outs)
        ]
        if rows:
            eng.jobs.flush_partial(st.id, rows)
        st.rec = eng.jobs.update(st.id, num_rows=len(rows))
        eng.jobs.write_results_streamed(st.id, len(rows))
        eng.jobs.set_status(st.id, JobStatus.SUCCEEDED)
        st.collected = {
            r["row_id"]: {
                "outputs": r["outputs"],
                "finish_reason": "stop", "error": None,
            }
            for r in rows
        }
        st.complete = True
        st.t_done = time.monotonic() - self.t0
        if self._tel_on:
            telemetry.STAGE_ROWS_TOTAL.inc(float(len(rows)), st.name)
        self._after_stage_complete(st)

    def _after_stage_complete(self, st: _StageState) -> None:
        """Wire a freshly-completed stage into its consumers: release
        in-wave holds, feed completed output wholesale, run ready host
        children, and copy the sink into the parent job."""
        for child_spec in self.graph.children(st.name):
            child = self.stages[child_spec.name]
            if child.complete:
                continue
            if child_spec.kind == "map":
                if child.sess is not None:
                    for rid, row in sorted(st.collected.items()):
                        if row["error"] is not None or row["outputs"] is None:
                            self._drop_row(child, rid, st.name)
                    self._feed_rows(
                        child,
                        [
                            (rid, row["outputs"])
                            for rid, row in sorted(st.collected.items())
                            if row["error"] is None
                            and row["outputs"] is not None
                        ],
                    )
                    child.upstream_done = True
                # other-wave map children are fed at their wave's start
            else:
                self._run_host_stage(child)
        if st.name == self.graph.sink:
            self._copy_sink(st)
        self._publish_rollup(durable=True)

    def _copy_sink(self, st: _StageState) -> None:
        """The sink stage's durable rows become the parent job's rows:
        copied chunk-store to chunk-store (idempotent — re-copy after a
        crash lands a higher seq; later-seq-wins dedup keeps results
        exact). The parent then finalizes through the same
        merge-on-read writer as a plain job."""
        eng = self.eng
        rows = eng.jobs.read_partial(st.id)
        ordered = [dict(rows[rid]) for rid in sorted(rows)]
        if ordered:
            eng.jobs.flush_partial(self.job_id, ordered)
        self.n_rows = len(ordered)
        self.rec.num_rows = self.n_rows
        eng.jobs.update(self.job_id, num_rows=self.n_rows)
        self.jm.progress(self.n_rows)

    # -- scheduler session ---------------------------------------------

    def _build_stage_session(
        self, st: _StageState, engine_key: str, mcfg, meta, tok, seq: int
    ) -> None:
        from .api import _GenSession

        eng = self.eng
        spec = st.spec
        root = spec.parent is None
        d = eng.jobs._dir(st.id)
        if not (d / "inputs.jsonl").exists():
            if root:
                eng.jobs.write_inputs(
                    st.id, [st.render(x) for x in self.inputs]
                )
            else:
                # deferred: rows arrive by feed; the empty inputs file
                # just satisfies the session constructor (resume
                # re-derives fed rows from the upstream partial store)
                eng.jobs.write_inputs(st.id, [])
        eng.jobs.set_status(st.id, JobStatus.STARTING)
        sess = _GenSession(
            eng, st.id, st.rec, engine_key, mcfg, meta, tok, seq=seq
        )
        sess.session_job = self.job_id
        eng.jobs.set_status(st.id, JobStatus.RUNNING)
        st.sess = sess
        st.max_new = int(
            (st.rec.sampling_params or {}).get(
                "max_new_tokens", eng.ecfg.max_new_tokens
            )
        )
        st.constraint_factory = None
        if st.rec.output_schema:
            from .constrain import schema_constraint_factory

            st.constraint_factory = schema_constraint_factory(
                st.rec.output_schema, tok
            )
        # resumed rows: already durable — never re-fed, and their
        # outputs stream to children from the partial store
        st.fed = set(sess.done)
        if sess.done:
            self._load_collected(st)
            st.outbox = list(sorted(st.collected.items()))
        sess.ctx.on_result = self._mk_on_result(st)
        sess.ctx.should_cancel = self._should_cancel
        if root:
            st.upstream_done = True
        else:
            st.upstream_done = False
            sess.ctx.hold_open = lambda s=st: not s.upstream_done

    def _should_cancel(self) -> bool:
        if self.job_id in self.eng._cancel:
            self.cancelled = True
            return True
        return False

    def _on_job_done(self, ctx, outcome: str) -> None:
        st = self.by_id[ctx.job_id]
        sess = st.sess
        if sess.jtel is not None and (
            ctx.prefix_saved or ctx.prefix_paid
        ):
            sess.jtel.attrs["prefix"] = {
                "saved_tokens": int(ctx.prefix_saved),
                "paid_tokens": int(ctx.prefix_paid),
            }
        self.prefix_saved += int(ctx.prefix_saved)
        self.prefix_paid += int(ctx.prefix_paid)
        if outcome != "completed":
            sess.finalize_cancelled()
            sess.finalized = True
            st.cancelled = True
            self.cancelled = True
            self._publish_rollup(durable=True)
            return
        self._pump(st)  # final drain to in-wave children
        st.rec.num_rows = len(sess.done)
        self.eng.jobs.update(st.id, num_rows=st.rec.num_rows)
        sess.finalize_completed(self.batcher)
        sess.finalized = True
        st.complete = True
        st.t_done = time.monotonic() - self.t0
        self._after_stage_complete(st)

    def _run_wave(self, wave: List[_StageState]) -> Optional[str]:
        from .api import resolve_model
        from .scheduler import ContinuousBatcher

        eng = self.eng
        engine_key = wave[0].engine_key
        _, mcfg0, _ = resolve_model(wave[0].spec.model or self.rec.model)
        runner, tok = eng._get_runner(engine_key, mcfg0)
        self.wave = wave
        for k, st in enumerate(wave):
            _, mcfg, meta = resolve_model(
                st.spec.model or self.rec.model
            )
            self._build_stage_session(st, engine_key, mcfg, meta, tok, k)
        batcher = ContinuousBatcher(
            runner,
            stop_ids=getattr(tok, "stop_ids", lambda: [tok.eos_id])(),
            seed=eng.ecfg.seed,
            token_bytes=wave[0].sess.token_bytes,
            prefix_store=eng._prefix_store_for(engine_key),
            kv_tier=eng._kv_tier_for(engine_key),
        )
        if eng.control is not None:
            batcher.ladder = eng.control.ladder
        self.batcher = batcher
        # wave start: stages whose upstream already finished (earlier
        # wave, host stage, or resume) get their full input up front
        for st in wave:
            p = st.spec.parent
            if p is not None and self.stages[p].complete:
                self._after_stage_complete_feed_one(st)
        for st in wave:
            self._pump(st)  # drain resume-preloaded outboxes downstream
        self._publish_rollup(durable=True)

        def should_yield() -> bool:
            return eng._unattachable_higher_waiting(
                int(self.rec.job_priority or 0), engine_key
            )

        try:
            state = batcher.run_multi(
                [st.sess.ctx for st in wave],
                on_job_done=self._on_job_done,
                should_yield=should_yield,
            )
        except Exception:
            for st in wave:
                if st.sess is not None and not st.sess.finalized:
                    try:
                        st.sess.flush()
                    except Exception:  # noqa: BLE001 — best-effort flush
                        logger.warning(
                            "stage partial flush failed for %s",
                            st.id, exc_info=True,
                        )
            raise
        finally:
            self.wave = []
        if state == "yielded":
            for st in wave:
                if st.sess is not None and not st.sess.finalized:
                    st.sess.flush()
                    self.eng.jobs.set_status(st.id, JobStatus.QUEUED)
            return "yielded"
        return None

    def _after_stage_complete_feed_one(self, st: _StageState) -> None:
        """Feed one just-built wave stage from its already-complete
        parent (completed in an earlier wave / host pass / prior run)."""
        parent = self.stages[st.spec.parent]
        for rid, row in sorted(parent.collected.items()):
            if row["error"] is not None or row["outputs"] is None:
                self._drop_row(st, rid, parent.name)
        self._feed_rows(
            st,
            [
                (rid, row["outputs"])
                for rid, row in sorted(parent.collected.items())
                if row["error"] is None and row["outputs"] is not None
            ],
        )
        st.upstream_done = True

    def _next_wave(self, maps: List[_StageState]) -> List[_StageState]:
        key = maps[0].engine_key
        wave: List[_StageState] = []
        names: Set[str] = set()
        for st in maps:
            if st.engine_key != key:
                continue
            ok = True
            cur = st.spec.parent
            while cur is not None:
                anc = self.stages[cur]
                if anc.spec.kind == "map":
                    if not (anc.complete or anc.name in names):
                        ok = False
                    break  # nearest map ancestor decides
                if not (anc.complete or anc.name in names or (
                    anc.spec.parent is not None
                )):
                    ok = False
                    break
                cur = anc.spec.parent
            if ok:
                wave.append(st)
                names.add(st.name)
        return wave

    # -- run --------------------------------------------------------------

    def run(self) -> Optional[int]:
        eng, job_id = self.eng, self.job_id
        if self.rec.dry_run:
            # price the whole DAG: exact tokenize of the root prompts,
            # byte bounds for downstream stage inputs (their prompts
            # don't exist yet), estimated rows x max_new on output
            from .api import resolve_model
            from .tokenizer import encode_chat_batch

            inputs = eng.jobs.read_inputs(job_id)
            default_new = int(
                (self.rec.sampling_params or {}).get(
                    "max_new_tokens", eng.ecfg.max_new_tokens
                )
            )
            est = estimate_stage_rows(self.graph, len(inputs))
            in_tok = 0
            est_out = 0
            for st in self.topo:
                if st.spec.kind != "map":
                    continue
                engine_key, mcfg, _ = resolve_model(
                    st.spec.model or self.rec.model
                )
                max_new = int(
                    st.spec.sampling_params.get(
                        "max_new_tokens", default_new
                    )
                )
                est_out += est[st.name] * max_new
                if st.spec.parent is None:
                    tok = eng._get_tokenizer(engine_key, mcfg)
                    in_tok += sum(
                        len(ids)
                        for ids in encode_chat_batch(
                            tok,
                            [st.render(x) for x in inputs],
                            st.spec.system_prompt,
                            mcfg.chat_template,
                            threads=eng.ecfg.tokenize_threads,
                        )
                    )
            extra_in, _ = graph_cost_bounds(
                self.graph, len(inputs), default_new
            )
            in_tok += extra_in
            cost = estimate_cost(self.rec.engine_key, in_tok, est_out)
            eng.jobs.update(
                job_id, cost_estimate=cost, input_tokens=in_tok
            )
            eng.jobs.set_status(job_id, JobStatus.SUCCEEDED)
            return None
        self.t0 = time.monotonic()
        self._load_states()
        self._publish_rollup(durable=True)
        # host stages already unblocked by a previous run
        for st in self.topo:
            if (
                st.spec.kind != "map"
                and not st.complete
                and self.stages[st.spec.parent].complete
            ):
                self._run_host_stage(st)
        while not self.cancelled:
            maps = [
                st for st in self.topo
                if st.spec.kind == "map" and not st.complete
            ]
            if not maps:
                break
            wave = self._next_wave(maps)
            if not wave:
                raise RuntimeError(
                    "stage graph made no progress (unreachable map "
                    "stages?)"
                )
            out = self._run_wave(wave)
            if out == "yielded":
                self._publish_rollup(durable=True)
                return int(self.rec.job_priority or 0)
        if self.cancelled:
            for st in self.topo:
                if st.sess is not None and not st.sess.finalized:
                    st.sess.flush()
            self._publish_rollup(durable=True)
            eng.jobs.set_status(job_id, JobStatus.CANCELLED)
            self._drop_stage_metrics()
            return None
        # a sink that completed on a PREVIOUS run but never copied
        sink = self.stages[self.graph.sink]
        if self.n_rows == 0 and sink.complete:
            self._copy_sink(sink)
        self._finalize_parent()
        self._drop_stage_metrics()
        return None

    def _drop_stage_metrics(self) -> None:
        for st in self.topo:
            self.eng.metrics.drop(st.id)

    def _finalize_parent(self) -> None:
        eng, job_id = self.eng, self.job_id
        eng.jobs.write_results_streamed(job_id, self.n_rows)
        in_tok = out_tok = 0
        cost = 0.0
        for st in self.topo:
            if st.spec.kind != "map":
                continue
            r = eng.jobs.get(st.id)
            in_tok += int(r.input_tokens or 0)
            out_tok += int(r.output_tokens or 0)
            cost += float(r.job_cost or 0.0)
        perf = (
            dict(self.batcher.timer.summary())
            if self.batcher is not None
            else None
        )
        roll = self._rollup()
        if self.jtel is not None:
            self.jtel.set("input_tokens", in_tok)
            self.jtel.set("output_tokens", out_tok)
            # the doctor's stage_starved evidence + the acceptance
            # criterion's streaming-admission observable: a downstream
            # stage's first_result_s strictly before its upstream's
            # done_s proves no full-stage barrier
            self.jtel.attrs["stages"] = {
                st.name: {
                    "rows": int(len(st.collected)),
                    "quarantined": int(st.n_quarantined),
                    "first_result_s": (
                        round(st.t_first, 4)
                        if st.t_first is not None else None
                    ),
                    "done_s": (
                        round(st.t_done, 4)
                        if st.t_done is not None else None
                    ),
                    "starved_s": (
                        round(st.t_first_feed, 4)
                        if st.spec.parent is not None
                        and st.spec.kind == "map"
                        and st.t_first_feed is not None
                        else 0.0
                    ),
                }
                for st in self.topo
            }
            if self.prefix_saved or self.prefix_paid:
                self.jtel.attrs["prefix"] = {
                    "saved_tokens": int(self.prefix_saved),
                    "paid_tokens": int(self.prefix_paid),
                }
        eng.jobs.update(
            job_id,
            input_tokens=in_tok,
            output_tokens=out_tok,
            job_cost=cost or estimate_cost(
                self.rec.engine_key, in_tok, out_tok
            ),
            perf=perf,
            stages_state=roll,
        )
        self.jm.stages(roll)
        self.jm.progress(self.n_rows)
        eng.jobs.set_status(job_id, JobStatus.SUCCEEDED)
