"""Render traces (and whole-job flight records) as Chrome trace-event
JSON — the format Perfetto (https://ui.perfetto.dev) and
chrome://tracing load directly. A copy of
``sutro_tpu/telemetry/traceexport.py``.

Two inputs, one output:

- a per-request trace document from :mod:`.traces` (``sutro trace
  <trace_id>``) — one process, one lane per stage family, so the
  admission→queue→prefill→decode→flush waterfall reads left to right;
- a whole-job telemetry document from :func:`telemetry.job_doc`
  (``sutro trace <job_id>``) — the flight recorder's spans for that
  job, same lane layout.

The rendering is pure and deterministic (sorted keys, stable lane
assignment, microsecond integers) so the export is golden-pinnable.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

# Lane (Chrome "tid") per span-name family, in waterfall order. Spans
# whose name has no family land in the overflow lane after these.
_LANES = (
    ("admit", ("admit_gateway", "admit")),
    ("queue", ("queue_wait",)),
    ("prefill", ("prefill", "prefix_hit", "prefix_extend")),
    (
        "decode",
        ("decode_window", "decode_fetch", "accept", "preempt_suspend",
         "resume"),
    ),
    ("stream", ("stream_flush", "first_token", "finish")),
)

_PID = 1

# Router-process lanes for stitched fleet traces (fleet/router.py spans)
# — the front door's waterfall: pick -> probe -> connect -> first byte.
_ROUTER_LANES = (
    ("route", ("route_pick", "affinity_probe", "retry_failover")),
    ("upstream", ("upstream_connect", "first_byte")),
)


def _lane_of(name: str) -> int:
    for i, (_, members) in enumerate(_LANES):
        if name in members:
            return i
    return len(_LANES)


def _lane_in(name: str, lanes) -> int:
    for i, (_, members) in enumerate(lanes):
        if name in members:
            return i
    return len(lanes)


def _us(seconds: float) -> int:
    return int(round(seconds * 1e6))


def trace_to_chrome(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Per-request trace document -> Chrome trace-event JSON dict."""
    events: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": _PID,
            "tid": 0,
            "name": "process_name",
            "args": {
                "name": "{} {}".format(
                    doc.get("kind", "trace"), doc["trace_id"]
                )
            },
        }
    ]
    lanes_used = set()
    for span in doc.get("spans", ()):
        tid = _lane_of(span["name"])
        lanes_used.add(tid)
        ev: Dict[str, Any] = {
            "ph": "X",
            "pid": _PID,
            "tid": tid,
            "name": span["name"],
            "ts": _us(span["t0_s"]),
            # Perfetto renders dur=0 slices invisibly; give instants
            # one tick so suspend/hit markers stay clickable.
            "dur": max(_us(span["dur_s"]), 1),
        }
        if span.get("attrs"):
            ev["args"] = dict(span["attrs"])
        events.append(ev)
    for i, (lane_name, _) in enumerate(_LANES):
        if i in lanes_used:
            events.append(
                {
                    "ph": "M",
                    "pid": _PID,
                    "tid": i,
                    "name": "thread_name",
                    "args": {"name": lane_name},
                }
            )
    if len(_LANES) in lanes_used:
        events.append(
            {
                "ph": "M",
                "pid": _PID,
                "tid": len(_LANES),
                "name": "thread_name",
                "args": {"name": "other"},
            }
        )
    out: Dict[str, Any] = {
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": doc["trace_id"],
            "kind": doc.get("kind"),
            "outcome": doc.get("outcome"),
            "dropped": doc.get("dropped", 0),
        },
        "traceEvents": events,
    }
    if doc.get("attrs"):
        out["otherData"]["attrs"] = dict(doc["attrs"])
    return out


def job_doc_to_chrome(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Whole-job telemetry document (telemetry.job_doc) -> Chrome
    trace-event JSON: the flight-recorder spans become complete events
    in the same lane layout."""
    job_id = doc.get("job_id", "?")
    events: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": _PID,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "job {}".format(job_id)},
        }
    ]
    lanes_used = set()
    for span in doc.get("spans", ()):
        name = span.get("name", "?")
        tid = _lane_of(name)
        lanes_used.add(tid)
        ev: Dict[str, Any] = {
            "ph": "X",
            "pid": _PID,
            "tid": tid,
            "name": name,
            "ts": _us(span.get("t0_s", 0.0)),
            "dur": max(_us(span.get("dur_s", 0.0)), 1),
        }
        if span.get("attrs"):
            ev["args"] = dict(span["attrs"])
        events.append(ev)
    for i, (lane_name, _) in enumerate(_LANES):
        if i in lanes_used:
            events.append(
                {
                    "ph": "M",
                    "pid": _PID,
                    "tid": i,
                    "name": "thread_name",
                    "args": {"name": lane_name},
                }
            )
    if len(_LANES) in lanes_used:
        events.append(
            {
                "ph": "M",
                "pid": _PID,
                "tid": len(_LANES),
                "name": "thread_name",
                "args": {"name": "other"},
            }
        )
    return {
        "displayTimeUnit": "ms",
        "otherData": {"job_id": job_id},
        "traceEvents": events,
    }


def stitched_to_chrome(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Stitched fleet trace document (fleet/obs.py ``stitch_trace``)
    -> Chrome trace-event JSON with one *process* lane group per
    participating process: the router is pid 1 with its own lane
    family (route/upstream), each replica gets the standard engine
    waterfall lanes under pid 2+. Every span's start offset is on the
    ROUTER's clock — the stitcher already re-anchored replica spans by
    wall-clock skew (round-10 ``ingest_remote`` convention), so the
    handoff reads left to right across process lanes in Perfetto."""
    events: List[Dict[str, Any]] = []
    for pidx, proc in enumerate(doc.get("processes", ())):
        pid = pidx + 1
        pdoc = proc.get("doc") or {}
        t_off = float(proc.get("t_off_s") or 0.0)
        lanes = _ROUTER_LANES if proc.get("role") == "router" else _LANES
        events.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "process_name",
                "args": {"name": proc.get("process", f"p{pid}")},
            }
        )
        lanes_used = set()
        for span in pdoc.get("spans", ()):
            name = span.get("name", "?")
            tid = _lane_in(name, lanes)
            lanes_used.add(tid)
            ev: Dict[str, Any] = {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "name": name,
                "ts": _us(span.get("t0_s", 0.0) + t_off),
                "dur": max(_us(span.get("dur_s", 0.0)), 1),
            }
            if span.get("attrs"):
                ev["args"] = dict(span["attrs"])
            events.append(ev)
        for i, (lane_name, _) in enumerate(lanes):
            if i in lanes_used:
                events.append(
                    {
                        "ph": "M",
                        "pid": pid,
                        "tid": i,
                        "name": "thread_name",
                        "args": {"name": lane_name},
                    }
                )
        if len(lanes) in lanes_used:
            events.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "tid": len(lanes),
                    "name": "thread_name",
                    "args": {"name": "other"},
                }
            )
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": doc.get("trace_id"),
            "kind": doc.get("kind", "fleet"),
            "processes": [
                p.get("process") for p in doc.get("processes", ())
            ],
        },
        "traceEvents": events,
    }


def stitched_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a stitched fleet trace document into one merged span
    list on the router's clock, sorted by start — what the acceptance
    test walks to assert the cross-process handoff has no negative
    gaps after skew re-anchoring."""
    out: List[Dict[str, Any]] = []
    for proc in doc.get("processes", ()):
        pdoc = proc.get("doc") or {}
        t_off = float(proc.get("t_off_s") or 0.0)
        for span in pdoc.get("spans", ()):
            out.append(
                {
                    "name": span.get("name", "?"),
                    "t0_s": round(span.get("t0_s", 0.0) + t_off, 6),
                    "dur_s": span.get("dur_s", 0.0),
                    "process": proc.get("process"),
                }
            )
    out.sort(key=lambda s: (s["t0_s"], s["name"]))
    return out


def render(chrome_doc: Dict[str, Any]) -> str:
    """Deterministic JSON text for files/goldens (sorted keys,
    2-space indent, trailing newline)."""
    return json.dumps(chrome_doc, indent=2, sort_keys=True) + "\n"


def largest_gap_s(doc: Dict[str, Any]) -> float:
    """Largest uncovered stretch between consecutive span starts in a
    per-request trace document — the acceptance criterion's
    "no gaps > one decode window" measure."""
    spans = doc.get("spans", ())
    if not spans:
        return 0.0
    covered_until = None
    worst = 0.0
    for span in spans:  # already sorted by t0_s
        t0 = span["t0_s"]
        t1 = t0 + span["dur_s"]
        if covered_until is None:
            covered_until = t1
            continue
        if t0 > covered_until:
            worst = max(worst, t0 - covered_until)
        covered_until = max(covered_until, t1)
    return worst
