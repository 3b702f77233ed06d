"""Trace-context pass: a started trace span must be ended on every path.

The forensics trace store (``telemetry/traces.py``) hands out ``Trace``
handles from ``start_trace``; a handle that is never ``end()``-ed (or
``end_trace``-d by id) leaves the trace permanently unfinished — it
still renders, but the doctor grades it ``insufficient_data``-adjacent
and the ring holds a request that looks in-flight forever. The naming
contract (documented on :mod:`..telemetry.traces`) makes this a
resource-lifecycle problem:

- acquire: ``tr = <anything>.start_trace(...)`` — *binding* the handle
  takes ownership of ending it in this function;
- release: ``tr.end(...)`` or ``<store>.end_trace(tr)``.

Sites that start and end a trace in *different* functions (the gateway
starts, ``finish()`` ends) use a BARE ``start_trace(...)`` call and key
the handoff by the trace_id string — the pass tracks bound handles
only, so cross-function propagation is clean by design.

Rule: ``trace-ctx-dropped``. The engine is the parameterized
acquire/release walker from :mod:`.resources` — same escape rules
(arg-pass, attribute/subscript store, closure capture, rebind, yield,
``is None`` refinement), same implicit-exception-edge gating (only
functions that end a trace somewhere get exception-path findings).

Fleet sub-pass (same rule, ``fleet-fwd:`` keys): over ``fleet/``
modules only, a function that binds a trace id from ``trace_begin``
(``tid = obs.trace_begin(...)`` — fleet/obs.py's router-ring variant,
which returns an ID STRING, not a handle, so the resource walker's
end() discipline doesn't apply) AND talks upstream must forward the id
— as a ``trace_id=`` keyword/argument to the upstream helper, or by
writing the ``X-Sutro-Trace`` header itself. A handler that opens a
router trace but relays without the header silently loses the replica
half of every cross-process stitch: the request still works, the
``GET /trace/{id}`` timeline just degrades to router-spans-only, which
is exactly the kind of quiet observability rot a linter should catch.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from .callgraph import PackageIndex, dotted
from .core import Finding
from .resources import Kind, _ResourcePass

TRACE_KINDS: Tuple[Kind, ...] = (
    Kind(
        name="trace-ctx",
        acquire_suffix=(".start_trace",),
        release_method=(".end",),
        release_arg=(".end_trace",),
        release_hint="end()/end_trace()",
    ),
)

#: a callee whose dotted text contains one of these talks to a replica
#: on behalf of the traced request (fleet/router.py `_upstream`)
_UPSTREAM_MARKERS = ("upstream",)
#: the wire header the id must travel in (frames/OBSERVABILITY.md)
_TRACE_HEADER = "X-Sutro-Trace"


def _fleet_forward_findings(index: PackageIndex) -> List[Finding]:
    out: List[Finding] = []
    for mod in index.modules.values():
        if "fleet/" not in mod.path:
            continue
        for func in mod.functions.values():
            node = func.node
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            # bound-name -> line of the trace_begin assignment; only
            # calls lexically in THIS function (nested defs are their
            # own FunctionInfo and get their own walk)
            begun: dict = {}
            upstream_calls: List[ast.Call] = []
            forwarded: set = set()
            own_nodes = [
                n
                for n in ast.walk(node)
                if not isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
                or n is node
            ]
            for n in own_nodes:
                if isinstance(n, ast.Assign) and isinstance(
                    n.value, ast.Call
                ):
                    callee = dotted(n.value.func) or ""
                    if callee.split(".")[-1] == "trace_begin":
                        for tgt in n.targets:
                            if isinstance(tgt, ast.Name):
                                begun[tgt.id] = n.lineno
                if isinstance(n, ast.Call):
                    callee = dotted(n.func) or ""
                    if any(
                        m in callee.lower() for m in _UPSTREAM_MARKERS
                    ):
                        upstream_calls.append(n)
                    # forwarded via trace_id= keyword on ANY call (the
                    # upstream helper, a wrapped sender, gateway.submit)
                    for kw in n.keywords:
                        if kw.arg == "trace_id" and isinstance(
                            kw.value, ast.Name
                        ):
                            forwarded.add(kw.value.id)
                # forwarded by hand: headers["X-Sutro-Trace"] = tid
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Subscript)
                    and isinstance(n.value, ast.Name)
                ):
                    sl = n.targets[0].slice
                    if (
                        isinstance(sl, ast.Constant)
                        and sl.value == _TRACE_HEADER
                    ):
                        forwarded.add(n.value.id)
            if not upstream_calls:
                continue
            # positional pass into an upstream call also forwards
            for call in upstream_calls:
                for arg in call.args:
                    if isinstance(arg, ast.Name) and arg.id in begun:
                        forwarded.add(arg.id)
            for name, line in sorted(begun.items()):
                if name in forwarded:
                    continue
                out.append(
                    Finding(
                        rule="trace-ctx-dropped",
                        path=mod.path,
                        line=line,
                        symbol=func.qualname,
                        key=f"fleet-fwd:{name}",
                        message=(
                            f"'{name}' is bound from trace_begin() but "
                            "never forwarded to the upstream call "
                            f"(trace_id= / {_TRACE_HEADER} header) — "
                            "the replica half of the cross-process "
                            "stitch is silently lost"
                        ),
                    )
                )
    return out


def run(index: PackageIndex) -> List[Finding]:
    findings = _ResourcePass(
        index,
        kinds=TRACE_KINDS,
        leak_rule="trace-ctx-dropped",
        double_rule="trace-ctx-double-end",
    ).run()
    findings.extend(_fleet_forward_findings(index))
    return findings
