"""Telemetry label-cardinality pass.

The metrics registry bounds every labelled metric's series count and
collapses overflow to ``("_overflow", ...)`` — but the *static* intent
matters too: a label whose values come from an unbounded domain (job
ids, row ids, request ids) churns the cap and destroys the series you
actually wanted, silently. Rule ``telemetry-cardinality``:

- a metric op (``.inc``/``.set``/``.observe``) passing a **non-constant
  label value** is only allowed when the metric's declaration carries
  an explicit ``max_series=`` — the declared fixed-cardinality
  whitelist budget (key ``<metric>:uncapped``);
- an **identifier-shaped** label value (``job_id``/``row_id``/
  ``req_id``-style names, f-strings, ``str(...)`` of a variable) is
  flagged even on capped metrics — identifiers never become labels,
  per-job numbers belong in JobCounters (key ``<metric>:identifier``).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional

from .callgraph import ModuleInfo, PackageIndex, dotted
from .core import Finding

_DECL_METHODS = ("counter", "gauge", "histogram")
_OPS = ("inc", "set", "observe")
_IDENT_RE = re.compile(
    r"(^|_)(job|row|req|request|trace|span)_?id$|^rid$|^uuid$", re.I
)


@dataclasses.dataclass
class _Decl:
    metric: str
    var: str
    labelled: bool
    capped: bool
    module: str
    line: int


def _collect_decls(index: PackageIndex) -> Dict[str, _Decl]:
    decls: Dict[str, _Decl] = {}
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if not isinstance(value, ast.Call):
                continue
            t = dotted(value.func) or ""
            if t.rsplit(".", 1)[-1] not in _DECL_METHODS or "." not in t:
                continue
            if not (
                value.args
                and isinstance(value.args[0], ast.Constant)
                and isinstance(value.args[0].value, str)
            ):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            names = [x.id for x in targets if isinstance(x, ast.Name)]
            if not names:
                continue
            kw = {k.arg: k.value for k in value.keywords if k.arg}
            labelled = "labels" in kw and not (
                isinstance(kw["labels"], (ast.Tuple, ast.List))
                and not kw["labels"].elts
            )
            decl = _Decl(
                metric=value.args[0].value,
                var=names[0],
                labelled=labelled,
                capped="max_series" in kw,
                module=mod.name,
                line=node.lineno,
            )
            prev = decls.get(names[0])
            if prev is not None and prev.capped and not decl.capped:
                decls[names[0]] = decl  # conservative: uncapped wins
            elif prev is None:
                decls[names[0]] = decl
    return decls


def _identifier_shaped(arg: ast.AST) -> Optional[str]:
    if isinstance(arg, ast.JoinedStr):
        return "f-string"
    if isinstance(arg, ast.Name) and _IDENT_RE.search(arg.id):
        return arg.id
    if isinstance(arg, ast.Attribute) and _IDENT_RE.search(arg.attr):
        return arg.attr
    if isinstance(arg, ast.Call):
        t = dotted(arg.func)
        if t == "str" and arg.args and not isinstance(
            arg.args[0], ast.Constant
        ):
            return "str(...)"
        if t is not None and t.endswith(".format"):
            return "format(...)"
    return None


def run(index: PackageIndex) -> List[Finding]:
    decls = _collect_decls(index)
    out: List[Finding] = []
    for mod in index.modules.values():
        for func in mod.functions.values():
            for n in ast.walk(func.node):
                if not isinstance(n, ast.Call):
                    continue
                t = dotted(n.func) or ""
                parts = t.split(".")
                if len(parts) < 2 or parts[-1] not in _OPS:
                    continue
                decl = decls.get(parts[-2])
                if decl is None:
                    continue
                labels = n.args[1:]
                for arg in labels:
                    ident = _identifier_shaped(arg)
                    if ident is not None:
                        out.append(
                            Finding(
                                rule="telemetry-cardinality",
                                path=func.module.path,
                                line=n.lineno,
                                message=f"identifier-shaped label value "
                                f"({ident}) on metric "
                                f"`{decl.metric}` — unbounded identifiers "
                                "never become labels (use JobCounters)",
                                symbol=func.label,
                                key=f"{decl.metric}:identifier",
                            )
                        )
                    elif not isinstance(arg, ast.Constant) and not decl.capped:
                        out.append(
                            Finding(
                                rule="telemetry-cardinality",
                                path=func.module.path,
                                line=n.lineno,
                                message=f"non-constant label value on "
                                f"metric `{decl.metric}` whose declaration "
                                "has no explicit max_series= cardinality "
                                "whitelist budget",
                                symbol=func.label,
                                key=f"{decl.metric}:uncapped",
                            )
                        )
    return out
