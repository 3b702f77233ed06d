"""Thread, exception, and retry hygiene pass.

- ``thread-unjoined``        every ``threading.Thread(...)`` must be
                             ``daemon=True`` or have a ``.join(...)``
                             with a bounded timeout reachable in its
                             module (same variable/attribute name)
- ``thread-unbounded-join``  ``.join()`` on a thread without a timeout
                             wedges teardown forever on a hung thread
- ``silent-except``          ``except Exception:`` / bare ``except:``
                             whose body neither calls anything (no
                             logging), re-raises, nor stores the error
                             — the classic swallowed-failure shape
- ``unbounded-retry``        a retry loop (except-driven re-iteration
                             that sleeps or names attempts) must carry
                             BOTH an attempt/deadline bound and a
                             growing (non-constant) backoff sleep —
                             unbounded or lockstep retries turn one
                             transient fault into a hammering loop
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set

from .callgraph import ModuleInfo, PackageIndex, dotted
from .core import Finding


def _bool_kw(call: ast.Call, name: str) -> Optional[bool]:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return None


def _join_sites(mod: ModuleInfo) -> Dict[str, List[ast.Call]]:
    """receiver text -> ``.join`` calls anywhere in the module."""
    out: Dict[str, List[ast.Call]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        text = dotted(node.func)
        if not text or not text.endswith(".join"):
            continue
        recv = text[: -len(".join")]
        out.setdefault(recv, []).append(node)
    return out


def _join_is_bounded(call: ast.Call) -> bool:
    if call.args:
        return True  # positional timeout
    return any(kw.arg == "timeout" for kw in call.keywords)


def _thread_findings(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for mod in index.modules.values():
        joins = _join_sites(mod)
        # walk every assignment / expression statement for Thread ctors
        for node in ast.walk(mod.tree):
            call: Optional[ast.Call] = None
            target_text: Optional[str] = None
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                call = node.value
                if len(node.targets) == 1:
                    target_text = dotted(node.targets[0])
            elif isinstance(node, ast.Expr) and isinstance(
                node.value, ast.Call
            ):
                # threading.Thread(...).start() — anonymous spawn
                inner = node.value
                f = inner.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "start"
                    and isinstance(f.value, ast.Call)
                ):
                    call = f.value
            if call is None:
                continue
            ctor = dotted(call.func)
            if not ctor or mod.expand(ctor) != "threading.Thread":
                continue
            daemon = _bool_kw(call, "daemon")
            if daemon:
                continue
            name_hint = target_text or "<anonymous>"
            # bounded join anywhere in the module under the same name?
            join_calls = joins.get(target_text or "", [])
            bounded = [c for c in join_calls if _join_is_bounded(c)]
            unbounded = [
                c for c in join_calls if not _join_is_bounded(c)
            ]
            if bounded:
                continue
            if unbounded:
                findings.append(
                    Finding(
                        rule="thread-unbounded-join",
                        path=mod.path,
                        line=unbounded[0].lineno,
                        symbol=f"{mod.name}:{name_hint}",
                        key=name_hint,
                        message=(
                            f"thread `{name_hint}` joined without a "
                            "timeout — a hung thread wedges teardown "
                            "forever"
                        ),
                    )
                )
                continue
            findings.append(
                Finding(
                    rule="thread-unjoined",
                    path=mod.path,
                    line=call.lineno,
                    symbol=f"{mod.name}:{name_hint}",
                    key=name_hint,
                    message=(
                        f"thread `{name_hint}` is neither daemon=True "
                        "nor joined with a bounded timeout"
                    ),
                )
            )
    return findings


_BROAD = {"Exception", "BaseException"}


def _is_silent_body(body: List[ast.stmt]) -> bool:
    """True when the handler body cannot observe/record the error: only
    pass/continue/break, constant-ish returns, or constant-ish
    assignments (no call, no raise, no exception-name use)."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return):
            if stmt.value is None or _constantish(stmt.value):
                continue
            return False
        if isinstance(stmt, ast.Assign):
            if _constantish(stmt.value):
                continue
            return False
        return False
    return True


def _constantish(node: ast.AST) -> bool:
    """Literal-shaped value: no calls, no name loads that could carry
    the error (plain names and literals allowed)."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Call, ast.Await, ast.Yield)):
            return False
    return True


def _except_findings(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for mod in index.modules.values():
        # map handler -> enclosing function for symbols
        enclosing: Dict[int, str] = {}
        for func in mod.functions.values():
            for sub in ast.walk(func.node):
                if isinstance(sub, ast.ExceptHandler):
                    # innermost function wins (walk order: outer first,
                    # later overwrites are the nested functions)
                    enclosing[id(sub)] = func.label
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            caught = "bare"
            if node.type is not None:
                text = dotted(node.type)
                if text is None or text.split(".")[-1] not in _BROAD:
                    continue
                caught = text.split(".")[-1]
            if not _is_silent_body(node.body):
                continue
            body_kind = type(node.body[0]).__name__ if node.body else ""
            findings.append(
                Finding(
                    rule="silent-except",
                    path=mod.path,
                    line=node.lineno,
                    symbol=enclosing.get(id(node), mod.name),
                    key=f"{caught}|{body_kind}",
                    message=(
                        f"broad `except {caught}` swallows the error "
                        "(no log, no re-raise, no classification)"
                    ),
                )
            )
    return findings


# -- unbounded-retry ---------------------------------------------------

_RETRYISH = re.compile(r"attempt|retr|tries|backoff", re.I)
_BOUNDISH = re.compile(
    r"attempt|retr|tries|deadline|budget|remaining|timeout", re.I
)

_LOOP_STOPS = (
    ast.While,
    ast.For,
    ast.FunctionDef,
    ast.AsyncFunctionDef,
    ast.Lambda,
)


def _shallow(nodes: List[ast.stmt]) -> Iterator[ast.AST]:
    """Walk a loop body WITHOUT descending into nested loops or
    function definitions (those are their own retry scopes)."""
    stack: List[ast.AST] = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _LOOP_STOPS):
                continue
            stack.append(child)


def _names_in(node: ast.AST) -> Iterator[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _handler_reiterates(handler: ast.ExceptHandler) -> bool:
    """True when the except body leads to another loop iteration: it
    contains a ``continue``, or nothing that leaves the loop (no
    raise/return/break on every path is approximated as 'none present
    at all')."""
    kinds = [type(n) for n in _shallow(handler.body)]
    if ast.Continue in kinds:
        return True
    return not any(k in kinds for k in (ast.Raise, ast.Return, ast.Break))


def _guarded_exit(loop_nodes: List[ast.AST]) -> bool:
    """A bound expressed as control flow: an ``if`` whose test compares
    something attempt/deadline-ish (or reads the clock) and whose body
    leaves the loop (raise/break/return)."""
    for node in loop_nodes:
        if not isinstance(node, ast.If):
            continue
        test_names = list(_names_in(node.test))
        timeish = any(n in ("monotonic", "time") for n in test_names)
        boundish = any(_BOUNDISH.search(n) for n in test_names)
        if not (timeish or boundish):
            continue
        if any(
            isinstance(n, (ast.Raise, ast.Break, ast.Return))
            for n in _shallow(node.body)
        ):
            return True
    return False


def _sleep_calls(loop_nodes: List[ast.AST]) -> List[ast.Call]:
    out = []
    for node in loop_nodes:
        if isinstance(node, ast.Call):
            text = dotted(node.func)
            if text and text.split(".")[-1] == "sleep":
                out.append(node)
    return out


def _retry_findings(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for mod in index.modules.values():
        # loop -> enclosing function label (innermost wins: outer
        # functions are walked first, nested ones overwrite)
        enclosing: Dict[int, str] = {}
        for func in mod.functions.values():
            for sub in ast.walk(func.node):
                if isinstance(sub, (ast.While, ast.For)):
                    enclosing[id(sub)] = func.label
        loop_idx: Dict[str, int] = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.While, ast.For)):
                continue
            symbol = enclosing.get(id(node), mod.name)
            idx = loop_idx.get(symbol, 0)
            loop_idx[symbol] = idx + 1
            body = list(_shallow(node.body))
            handlers = [
                h
                for t in body
                if isinstance(t, ast.Try)
                for h in t.handlers
            ]
            if not any(_handler_reiterates(h) for h in handlers):
                continue
            sleeps = _sleep_calls(body)
            # a RETRY loop (vs a service/poll loop): it sleeps between
            # attempts or names its iteration state attempt/retry-ish
            header = (
                node.target if isinstance(node, ast.For) else node.test
            )
            retryish = bool(sleeps) or (
                header is not None
                and any(_RETRYISH.search(n) for n in _names_in(header))
            )
            if not retryish:
                continue
            # bound: a for loop is finite; a while needs a non-constant
            # test or an explicit attempt/deadline exit guard
            if isinstance(node, ast.For):
                bounded = True
            else:
                test_const_true = (
                    isinstance(node.test, ast.Constant)
                    and bool(node.test.value)
                )
                bounded = not test_const_true or _guarded_exit(body)
            # backoff: at least one sleep with a NON-constant argument
            # (a growing delay); constant sleeps retry in lockstep
            backoff = any(
                c.args and not isinstance(c.args[0], ast.Constant)
                for c in sleeps
            )
            if bounded and backoff:
                continue
            aspect = "bound" if not bounded else "backoff"
            findings.append(
                Finding(
                    rule="unbounded-retry",
                    path=mod.path,
                    line=node.lineno,
                    symbol=symbol,
                    key=f"loop{idx}|{aspect}",
                    message=(
                        "retry loop has no attempt/deadline bound — a "
                        "permanent fault retries forever"
                        if not bounded
                        else "retry loop has no growing backoff sleep "
                        "— attempts hammer the faulted resource in "
                        "lockstep"
                    ),
                )
            )
    return findings


def run(index: PackageIndex) -> List[Finding]:
    return (
        _thread_findings(index)
        + _except_findings(index)
        + _retry_findings(index)
    )
