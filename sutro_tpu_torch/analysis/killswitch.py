"""Kill-switch zero-op pass.

Every optional subsystem is env-gated (``SUTRO_TELEMETRY``,
``SUTRO_MONITOR``, ``SUTRO_CONTROL``, ``SUTRO_PREFIX_STORE``,
``SUTRO_FAULT_PLAN``) with a documented contract: switch off means
*zero added work* on the hot path — not "cheap", zero. The benchmarks
assert the aggregate budget; this pass catches individual regressions
statically by taint-walking from the flag read:

1. Seed taint at every ``os.environ.get("SUTRO_*")`` read: the
   assigned global (``ENABLED``), the enclosing function
   (``enabled()``, ``_enabled()``), attribute latches assigned from
   tainted values (``self._tel_on = telemetry.enabled()``), and so on
   to a fixpoint across the package.
2. Any side-effecting call into a gated subsystem (telemetry metric
   writes — ``.inc``/``.set``/``.observe``/``stage_observe`` — and
   fault-plan ``inject``/``fire``) made outside the subsystem's own
   package must be *dominated* by a check of a tainted symbol: an
   enclosing ``if``/ternary mentioning the taint, a preceding tainted
   guard clause that terminates, or an internal guard at the top of the
   resolved callee (wrappers like ``_count_outcome`` that begin with
   ``if telemetry.ENABLED:``).

Rule: ``killswitch-ungated``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import FunctionInfo, ModuleInfo, PackageIndex, dotted
from .core import Finding

FLAG_ENVS = (
    "SUTRO_TELEMETRY",
    "SUTRO_MONITOR",
    "SUTRO_CONTROL",
    "SUTRO_PREFIX_STORE",
    "SUTRO_FAULT_PLAN",
)

_METRIC_OPS = ("inc", "set", "observe")


def _env_flag_read(call: ast.Call, mod: ModuleInfo) -> Optional[str]:
    t = mod.expand(dotted(call.func) or "")
    if t not in ("os.environ.get", "os.getenv", "environ.get"):
        return None
    if call.args and isinstance(call.args[0], ast.Constant):
        v = call.args[0].value
        if isinstance(v, str) and v in FLAG_ENVS:
            return v
    return None


def _tainted_tails(node: ast.AST, taints: Set[str]) -> bool:
    """Does any Name id or Attribute tail under ``node`` hit the taint
    set?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in taints:
            return True
        if isinstance(n, ast.Attribute) and n.attr in taints:
            return True
    return False


def _taint_expr(node: ast.AST, taints: Set[str]) -> bool:
    """Tight propagation grammar: the value must *be* a flag
    expression, not merely mention one somewhere — names/attr tails in
    the taint set, calls to tainted functions, and boolean/compare/
    conditional compositions of those with constants. This is what
    keeps ordinary data flow out of the taint set."""
    if isinstance(node, ast.Name):
        return node.id in taints
    if isinstance(node, ast.Attribute):
        return node.attr in taints
    if isinstance(node, ast.Call):
        t = dotted(node.func)
        return t is not None and t.rsplit(".", 1)[-1] in taints
    if isinstance(node, ast.BoolOp):
        return any(_taint_expr(v, taints) for v in node.values)
    if isinstance(node, ast.UnaryOp):
        return _taint_expr(node.operand, taints)
    if isinstance(node, ast.Compare):
        return _taint_expr(node.left, taints) or any(
            _taint_expr(c, taints) for c in node.comparators
        )
    if isinstance(node, ast.IfExp):
        return (
            _taint_expr(node.test, taints)
            or _taint_expr(node.body, taints)
            or _taint_expr(node.orelse, taints)
        )
    return False


def discover_taints(index: PackageIndex) -> Set[str]:
    taints: Set[str] = set()
    # seeds: (a) module-level names assigned straight from an env-flag
    # read; (b) functions whose body reads an env flag
    for mod in index.modules.values():
        for func in mod.functions.values():
            for n in ast.walk(func.node):
                if isinstance(n, ast.Call) and _env_flag_read(n, mod):
                    taints.add(func.qualname.split(".")[-1])
                    break
        for n in mod.tree.body:
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                value = n.value
                if value is not None and any(
                    isinstance(c, ast.Call) and _env_flag_read(c, mod)
                    for c in ast.walk(value)
                ):
                    taints.update(_targets_of(n))
    # fixpoint propagation
    for _ in range(4):
        grew = False

        def add(name: str) -> None:
            nonlocal grew
            if name and name not in taints:
                taints.add(name)
                grew = True

        for mod in index.modules.values():
            # module-level latches assigned from taint expressions
            for n in mod.tree.body:
                if isinstance(n, (ast.Assign, ast.AnnAssign)):
                    if n.value is not None and _taint_expr(n.value, taints):
                        for t in _targets_of(n):
                            add(t)
            for func in mod.functions.values():
                fname = func.qualname.split(".")[-1]
                has_global = {
                    g
                    for s in ast.walk(func.node)
                    if isinstance(s, ast.Global)
                    for g in s.names
                }
                for n in ast.walk(func.node):
                    if isinstance(n, (ast.Assign, ast.AnnAssign)):
                        if n.value is None or not _taint_expr(
                            n.value, taints
                        ):
                            continue
                        # attribute latches (``self._tel_on = …``) and
                        # mutated globals propagate; plain locals stay
                        # function-scoped
                        tgts = (
                            n.targets
                            if isinstance(n, ast.Assign)
                            else [n.target]
                        )
                        for tg in tgts:
                            if isinstance(tg, ast.Attribute):
                                add(tg.attr)
                            elif (
                                isinstance(tg, ast.Name)
                                and tg.id in has_global
                            ):
                                add(tg.id)
                    elif (
                        isinstance(n, ast.Return)
                        and n.value is not None
                        and _taint_expr(n.value, taints)
                    ):
                        add(fname)
                # globals mutated inside a function that a tainted
                # function calls (``configure()`` -> ``install()`` ->
                # ``ACTIVE``): the installed value is the flag
                if has_global and fname not in taints:
                    for other in mod.functions.values():
                        oname = other.qualname.split(".")[-1]
                        if oname not in taints:
                            continue
                        called = {
                            (dotted(c.func) or "").rsplit(".", 1)[-1]
                            for c in ast.walk(other.node)
                            if isinstance(c, ast.Call)
                        }
                        if fname in called:
                            for g in has_global:
                                add(g)
                            break
        if not grew:
            break
    return taints


def _targets_of(n) -> List[str]:
    out = []
    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, ast.Attribute):
            out.append(t.attr)
    return out


def _terminates(stmts: List[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _op_of(call: ast.Call, mod: ModuleInfo) -> Optional[Tuple[str, str]]:
    """(switch, op-key) for side-effecting gated-subsystem calls."""
    t = mod.expand(dotted(call.func) or "")
    if not t:
        return None
    if ".telemetry." in t or t.startswith("telemetry."):
        last = t.rsplit(".", 1)[-1]
        if last in _METRIC_OPS:
            parts = t.split(".")
            metric = parts[-2] if len(parts) >= 2 else last
            # registry/admin plumbing isn't a hot-path metric write
            if metric.isupper():
                return ("telemetry", f"{metric}.{last}")
        if last == "stage_observe":
            return ("telemetry", "stage_observe")
    if t.endswith((".faults.inject", ".faults.fire")) or t in (
        "faults.inject",
        "faults.fire",
    ):
        return ("faults", t.rsplit(".", 1)[-1])
    return None


def _home_of(mod: ModuleInfo) -> Set[str]:
    """Switches whose implementation lives in this module (exempt)."""
    parts = mod.name.split(".")
    out: Set[str] = set()
    if "telemetry" in parts:
        out.add("telemetry")
    if parts[-1] == "faults":
        out.add("faults")
    return out


def _local_taints(func_node, taints: Set[str]) -> Set[str]:
    """Names assigned from tainted values inside one function
    (``plan = ACTIVE``)."""
    local = set()
    for _ in range(2):
        for n in ast.walk(func_node):
            if isinstance(n, (ast.Assign, ast.AnnAssign)) and n.value is not None:
                if _taint_expr(n.value, taints | local):
                    local.update(_targets_of(n))
    return local


def _has_internal_gate(func: FunctionInfo, taints: Set[str]) -> bool:
    body = getattr(func.node, "body", [])
    scope = taints | _local_taints(func.node, taints)
    for stmt in body[:8]:
        if isinstance(stmt, ast.If) and _tainted_tails(stmt.test, scope):
            return True
    return False


def gated_functions(index: PackageIndex, taints: Set[str]) -> Set[str]:
    """Bare names of functions that gate themselves on a flag near the
    top. Computed to a fixpoint so gating composes through wrappers:
    ``fire()`` checks ``ACTIVE`` directly, ``inject()`` checks the
    value it got back from ``fire()`` — both are zero-op when the
    switch is off, so calls to either need no caller-side gate."""
    gated: Set[str] = set()
    for _ in range(3):
        grew = False
        for mod in index.modules.values():
            for func in mod.functions.values():
                fname = func.qualname.split(".")[-1]
                if fname in gated:
                    continue
                if _has_internal_gate(func, taints | gated):
                    gated.add(fname)
                    grew = True
        if not grew:
            break
    return gated


class _Checker:
    def __init__(
        self, index: PackageIndex, taints: Set[str], gated: Set[str]
    ):
        self.index = index
        self.taints = taints
        self.gated = gated
        self.findings: List[Finding] = []

    def check_function(self, func: FunctionInfo) -> None:
        homes = _home_of(func.module)
        # closure scope: a flag latched in an enclosing function
        # (``tel_on = telemetry.enabled()``) gates its nested callbacks
        basis = self.taints | self.gated
        scope = set(basis)
        f: Optional[FunctionInfo] = func
        while f is not None:
            scope |= _local_taints(f.node, basis)
            f = f.parent
        self._walk(func, func.node.body, gated=False, scope=scope, homes=homes)

    def _walk(self, func, stmts, gated: bool, scope, homes) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs are scanned as their own functions
            if isinstance(stmt, ast.If):
                test_tainted = _tainted_tails(stmt.test, scope)
                self._walk(
                    func, stmt.body, gated or test_tainted, scope, homes
                )
                self._walk(func, stmt.orelse, gated, scope, homes)
                if test_tainted and _terminates(stmt.body) and not stmt.orelse:
                    gated = True  # tainted guard clause covers the rest
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._scan_exprs(func, [getattr(stmt, "iter", None) or stmt.test], gated, scope, homes)
                self._walk(func, stmt.body, gated, scope, homes)
                self._walk(func, stmt.orelse, gated, scope, homes)
                continue
            if isinstance(stmt, ast.Try):
                self._walk(func, stmt.body, gated, scope, homes)
                for h in stmt.handlers:
                    self._walk(func, h.body, gated, scope, homes)
                self._walk(func, stmt.orelse, gated, scope, homes)
                self._walk(func, stmt.finalbody, gated, scope, homes)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._scan_exprs(
                    func,
                    [i.context_expr for i in stmt.items],
                    gated,
                    scope,
                    homes,
                )
                self._walk(func, stmt.body, gated, scope, homes)
                continue
            self._scan_exprs(func, [stmt], gated, scope, homes)

    def _scan_exprs(self, func, nodes, gated: bool, scope, homes) -> None:
        for root in nodes:
            if root is None:
                continue
            # an expression-level taint mention (ternary, ``and``
            # short-circuit, latched kwarg) gates its own statement
            stmt_gated = gated or _tainted_tails(root, scope)
            if stmt_gated:
                continue
            for n in ast.walk(root):
                if not isinstance(n, ast.Call):
                    continue
                op = _op_of(n, func.module)
                if op is None or op[0] in homes:
                    continue
                _, target = self.index.resolve_call(func, n)
                if target is not None and (
                    target.qualname.split(".")[-1] in self.gated
                    or _has_internal_gate(target, self.taints)
                ):
                    continue
                switch, opkey = op
                self.findings.append(
                    Finding(
                        rule="killswitch-ungated",
                        path=func.module.path,
                        line=n.lineno,
                        message=f"side-effecting {switch} call "
                        f"({opkey}) not gated behind the {switch} "
                        "kill switch — switch-off must mean zero work "
                        "on this path",
                        symbol=func.label,
                        key=f"{switch}:{opkey}",
                    )
                )


def run(index: PackageIndex) -> List[Finding]:
    taints = discover_taints(index)
    gated = gated_functions(index, taints)
    checker = _Checker(index, taints, gated)
    for mod in index.modules.values():
        for func in mod.functions.values():
            checker.check_function(func)
    return checker.findings
