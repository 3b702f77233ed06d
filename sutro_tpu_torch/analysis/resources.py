"""Resource-lifecycle pass: path-sensitive acquire/release checking.

The engine's correctness-critical resources are refcounted or pooled:
KV pages (PageAllocator ``alloc``/``reserve`` vs ``free``), prefix-store
pins (``lookup_pin`` vs ``release``), stream channels (``StreamChannel``
vs ``finish``/``fail``/``cancel``), sockets (``create_connection`` /
``accept`` vs ``close``), worker threads (ctor vs ``join``), and
interactive slots (``take_slot`` vs ``return_slot``). Losing a release
on one path is silent corruption — a pinned prefix that never unpins
starves eviction; a double ``free`` hands the same page to two rows.

Rules:

- ``resource-leak`` — an acquire whose resource is still held when a
  path leaves the function. Explicit exits (``return``/``raise``/
  implicit end) always count. Implicit exception edges (a call on the
  path may raise) count only when the function releases that resource
  kind somewhere — a function that never releases is assumed to be
  transferring ownership, not leaking.
- ``resource-double-release`` — the same variable released twice on one
  path without an intervening re-acquire, for kinds where the second
  release corrupts state (page free-lists, pin refcounts).

Ownership transfer ends tracking: returning/yielding the variable,
passing it as a call argument (``self.reg[k] = ch`` style stores and
``lst.append(t)`` both route through this), assigning it onto an
attribute, capturing it in a nested def, or entering it as a context
manager. ``var = None`` and rebinds end tracking too, as do
``is None`` refinements on the branch where the variable is None.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import (
    EXIT_EXCEPTION,
    EXIT_FALLTHROUGH,
    EXIT_RAISE,
    EXIT_RETURN,
    FlowWalker,
    FunctionInfo,
    PackageIndex,
    calls_in,
    dotted,
    names_in,
)
from .core import Finding


@dataclasses.dataclass(frozen=True)
class Kind:
    name: str
    # acquire: ``var = recv.suffix(...)`` / ``var = exact(...)`` /
    # ``var = Ctor(...)``; ``recv.acquire_arg(var)`` adopts ``var``.
    acquire_suffix: Tuple[str, ...] = ()
    acquire_exact: Tuple[str, ...] = ()
    ctor_suffix: Tuple[str, ...] = ()
    acquire_arg: Tuple[str, ...] = ()
    # release: ``var.method()`` / ``anything.arg_suffix(var)``
    release_method: Tuple[str, ...] = ()
    release_arg: Tuple[str, ...] = ()
    unsafe_double: bool = False
    release_hint: str = "release"


KINDS: Tuple[Kind, ...] = (
    Kind(
        name="kv-pages",
        acquire_suffix=(".alloc", ".alloc_pages"),
        acquire_arg=(".reserve",),
        # ``.promote``/``.reserve_pages`` are the KV-tier ownership
        # transfers (scheduler._promote_prefix/_release): pages handed
        # to the prefix store or re-adopted by the native allocator
        # count as released — a later free of the same var is the
        # double-free the tiering paths must never perform
        release_arg=(".free", ".free_pages", ".promote",
                     ".reserve_pages"),
        unsafe_double=True,
        release_hint="free()",
    ),
    Kind(
        name="prefix-pin",
        acquire_suffix=(".lookup_pin",),
        release_arg=(".release",),
        unsafe_double=True,
        release_hint="release()",
    ),
    Kind(
        name="stream-channel",
        ctor_suffix=("StreamChannel",),
        release_method=(".finish", ".fail", ".cancel", ".close"),
        release_hint="finish()/fail()/cancel()",
    ),
    Kind(
        name="socket",
        acquire_exact=("socket.create_connection", "socket.create_server"),
        acquire_suffix=(".accept",),
        release_method=(".close",),
        release_arg=("_hard_close",),
        release_hint="close()",
    ),
    Kind(
        name="thread",
        ctor_suffix=("threading.Thread",),
        release_method=(".join",),
        release_hint="join()",
    ),
    Kind(
        name="interactive-slot",
        acquire_suffix=(".take_slot",),
        release_arg=(".return_slot", ".release_slot"),
        unsafe_double=True,
        release_hint="return_slot()",
    ),
)


@dataclasses.dataclass(frozen=True)
class _Rec:
    kind: Kind
    line: int
    released: bool = False


@dataclasses.dataclass
class _CallFacts:
    node: ast.Call
    text: str  # import-expanded dotted text ("" if not dotted)
    arg_names: Tuple[str, ...]  # direct Name args (incl. Starred, kwargs)


@dataclasses.dataclass
class _StmtFacts:
    calls: List[_CallFacts]
    # Assign-shaped facts: (target_name, acquire_kind_or_None)
    binds: List[Tuple[str, Optional[Kind]]]
    captured: Set[str]  # names referenced inside nested defs/lambdas
    stored: Set[str] = dataclasses.field(default_factory=set)
    # names assigned onto an attribute/subscript (``self.x = var``,
    # ``reg[k] = var``) — ownership transfers to the container


def _direct_arg_names(call: ast.Call) -> Tuple[str, ...]:
    out = []
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Starred):
            a = a.value
        if isinstance(a, ast.Name):
            out.append(a.id)
    return tuple(out)


def _acquire_kind(
    text: str,
    call: Optional[ast.Call] = None,
    kinds: Tuple[Kind, ...] = KINDS,
) -> Optional[Kind]:
    if not text:
        return None
    for k in kinds:
        if text in k.acquire_exact:
            return k
        if any(text.endswith(s) for s in k.acquire_suffix):
            return k
        if any(
            text == c or text.endswith(f".{c}") for c in k.ctor_suffix
        ):
            # daemon threads are fire-and-forget by design — no join
            # is owed, so they're not a tracked acquisition
            if k.name == "thread" and call is not None and any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in call.keywords
            ):
                return None
            return k
    return None


class _ResourceWalker(FlowWalker):
    def __init__(self, pass_: "_ResourcePass", func: FunctionInfo):
        self.p = pass_
        self.func = func
        self.findings: List[Finding] = []
        self._emitted: Set[Tuple[str, str, int, str]] = set()
        # kinds this function releases somewhere: only those get
        # implicit exception-edge leak findings
        self.owned_kinds: Set[str] = set()
        for call in calls_in(func.node, skip_nested=False):
            text = func.module.expand(dotted(call.func) or "")
            for k in pass_.kinds:
                if any(
                    text.endswith(s) for s in k.release_method + k.release_arg
                ):
                    self.owned_kinds.add(k.name)

    # -- state plumbing ------------------------------------------------
    def initial_state(self):
        return {}

    def copy_state(self, state):
        return dict(state)

    def state_key(self, state):
        return tuple(
            sorted((v, r.kind.name, r.line, r.released) for v, r in state.items())
        )

    # -- per-statement facts (cached across paths) ----------------------
    def _facts(self, stmt) -> _StmtFacts:
        cached = self.p.stmt_facts.get(id(stmt))
        if cached is not None:
            return cached
        expand = self.func.module.expand
        # compound statements execute their bodies through the walker;
        # only header expressions run "at" this statement
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            call_roots: List[ast.AST] = [stmt.iter]
        elif isinstance(stmt, ast.While):
            call_roots = [stmt.test]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            call_roots = [i.context_expr for i in stmt.items]
        elif isinstance(stmt, ast.ExceptHandler):
            call_roots = []
        elif isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            call_roots = []
        else:
            call_roots = [stmt]
        calls = [
            _CallFacts(
                node=c,
                text=expand(dotted(c.func) or ""),
                arg_names=_direct_arg_names(c),
            )
            for root in call_roots
            for c in calls_in(root)
        ]
        binds: List[Tuple[str, Optional[Kind]]] = []
        captured: Set[str] = set()
        stored: Set[str] = set()
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            kind = None
            if isinstance(value, ast.Call):
                kind = _acquire_kind(
                    expand(dotted(value.func) or ""), value,
                    kinds=self.p.kinds,
                )
            for t in targets:
                if isinstance(t, ast.Name):
                    binds.append((t.id, kind))
                elif isinstance(t, ast.Tuple) and t.elts:
                    # ``conn, addr = sock.accept()``: the resource is
                    # the first element; the rest are plain rebinds
                    for i, e in enumerate(t.elts):
                        if isinstance(e, ast.Name):
                            binds.append((e.id, kind if i == 0 else None))
                elif isinstance(t, (ast.Attribute, ast.Subscript)):
                    if value is not None:
                        stored |= {
                            n.id
                            for n in ast.walk(value)
                            if isinstance(n, ast.Name)
                        }
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            for n in ast.walk(stmt.target):
                if isinstance(n, ast.Name):
                    binds.append((n.id, None))
        elif isinstance(stmt, ast.ExceptHandler):
            if stmt.name:
                binds.append((stmt.name, None))
        elif isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            captured = names_in(stmt)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if isinstance(item.optional_vars, ast.Name):
                    binds.append((item.optional_vars.id, None))
        facts = _StmtFacts(
            calls=calls, binds=binds, captured=captured, stored=stored
        )
        self.p.stmt_facts[id(stmt)] = facts
        return facts

    def _classify_call(self, state, cf: _CallFacts):
        """Returns ('release', var, kind) / ('acquire_arg', var, kind) /
        ('double', var, kind) / None for one call vs current state."""
        for var, rec in state.items():
            k = rec.kind
            if any(cf.text == f"{var}{m}" for m in k.release_method) or (
                any(cf.text.endswith(s) for s in k.release_arg)
                and var in cf.arg_names
            ):
                return ("double" if rec.released else "release", var, k)
        for k in self.p.kinds:
            if any(cf.text.endswith(s) for s in k.acquire_arg):
                for name in cf.arg_names:
                    if name not in state:
                        return ("acquire_arg", name, k)
        return None

    # -- FlowWalker hooks ----------------------------------------------
    def on_stmt(self, state, stmt) -> None:
        facts = self._facts(stmt)
        if facts.captured:
            for var in [v for v in state if v in facts.captured]:
                del state[var]  # closure capture = escape
            return
        for cf in facts.calls:
            action = self._classify_call(state, cf)
            if action is not None:
                verb, var, kind = action
                if verb == "release":
                    state[var] = dataclasses.replace(
                        state[var], released=True
                    )
                elif verb == "double":
                    if kind.unsafe_double:
                        self._emit(
                            self.p.double_rule,
                            cf.node.lineno,
                            f"{kind.name}:{var}",
                            f"`{var}` ({kind.name}) is released twice on "
                            f"one path (first release already happened); "
                            f"a second {kind.release_hint} corrupts the "
                            "refcount/free-list",
                        )
                elif verb == "acquire_arg":
                    state[var] = _Rec(kind=kind, line=cf.node.lineno)
                continue
            # ownership transfer: a tracked var passed as a direct
            # argument to any other call escapes
            for var in [v for v in state if v in cf.arg_names]:
                del state[var]
        for var in [v for v in state if v in facts.stored]:
            del state[var]  # stored into a container/attribute = escape
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                t = dotted(item.context_expr)
                if t is not None and t in state:
                    # ``with sock:`` — the context manager releases
                    state[t] = dataclasses.replace(state[t], released=True)
        for var, kind in facts.binds:
            if var in state:
                del state[var]  # rebind / ``var = None`` ends tracking
            if kind is not None:
                state[var] = _Rec(kind=kind, line=stmt.lineno)
        # yields transfer control with the value escaping to the caller
        if isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, (ast.Yield, ast.YieldFrom)
        ):
            for var in [v for v in state if v in names_in(stmt.value)]:
                del state[var]

    def stmt_may_raise(self, state, stmt) -> bool:
        if not any(
            not r.released and r.kind.name in self.owned_kinds
            for r in state.values()
        ):
            return False
        facts = self._facts(stmt)
        risky = [
            cf for cf in facts.calls if self._classify_call(state, cf) is None
        ]
        return bool(risky)

    def assume(self, state, test, truth: bool):
        self._refine(state, test, truth)
        return state

    def _refine(self, state, test, truth: bool) -> None:
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self._refine(state, test.operand, not truth)
            return
        if isinstance(test, ast.BoolOp):
            if isinstance(test.op, ast.And) and truth:
                for v in test.values:
                    self._refine(state, v, True)
            elif isinstance(test.op, ast.Or) and not truth:
                for v in test.values:
                    self._refine(state, v, False)
            return
        var_is_none: Optional[Tuple[str, bool]] = None
        if (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.left, ast.Name)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            if isinstance(test.ops[0], ast.Is):
                var_is_none = (test.left.id, truth)
            elif isinstance(test.ops[0], ast.IsNot):
                var_is_none = (test.left.id, not truth)
        elif isinstance(test, ast.Name):
            var_is_none = (test.id, not truth)  # falsy ~ absent
        if var_is_none is not None:
            var, is_none = var_is_none
            if is_none and var in state:
                del state[var]  # on this branch the acquire didn't stick

    def on_exit(self, state, kind: str, node) -> None:
        held = {
            v: r
            for v, r in state.items()
            if not r.released
        }
        if not held:
            return
        if kind in (EXIT_RETURN, EXIT_FALLTHROUGH):
            escaping = (
                names_in(node.value)
                if isinstance(node, ast.Return) and node.value is not None
                else set()
            )
            for var, rec in held.items():
                if var in escaping:
                    continue
                where = (
                    "an early return"
                    if kind == EXIT_RETURN
                    else "the end of the function"
                )
                self._leak(var, rec, where, node)
        elif kind == EXIT_RAISE:
            for var, rec in held.items():
                self._leak(var, rec, "a raise", node)
        elif kind == EXIT_EXCEPTION:
            # a raising statement that itself passes the var to a
            # callee counts as ownership transfer — the callee may have
            # stored it before raising (the final-handoff ctor pattern)
            passed: Set[str] = set()
            if node is not None:
                for cf in self._facts(node).calls:
                    passed.update(cf.arg_names)
            for var, rec in held.items():
                if var in passed:
                    continue
                if rec.kind.name in self.owned_kinds:
                    self._leak(var, rec, "an unhandled exception path", node)

    def _leak(self, var: str, rec: _Rec, where: str, node) -> None:
        at = getattr(node, "lineno", rec.line)
        self._emit(
            self.p.leak_rule,
            rec.line,
            f"{rec.kind.name}:{var}",
            f"`{var}` ({rec.kind.name}) acquired here escapes via {where} "
            f"(line {at}) without the paired {rec.kind.release_hint}",
        )

    def _emit(self, rule: str, line: int, key: str, msg: str) -> None:
        sig = (rule, self.func.label, line, key)
        if sig in self._emitted:
            return
        self._emitted.add(sig)
        self.findings.append(
            Finding(
                rule=rule,
                path=self.func.module.path,
                line=line,
                message=msg,
                symbol=self.func.label,
                key=key,
            )
        )


class _ResourcePass:
    """Parameterized acquire/release engine: the resource pass proper
    runs it over :data:`KINDS`; sibling passes (``tracectx``) reuse the
    whole path-sensitive machinery with their own kind table and rule
    names."""

    def __init__(
        self,
        index: PackageIndex,
        *,
        kinds: Tuple[Kind, ...] = KINDS,
        leak_rule: str = "resource-leak",
        double_rule: str = "resource-double-release",
    ):
        self.index = index
        self.kinds = kinds
        self.leak_rule = leak_rule
        self.double_rule = double_rule
        self.stmt_facts: Dict[int, _StmtFacts] = {}

    def run(self) -> List[Finding]:
        out: List[Finding] = []
        for mod in self.index.modules.values():
            for func in mod.functions.values():
                w = _ResourceWalker(self, func)
                w.run(list(func.node.body))
                out.extend(w.findings)
        return out


def run(index: PackageIndex) -> List[Finding]:
    return _ResourcePass(index).run()
