"""Package-wide AST index and best-effort call resolution.

The passes (locks, jitpure, hygiene) share one parsed view of the
scanned tree: per-module import maps, function/method tables with
lexical nesting (closures), and per-function records of the objects the
rules care about — locks, threads, queues, ``functools.partial``
bindings. Resolution is deliberately *best effort*: ``self.method()``
resolves within the enclosing class, bare names through the lexical
chain then module then imports, ``alias.func()`` through the import
map. Attribute chains on arbitrary objects (``self.eng.jobs.flush``)
do not resolve — the passes treat unresolvable calls as opaque.

``FlowWalker`` adds path-sensitive return-path and exception-edge
tracking over a single function body (loops unrolled once, Try routing
with finalbody replay on every exit) — the substrate for the
resource-lifecycle pass.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
QUEUE_CTORS = {
    "queue.Queue",
    "queue.PriorityQueue",
    "queue.LifoQueue",
    "queue.SimpleQueue",
}
THREAD_CTORS = {"threading.Thread", "threading.Timer"}
EVENT_CTORS = {
    "threading.Event",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "threading.Barrier",
}

# names that look like a lock when we cannot see the constructor
# (e.g. ``with self._queue.mutex:`` — queue.Queue's internal lock)
_LOCKISH = ("lock", "mutex", "cond", "_cv", "condition")


def looks_like_lock(name: str) -> bool:
    low = name.lower()
    return any(low == t or low.endswith(t) or t in low for t in _LOCKISH)


def dotted(node: ast.AST) -> Optional[str]:
    """Name/Attribute chain as ``a.b.c`` text, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


@dataclasses.dataclass
class FunctionInfo:
    module: "ModuleInfo"
    qualname: str  # dotted; classes and nested functions included
    node: ast.AST
    class_name: Optional[str]
    parent: Optional["FunctionInfo"]
    params: Tuple[str, ...]
    local_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    thread_vars: Set[str] = dataclasses.field(default_factory=set)
    queue_vars: Set[str] = dataclasses.field(default_factory=set)
    partial_targets: Dict[str, str] = dataclasses.field(
        default_factory=dict
    )  # var -> function name it wraps via functools.partial

    @property
    def label(self) -> str:
        return f"{self.module.name}:{self.qualname}"

    def all_params(self) -> Set[str]:
        """Own params plus every lexically-enclosing function's (a
        closure calling an outer callback param counts)."""
        out: Set[str] = set()
        f: Optional[FunctionInfo] = self
        while f is not None:
            out.update(f.params)
            f = f.parent
        return out


@dataclasses.dataclass
class ModuleInfo:
    path: str  # as reported in findings (posix-relative)
    name: str  # dotted module name, best effort
    tree: ast.Module
    lines: List[str]
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = dataclasses.field(
        default_factory=dict
    )
    attr_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    module_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    # "{Class}.{attr}" -> expanded ctor text for every ``self.x = Ctor()``
    # assignment seen in the class (first ctor wins) — the races pass
    # uses it to tell sync objects (queues/events/threads) from plain
    # shared state
    attr_ctors: Dict[str, str] = dataclasses.field(default_factory=dict)
    rlock_ids: Set[str] = dataclasses.field(default_factory=set)
    classes: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict
    )  # class name -> method qualnames

    def expand(self, text: str) -> str:
        """Rewrite the first segment through the import map so curated
        pattern lists match regardless of local aliases (``_time.sleep``
        -> ``time.sleep``, ``pd.read_parquet`` -> ``pandas.read_parquet``)."""
        head, sep, rest = text.partition(".")
        target = self.imports.get(head)
        if target is None:
            return text
        return f"{target}{sep}{rest}" if rest else target


def module_name_for(path: Path) -> str:
    parts = [] if path.stem == "__init__" else [path.stem]
    d = path.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        parent = d.parent
        if parent == d:
            break
        d = parent
    return ".".join(parts) or path.stem


def _collect_imports(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mod.imports[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    mod.imports[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = mod.name.split(".")
                base_parts = base_parts[: -node.level] if node.level <= len(
                    base_parts
                ) else []
                base = ".".join(base_parts)
                if node.module:
                    base = f"{base}.{node.module}" if base else node.module
            else:
                base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                mod.imports[a.asname or a.name] = (
                    f"{base}.{a.name}" if base else a.name
                )


class _Indexer(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.class_stack: List[str] = []
        self.func_stack: List[FunctionInfo] = []

    # -- helpers -------------------------------------------------------
    def _qual(self, name: str) -> str:
        parts = self.class_stack + [
            f.qualname.split(".")[-1] for f in self.func_stack
        ]
        # func_stack entries already carry full quals; rebuild from the
        # innermost enclosing scope instead
        if self.func_stack:
            return f"{self.func_stack[-1].qualname}.{name}"
        if self.class_stack:
            return f"{'.'.join(self.class_stack)}.{name}"
        return name

    def _ctor_of(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            text = dotted(value.func)
            if text:
                return self.mod.expand(text)
        return None

    def _lock_id_for_expr(self, node: ast.AST) -> Optional[str]:
        """Resolve an expression naming an existing lock (for Condition
        aliasing): ``self.lock`` or a bare name."""
        text = dotted(node)
        if text is None:
            return None
        if text.startswith("self.") and self.class_stack:
            return self.mod.attr_locks.get(
                f"{self.class_stack[-1]}.{text[5:]}"
            )
        f = self.func_stack[-1] if self.func_stack else None
        while f is not None:
            if text in f.local_locks:
                return f.local_locks[text]
            f = f.parent
        return self.mod.module_locks.get(text)

    def _record_assign(self, target: ast.AST, value: ast.AST) -> None:
        ctor = self._ctor_of(value)
        func = self.func_stack[-1] if self.func_stack else None
        name = dotted(target)
        if name is None:
            return
        if (
            ctor is not None
            and self.class_stack
            and name.startswith("self.")
            and "." not in name[5:]
        ):
            self.mod.attr_ctors.setdefault(
                f"{self.class_stack[-1]}.{name[5:]}", ctor
            )
        if ctor in LOCK_CTORS:
            lock_id: Optional[str] = None
            if ctor == "threading.Condition" and isinstance(
                value, ast.Call
            ) and value.args:
                lock_id = self._lock_id_for_expr(value.args[0])
            final_id: Optional[str] = None
            if name.startswith("self.") and self.class_stack:
                attr = name[5:]
                key = f"{self.class_stack[-1]}.{attr}"
                final_id = lock_id or f"{self.mod.name}:{key}"
                self.mod.attr_locks[key] = final_id
            elif "." not in name:
                if func is not None:
                    final_id = (
                        lock_id
                        or f"{self.mod.name}:{func.qualname}.{name}"
                    )
                    func.local_locks[name] = final_id
                else:
                    final_id = lock_id or f"{self.mod.name}:{name}"
                    self.mod.module_locks[name] = final_id
            if ctor == "threading.RLock" and final_id is not None:
                self.mod.rlock_ids.add(final_id)
        elif ctor == "threading.Thread" and func is not None:
            if "." not in name:
                func.thread_vars.add(name)
            elif name.startswith("self.") and self.class_stack:
                # attribute-held thread: track under its attr text so
                # ``self._worker.join(...)`` anywhere in the class counts
                func.thread_vars.add(name)
        elif ctor in QUEUE_CTORS and func is not None and "." not in name:
            func.queue_vars.add(name)
        elif ctor == "functools.partial" and func is not None:
            if isinstance(value, ast.Call) and value.args:
                tgt = dotted(value.args[0])
                if tgt and "." not in name:
                    func.partial_targets[name] = tgt

    # -- visitors ------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.mod.classes.setdefault(node.name, [])
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        qual = self._qual(node.name)
        args = node.args
        params = tuple(
            a.arg
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
            )
            if a.arg not in ("self", "cls")
        )
        info = FunctionInfo(
            module=self.mod,
            qualname=qual,
            node=node,
            class_name=self.class_stack[-1] if self.class_stack else None,
            parent=self.func_stack[-1] if self.func_stack else None,
            params=params,
        )
        self.mod.functions[qual] = info
        if self.class_stack:
            self.mod.classes[self.class_stack[-1]].append(qual)
        self.func_stack.append(info)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_assign(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_assign(node.target, node.value)
        self.generic_visit(node)


def calls_in(node: ast.AST, skip_nested: bool = True):
    """Every ast.Call under ``node``, excluding (by default) calls that
    only run inside nested function/class definitions — those execute
    later, not on this statement's path."""
    stack = [node]
    while stack:
        n = stack.pop()
        if skip_nested and n is not node and isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def names_in(node: ast.AST) -> Set[str]:
    """Bare names referenced anywhere under ``node`` (incl. nested
    defs: a closure capturing a variable keeps it alive/escaped)."""
    return {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    }


# -- path-sensitive flow walking ---------------------------------------
#
# Exception-edge and return-path tracking over a function body: the
# walker enumerates execution paths statement by statement, modelling
# If/For/While branching (loops unrolled once), Try routing (exception
# edges flow to handlers, finalbody runs on every exit), and the three
# exit kinds the lifecycle passes care about — explicit ``return``,
# explicit ``raise``, and implicit exception edges escaping from calls.
# Subclasses own the state object and the per-statement effects; the
# walker owns control flow.

_MAX_FLOW_STATES = 48  # per-block path cap; beyond it paths are dropped

# exit kinds delivered to on_exit()
EXIT_RETURN = "return"
EXIT_RAISE = "raise"
EXIT_EXCEPTION = "exception"  # implicit: a call on the path may raise
EXIT_FALLTHROUGH = "fallthrough"

_LOOP_EXITS = ("break", "continue")


class FlowWalker:
    """Subclass contract:

    - ``copy_state(state)``: independent copy for a forked path.
    - ``state_key(state)``: hashable dedupe key (paths with equal keys
      merge; keeps path count bounded).
    - ``on_stmt(state, stmt)``: apply a simple statement's effects.
    - ``stmt_may_raise(state, stmt)``: True if an exception edge should
      fork off *before* the statement's effects apply.
    - ``assume(state, test, truth)``: refine ``state`` under branch
      condition ``test`` being ``truth``; return None for infeasible.
    - ``on_exit(state, kind, node)``: a path leaves the function
      (finalbodies already applied). ``kind`` is one of EXIT_*.
    """

    # -- subclass hooks ------------------------------------------------
    def copy_state(self, state):  # pragma: no cover - trivial default
        return dict(state)

    def state_key(self, state):  # pragma: no cover - trivial default
        return repr(state)

    def on_stmt(self, state, stmt) -> None:
        pass

    def stmt_may_raise(self, state, stmt) -> bool:
        return False

    def assume(self, state, test, truth: bool):
        return state

    def on_exit(self, state, kind: str, node: ast.AST) -> None:
        pass

    # -- entry ---------------------------------------------------------
    def run(self, body: List[ast.stmt]) -> None:
        """Walk a function body from a fresh initial state."""
        states, exits = self._exec_block(body, [self.initial_state()])
        for st in states:
            self.on_exit(st, EXIT_FALLTHROUGH, body[-1] if body else None)
        for kind, node, st in exits:
            if kind in _LOOP_EXITS:  # stray break/continue: treat as end
                self.on_exit(st, EXIT_FALLTHROUGH, node)
            else:
                self.on_exit(st, kind, node)

    def initial_state(self):  # pragma: no cover - trivial default
        return {}

    def _dedupe(self, states):
        out, seen = [], set()
        for st in states:
            k = self.state_key(st)
            if k not in seen:
                seen.add(k)
                out.append(st)
            if len(out) >= _MAX_FLOW_STATES:
                break
        return out

    def _exec_block(self, stmts, states):
        """Returns ``(fallthrough_states, exits)`` where exits is a list
        of ``(kind, node, state)`` propagating past this block."""
        exits: List[Tuple[str, ast.AST, object]] = []
        for stmt in stmts:
            if not states:
                break
            next_states: List[object] = []
            for st in states:
                ft, ex = self._exec_stmt(stmt, st)
                next_states.extend(ft)
                exits.extend(ex)
            states = self._dedupe(next_states)
        return states, exits

    def _exec_stmt(self, stmt, state):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            self.on_stmt(state, stmt)  # closures can capture/escape vars
            return [state], []
        if isinstance(stmt, ast.Return):
            return [], [(EXIT_RETURN, stmt, state)]
        if isinstance(stmt, ast.Raise):
            return [], [(EXIT_RAISE, stmt, state)]
        if isinstance(stmt, ast.Break):
            return [], [("break", stmt, state)]
        if isinstance(stmt, ast.Continue):
            return [], [("continue", stmt, state)]
        if isinstance(stmt, ast.If):
            return self._exec_if(stmt, state)
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            return self._exec_loop(stmt, state)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, state)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._exec_with(stmt, state)
        # simple statement: fork the exception edge off the pre-effect
        # state, then apply effects to the surviving path
        exits = []
        if self.stmt_may_raise(state, stmt):
            exits.append((EXIT_EXCEPTION, stmt, self.copy_state(state)))
        self.on_stmt(state, stmt)
        return [state], exits

    def _exec_if(self, stmt, state):
        t = self.assume(self.copy_state(state), stmt.test, True)
        f = self.assume(state, stmt.test, False)
        states, exits = [], []
        if t is not None:
            ft, ex = self._exec_block(stmt.body, [t])
            states.extend(ft)
            exits.extend(ex)
        if f is not None:
            ft, ex = self._exec_block(stmt.orelse, [f])
            states.extend(ft)
            exits.extend(ex)
        return states, exits

    def _exec_loop(self, stmt, state):
        zero = self.copy_state(state)  # zero-iteration path
        self.on_stmt(state, stmt)  # loop header effects (For target etc.)
        ft, ex = self._exec_block(stmt.body, [state])
        states = [zero]
        exits = []
        for kind, node, st in ex:
            if kind in _LOOP_EXITS:
                states.append(st)  # break/continue end up after the loop
            else:
                exits.append((kind, node, st))
        states.extend(ft)  # one-iteration fallthrough
        if stmt.orelse:
            states, ex2 = self._exec_block(stmt.orelse, self._dedupe(states))
            exits.extend(ex2)
        return self._dedupe(states), exits

    def _exec_with(self, stmt, state):
        exits = []
        if self.stmt_may_raise(state, stmt):
            exits.append((EXIT_EXCEPTION, stmt, self.copy_state(state)))
        self.on_stmt(state, stmt)
        ft, ex = self._exec_block(stmt.body, [state])
        exits.extend(ex)
        return ft, exits

    def _exec_try(self, stmt, state):
        body_ft, body_ex = self._exec_block(stmt.body, [state])
        after: List[object] = []
        exits: List[Tuple[str, ast.AST, object]] = []
        caught: List[object] = []
        for kind, node, st in body_ex:
            if kind in (EXIT_EXCEPTION, EXIT_RAISE) and stmt.handlers:
                caught.append(st)
            else:
                exits.append((kind, node, st))
        # handlers: conservatively assume a present handler catches the
        # edge (broad excepts dominate this codebase); a Raise inside
        # the handler body re-escapes naturally
        if caught and stmt.handlers:
            for h in stmt.handlers:
                for st in self._dedupe(caught):
                    hst = self.copy_state(st)
                    self.on_stmt(hst, h)  # ``except E as e:`` binding
                    ft, ex = self._exec_block(h.body, [hst])
                    after.extend(ft)
                    exits.extend(ex)
        if stmt.orelse:
            body_ft, ex = self._exec_block(stmt.orelse, body_ft)
            exits.extend(ex)
        after.extend(body_ft)
        if stmt.finalbody:
            # finalbody runs on normal completion AND on every
            # propagating exit; its own exits replace the pending one
            after, fex = self._exec_block(stmt.finalbody, self._dedupe(after))
            exits_out: List[Tuple[str, ast.AST, object]] = list(fex)
            for kind, node, st in exits:
                ft, fex2 = self._exec_block(stmt.finalbody, [st])
                exits_out.extend(fex2)
                for st2 in ft:
                    exits_out.append((kind, node, st2))
            exits = exits_out
        return self._dedupe(after), exits


class PackageIndex:
    """All scanned modules plus cross-module lookup."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}

    def add_source(self, path: str, source: str, name: str) -> ModuleInfo:
        tree = ast.parse(source, filename=path)
        mod = ModuleInfo(
            path=path, name=name, tree=tree, lines=source.splitlines()
        )
        _collect_imports(mod)
        # two indexing passes: locks discovered in ``__init__`` must be
        # visible when other (earlier) methods resolve them
        _Indexer(mod).visit(mod.tree)
        _Indexer(mod).visit(mod.tree)
        self.modules[name] = mod
        return mod

    def add_file(self, path: Path, report_path: str) -> ModuleInfo:
        return self.add_source(
            report_path,
            path.read_text(encoding="utf-8"),
            module_name_for(path),
        )

    def find_module(self, dotted_name: str) -> Optional[ModuleInfo]:
        m = self.modules.get(dotted_name)
        if m is not None:
            return m
        for name, mod in self.modules.items():
            if name.endswith(f".{dotted_name}") or dotted_name.endswith(
                f".{name}"
            ):
                return mod
        return None

    # -- call resolution ----------------------------------------------
    def resolve_call(
        self, func: FunctionInfo, call: ast.Call
    ) -> Tuple[str, Optional[FunctionInfo]]:
        """Returns ``(expanded_text, target)`` where target is the
        package-local FunctionInfo when resolvable, else None."""
        text = dotted(call.func)
        if text is None:
            return "", None
        mod = func.module
        expanded = mod.expand(text)
        # self.method() -> same-class method
        if text.startswith("self.") and func.class_name:
            rest = text[5:]
            if "." not in rest:
                tgt = mod.functions.get(f"{func.class_name}.{rest}")
                return f"{mod.name}:{func.class_name}.{rest}", tgt
            return expanded, None
        if "." not in text:
            # nested def in the lexical chain
            f: Optional[FunctionInfo] = func
            while f is not None:
                tgt = mod.functions.get(f"{f.qualname}.{text}")
                if tgt is not None:
                    return tgt.label, tgt
                f = f.parent
            # module-level function or class-level sibling
            tgt = mod.functions.get(text)
            if tgt is None and func.class_name:
                tgt = mod.functions.get(f"{func.class_name}.{text}")
            if tgt is not None:
                return tgt.label, tgt
            # imported symbol: from pkg.mod import fn
            imp = mod.imports.get(text)
            if imp and "." in imp:
                owner, _, sym = imp.rpartition(".")
                target_mod = self.find_module(owner)
                if target_mod is not None:
                    tgt = target_mod.functions.get(sym)
                    if tgt is not None:
                        return tgt.label, tgt
            return expanded, None
        # alias.func() where alias maps to a scanned module
        head, _, rest = text.partition(".")
        imp = mod.imports.get(head)
        if imp and "." not in rest:
            target_mod = self.find_module(imp)
            if target_mod is not None:
                tgt = target_mod.functions.get(rest)
                if tgt is not None:
                    return tgt.label, tgt
        return expanded, None

    def resolve_callable_ref(
        self, func: FunctionInfo, expr: ast.AST
    ) -> Tuple[str, Optional[FunctionInfo]]:
        """Resolve a *reference* to a callable (a ``Thread(target=...)``
        operand, not a call site): ``self.method``, bare names through
        the lexical chain / module / imports / ``functools.partial``
        bindings, ``alias.func`` through the import map."""
        if isinstance(expr, ast.Call):
            # functools.partial(fn, ...) passed inline as the target
            if func.module.expand(
                dotted(expr.func) or ""
            ) == "functools.partial" and expr.args:
                return self.resolve_callable_ref(func, expr.args[0])
            return dotted(expr.func) or "", None
        if isinstance(expr, ast.Lambda):
            return "<lambda>", None
        text = dotted(expr)
        if text is None:
            return "", None
        mod = func.module
        if text.startswith("self.") and func.class_name:
            rest = text[5:]
            if "." not in rest:
                tgt = mod.functions.get(f"{func.class_name}.{rest}")
                if tgt is not None:
                    return tgt.label, tgt
            return mod.expand(text), None
        if "." not in text:
            f: Optional[FunctionInfo] = func
            while f is not None:
                tgt = mod.functions.get(f"{f.qualname}.{text}")
                if tgt is not None:
                    return tgt.label, tgt
                if text in f.partial_targets:
                    inner = f.partial_targets[text]
                    tgt = mod.functions.get(inner)
                    if tgt is None and func.class_name:
                        tgt = mod.functions.get(
                            f"{func.class_name}.{inner}"
                        )
                    if tgt is not None:
                        return tgt.label, tgt
                f = f.parent
            tgt = mod.functions.get(text)
            if tgt is None and func.class_name:
                tgt = mod.functions.get(f"{func.class_name}.{text}")
            if tgt is not None:
                return tgt.label, tgt
            imp = mod.imports.get(text)
            if imp and "." in imp:
                owner, _, sym = imp.rpartition(".")
                target_mod = self.find_module(owner)
                if target_mod is not None:
                    tgt = target_mod.functions.get(sym)
                    if tgt is not None:
                        return tgt.label, tgt
            return mod.expand(text), None
        head, _, rest = text.partition(".")
        imp = mod.imports.get(head)
        if imp and "." not in rest:
            target_mod = self.find_module(imp)
            if target_mod is not None:
                tgt = target_mod.functions.get(rest)
                if tgt is not None:
                    return tgt.label, tgt
        return mod.expand(text), None

    def called_labels(self) -> Set[str]:
        """Labels of every function that is the resolved target of at
        least one call anywhere in the scanned tree. Functions *not* in
        this set have no visible in-package caller — the races pass
        treats them as reachable from the main thread."""
        out: Set[str] = set()
        for mod in self.modules.values():
            for func in mod.functions.values():
                for call in calls_in(func.node, skip_nested=False):
                    _, tgt = self.resolve_call(func, call)
                    if tgt is not None:
                        out.add(tgt.label)
        return out
