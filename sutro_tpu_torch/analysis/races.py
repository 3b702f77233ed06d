"""Data-race and atomicity analysis over the thread fleet.

Three cooperating pieces over the shared AST index:

- **thread-root inventory** — every ``threading.Thread(target=...)``
  and ``threading.Timer`` spawn site in the tree, resolved to its
  package-local target where possible, with daemon / loop-spawn flags
  (``python -m sutro_tpu_torch.analysis --threads`` dumps it).
- **Eraser-style lockset pass** (``shared-state-unlocked``,
  ``lockset-inconsistent``) — an interprocedural walk from every root
  (each spawned target, plus one ``<main>`` pseudo-root covering the
  functions with no resolvable in-package caller) records each
  ``self.<field>`` read/write together with the set of locks held.
  A field touched from two distinct roots (or one root spawned in a
  loop) with at least one non-exempt write and an empty pairwise
  lockset intersection is a race: ``shared-state-unlocked`` when one
  side holds nothing at all, ``lockset-inconsistent`` when both sides
  lock — just not the same lock.
- **atomicity pass** (``check-then-act``) — two sequential ``with``
  blocks on the same lock in one function where the first reads a
  field into a local and the second writes the field using that local:
  the classic dropped-update window across a release/reacquire.

Engine-aware happens-before edges keep the lockset pass honest:

- *queue/event handoff*: a function that touches a sync-object field
  (``self.q.put/get``, ``self.evt.set/wait``) holds a pseudo-lock
  token ``hb:<field>`` for its accesses, so producer/consumer pairs
  synchronised through that object intersect on the token.
- *publication*: accesses in the function that spawns root R are
  ordered before R until R's ``.start()`` call, and everything in
  ``__init__`` is ordered before roots the class spawns elsewhere
  (the constructor completes before anyone can call ``.start()``).
- *bounded join*: accesses after ``t.join(...)`` in the same function
  are ordered after root ``t``.
- sync-object fields themselves (locks, queues, events, threads,
  condition variables) are internally serialized and never tracked
  as shared state.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .callgraph import (
    EVENT_CTORS,
    LOCK_CTORS,
    QUEUE_CTORS,
    THREAD_CTORS,
    FunctionInfo,
    PackageIndex,
    calls_in,
    dotted,
    looks_like_lock,
)
from .core import Finding
from .locks import resolve_lock_expr

_MAX_DEPTH = 8

# fields holding these are synchronization/thread objects, not shared
# state — their own methods serialize internally
_SYNC_CTORS = (
    set(LOCK_CTORS) | set(QUEUE_CTORS) | THREAD_CTORS | EVENT_CTORS
)

# method calls on a field that mutate the underlying container
_MUTATORS = {
    "append",
    "appendleft",
    "add",
    "clear",
    "discard",
    "extend",
    "insert",
    "pop",
    "popleft",
    "popitem",
    "remove",
    "setdefault",
    "update",
}

# any method call on a sync-object field grants the function the
# field's happens-before token (put/get, set/wait/clear, join, ...)
_HB_CTORS = set(QUEUE_CTORS) | {"threading.Event"}

# ctors whose instances a mutator-method call actually mutates in
# place; a ``.update()``/``.pop()`` on a package-local class (JobStore,
# MetricsBus, ...) is a domain call that synchronizes internally —
# its own fields are analyzed separately
_CONTAINER_CTORS = {
    "set",
    "dict",
    "list",
    "frozenset",
    "collections.deque",
    "collections.OrderedDict",
    "collections.defaultdict",
    "collections.Counter",
}

MAIN_ROOT = "<main>"


@dataclasses.dataclass
class ThreadRoot:
    """One distinct spawn target (sites spawning the same target
    merge into a single root)."""

    root_id: str  # target label, or spawn-site text when unresolved
    target: Optional[FunctionInfo]
    kind: str  # "thread" | "timer" | "main"
    sites: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list
    )  # (path, line, spawning function label)
    daemon: bool = False
    multi: bool = False  # spawned in a loop or from >1 site

    def describe(self) -> str:
        flags = []
        if self.daemon:
            flags.append("daemon")
        if self.multi:
            flags.append("multi")
        where = ", ".join(f"{p}:{ln}" for p, ln, _ in self.sites[:3])
        extra = f" (+{len(self.sites) - 3} more)" if len(
            self.sites
        ) > 3 else ""
        tag = f" [{'/'.join(flags)}]" if flags else ""
        return f"{self.kind:6s} {self.root_id}{tag} <- {where}{extra}"


@dataclasses.dataclass
class _Spawn:
    """One spawn site, before merging into roots."""

    root_id: str
    target: Optional[FunctionInfo]
    kind: str
    path: str
    line: int
    spawner: FunctionInfo
    var: Optional[str]  # ``t`` / ``self._worker`` when assigned
    daemon: bool
    in_loop: bool
    started_inline: bool  # ``threading.Thread(...).start()``


@dataclasses.dataclass
class _Access:
    field: str  # "{mod}:{Class}.{attr}"
    attr: str  # "{Class}.{attr}"
    write: bool
    root: str
    locks: FrozenSet[str]
    path: str
    line: int
    symbol: str
    before: FrozenSet[str]  # roots this access is ordered before
    after: FrozenSet[str]  # roots this access is ordered after

    def ordered_against(self, root: str) -> bool:
        return root in self.before or root in self.after


def _bool_kw(call: ast.Call, name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == name:
            return isinstance(
                kw.value, ast.Constant
            ) and kw.value.value is True
    return False


def _target_expr(call: ast.Call, ctor: str) -> Optional[ast.AST]:
    if ctor == "threading.Timer":
        for kw in call.keywords:
            if kw.arg == "function":
                return kw.value
        return call.args[1] if len(call.args) > 1 else None
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    return call.args[0] if call.args else None


class _RaceAnalysis:
    def __init__(self, index: PackageIndex):
        self.index = index
        self.spawns: List[_Spawn] = []
        self.roots: Dict[str, ThreadRoot] = {}
        self.accesses: Dict[str, List[_Access]] = {}
        self.findings: List[Finding] = []
        # per-root interprocedural visited set
        self._visited: Set[Tuple] = set()
        # roots spawned from each class: "{mod}:{Class}" -> root ids
        self._class_roots: Dict[str, Set[str]] = {}
        self._called: Set[str] = set()
        self._hb_cache: Dict[str, FrozenSet[str]] = {}

    # -- inventory -----------------------------------------------------
    def collect_roots(self) -> None:
        for mod in sorted(
            self.index.modules.values(), key=lambda m: m.path
        ):
            for qual in sorted(mod.functions):
                func = mod.functions[qual]
                self._collect_spawns_in(func)
        for sp in self.spawns:
            root = self.roots.get(sp.root_id)
            if root is None:
                root = ThreadRoot(
                    root_id=sp.root_id, target=sp.target, kind=sp.kind
                )
                self.roots[sp.root_id] = root
            root.sites.append((sp.path, sp.line, sp.spawner.label))
            root.daemon = root.daemon or sp.daemon
            root.multi = (
                root.multi or sp.in_loop or len(root.sites) > 1
            )
            if sp.spawner.class_name:
                key = (
                    f"{sp.spawner.module.name}:"
                    f"{sp.spawner.class_name}"
                )
                self._class_roots.setdefault(key, set()).add(
                    sp.root_id
                )

    def _collect_spawns_in(self, func: FunctionInfo) -> None:
        mod = func.module
        # calls_in() walks whole subtrees and scan() recurses into the
        # same statements, so a nested ctor call is yielded once per
        # ancestor level — dedupe by node identity (first visit wins:
        # it is the one with the assignment var in scope)
        seen_calls: Set[int] = set()

        def scan(node: ast.AST, in_loop: bool) -> None:
            for stmt in ast.iter_child_nodes(node):
                if isinstance(
                    stmt,
                    (
                        ast.FunctionDef,
                        ast.AsyncFunctionDef,
                        ast.ClassDef,
                        ast.Lambda,
                    ),
                ):
                    continue
                loop_here = in_loop or isinstance(
                    stmt, (ast.For, ast.AsyncFor, ast.While)
                )
                var: Optional[str] = None
                value: Optional[ast.AST] = None
                if isinstance(stmt, ast.Assign) and len(
                    stmt.targets
                ) == 1:
                    var = dotted(stmt.targets[0])
                    value = stmt.value
                for call in calls_in(stmt):
                    ctor = mod.expand(dotted(call.func) or "")
                    started_inline = False
                    if ctor not in THREAD_CTORS:
                        # threading.Thread(...).start() in one step
                        if (
                            isinstance(call.func, ast.Attribute)
                            and call.func.attr == "start"
                            and isinstance(call.func.value, ast.Call)
                        ):
                            inner = call.func.value
                            ictor = mod.expand(
                                dotted(inner.func) or ""
                            )
                            if ictor in THREAD_CTORS:
                                ctor = ictor
                                call = inner
                                started_inline = True
                            else:
                                continue
                        else:
                            continue
                    tgt_expr = _target_expr(call, ctor)
                    text, target = ("", None)
                    if tgt_expr is not None:
                        text, target = (
                            self.index.resolve_callable_ref(
                                func, tgt_expr
                            )
                        )
                    if id(call) in seen_calls:
                        continue
                    seen_calls.add(id(call))
                    root_id = (
                        target.label
                        if target is not None
                        else text
                        or f"{mod.path}:{call.lineno}"
                    )
                    self.spawns.append(
                        _Spawn(
                            root_id=root_id,
                            target=target,
                            kind=(
                                "timer"
                                if ctor == "threading.Timer"
                                else "thread"
                            ),
                            path=mod.path,
                            line=call.lineno,
                            spawner=func,
                            var=(
                                var
                                if value is not None
                                and call is value
                                else None
                            ),
                            daemon=_bool_kw(call, "daemon"),
                            in_loop=loop_here,
                            started_inline=started_inline,
                        )
                    )
                scan(stmt, loop_here)

        scan(func.node, False)

    # -- field classification -----------------------------------------
    def _field_of(
        self, func: FunctionInfo, node: ast.Attribute
    ) -> Optional[Tuple[str, str]]:
        """``self.<attr>`` in a method -> (field_key, attr_key), with
        sync objects, locks, and methods filtered out."""
        if not (
            isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and func.class_name
        ):
            return None
        mod = func.module
        attr_key = f"{func.class_name}.{node.attr}"
        if attr_key in mod.functions:  # method reference, not state
            return None
        if attr_key in mod.attr_locks or looks_like_lock(node.attr):
            return None
        if mod.attr_ctors.get(attr_key) in _SYNC_CTORS:
            return None
        return f"{mod.name}:{attr_key}", attr_key

    def _is_container(
        self, func: FunctionInfo, node: ast.AST
    ) -> bool:
        """True when ``self.<attr>`` is known (or assumed) to hold a
        plain container, so mutator-method calls write the field."""
        if not (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and func.class_name
        ):
            return True  # non-field receivers keep old behaviour
        ctor = func.module.attr_ctors.get(
            f"{func.class_name}.{node.attr}"
        )
        return ctor is None or ctor in _CONTAINER_CTORS

    def _hb_tokens(self, func: FunctionInfo) -> FrozenSet[str]:
        """Happens-before pseudo-locks granted to every access in
        ``func``: one token per sync-object field the function calls a
        method on (queue put/get, event set/wait, ...)."""
        cached = self._hb_cache.get(func.label)
        if cached is not None:
            return cached
        toks: Set[str] = set()
        mod = func.module
        if func.class_name:
            for call in calls_in(func.node):
                if not isinstance(call.func, ast.Attribute):
                    continue
                recv = dotted(call.func.value)
                if not recv or not recv.startswith("self."):
                    continue
                attr = recv[5:]
                if "." in attr:
                    continue
                attr_key = f"{func.class_name}.{attr}"
                if mod.attr_ctors.get(attr_key) in _HB_CTORS:
                    toks.add(f"hb:{mod.name}:{attr_key}")
        out = frozenset(toks)
        self._hb_cache[func.label] = out
        return out

    # -- access walk ---------------------------------------------------
    def walk_all(self) -> None:
        self._called = self.index.called_labels()
        target_labels = {
            r.target.label
            for r in self.roots.values()
            if r.target is not None
        }
        # each resolved spawn target is a root
        for root in self.roots.values():
            if root.target is None:
                continue
            self._visited.clear()
            self._walk_function(
                root.target,
                root.root_id,
                held=frozenset(),
                before=frozenset(),
                after=frozenset(),
                depth=0,
            )
        # one <main> pseudo-root from every function with no visible
        # in-package caller (conservative: unresolvable call sites
        # leave the callee main-reachable)
        self._visited.clear()
        for mod in sorted(
            self.index.modules.values(), key=lambda m: m.path
        ):
            for qual in sorted(mod.functions):
                func = mod.functions[qual]
                if func.label in self._called:
                    continue
                if func.label in target_labels:
                    continue
                before: FrozenSet[str] = frozenset()
                if func.class_name and func.qualname.endswith(
                    "__init__"
                ):
                    # the ctor completes before anyone can .start()
                    # a thread this class spawns elsewhere
                    before = frozenset(
                        self._class_roots.get(
                            f"{mod.name}:{func.class_name}",
                            (),
                        )
                    )
                self._walk_function(
                    func,
                    MAIN_ROOT,
                    held=frozenset(),
                    before=before,
                    after=frozenset(),
                    depth=0,
                )

    def _spawn_vars_for(
        self, func: FunctionInfo
    ) -> Dict[str, str]:
        """thread-variable text -> root id, visible from ``func``:
        locals assigned in this function plus ``self.<attr>`` threads
        spawned anywhere in the same class."""
        out: Dict[str, str] = {}
        for sp in self.spawns:
            if sp.var is None:
                continue
            if sp.spawner is func:
                out[sp.var] = sp.root_id
            elif (
                sp.var.startswith("self.")
                and func.class_name
                and sp.spawner.class_name == func.class_name
                and sp.spawner.module is func.module
            ):
                out[sp.var] = sp.root_id
        return out

    def _walk_function(
        self,
        func: FunctionInfo,
        root: str,
        held: FrozenSet[str],
        before: FrozenSet[str],
        after: FrozenSet[str],
        depth: int,
    ) -> None:
        key = (root, func.label, held, before, after)
        if key in self._visited or depth > _MAX_DEPTH:
            return
        self._visited.add(key)
        held = held | self._hb_tokens(func)
        spawn_vars = self._spawn_vars_for(func)
        # roots spawned *in this function*: ordered-after this
        # function's accesses until their .start() is seen
        local_pre: Set[str] = {
            sp.root_id
            for sp in self.spawns
            if sp.spawner is func and not sp.started_inline
        }
        state = {
            "before": set(before) | local_pre,
            "after": set(after),
        }
        self._visit(func, func.node.body, root, held, state, depth)

    def _visit(
        self,
        func: FunctionInfo,
        body: List[ast.AST],
        root: str,
        held: FrozenSet[str],
        state: Dict[str, Set[str]],
        depth: int,
    ) -> None:
        for stmt in body:
            self._visit_node(func, stmt, root, held, state, depth)

    def _visit_node(
        self,
        func: FunctionInfo,
        node: ast.AST,
        root: str,
        held: FrozenSet[str],
        state: Dict[str, Set[str]],
        depth: int,
    ) -> None:
        if isinstance(
            node,
            (
                ast.FunctionDef,
                ast.AsyncFunctionDef,
                ast.Lambda,
                ast.ClassDef,
            ),
        ):
            return  # deferred execution
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                lock_id = resolve_lock_expr(func, item.context_expr)
                if lock_id is not None:
                    new_held = new_held | {lock_id}
                else:
                    self._visit_node(
                        func,
                        item.context_expr,
                        root,
                        held,
                        state,
                        depth,
                    )
            self._visit(
                func, list(node.body), root, new_held, state, depth
            )
            return
        if isinstance(node, ast.Assign):
            self._visit_node(
                func, node.value, root, held, state, depth
            )
            for t in node.targets:
                self._record_store(func, t, root, held, state)
            return
        if isinstance(node, ast.AugAssign):
            self._visit_node(
                func, node.value, root, held, state, depth
            )
            # read-modify-write: record both sides
            self._record_load(func, node.target, root, held, state)
            self._record_store(
                func, node.target, root, held, state
            )
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._record_store(func, t, root, held, state)
            return
        if isinstance(node, ast.Call):
            self._handle_call(func, node, root, held, state, depth)
            return
        if isinstance(node, ast.Attribute) and isinstance(
            node.ctx, ast.Load
        ):
            self._record_access(
                func, node, False, root, held, state
            )
            self._visit_node(
                func, node.value, root, held, state, depth
            )
            return
        for child in ast.iter_child_nodes(node):
            self._visit_node(func, child, root, held, state, depth)

    def _record_store(
        self,
        func: FunctionInfo,
        target: ast.AST,
        root: str,
        held: FrozenSet[str],
        state: Dict[str, Set[str]],
    ) -> None:
        if isinstance(target, ast.Attribute):
            self._record_access(
                func, target, True, root, held, state
            )
        elif isinstance(target, ast.Subscript):
            # self.x[k] = v mutates self.x
            if isinstance(target.value, ast.Attribute):
                self._record_access(
                    func, target.value, True, root, held, state
                )
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_store(func, elt, root, held, state)
        elif isinstance(target, ast.Starred):
            self._record_store(
                func, target.value, root, held, state
            )

    def _record_load(
        self,
        func: FunctionInfo,
        target: ast.AST,
        root: str,
        held: FrozenSet[str],
        state: Dict[str, Set[str]],
    ) -> None:
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            self._record_access(
                func, node, False, root, held, state
            )

    def _record_access(
        self,
        func: FunctionInfo,
        node: ast.Attribute,
        write: bool,
        root: str,
        held: FrozenSet[str],
        state: Dict[str, Set[str]],
    ) -> None:
        resolved = self._field_of(func, node)
        if resolved is None:
            return
        field, attr_key = resolved
        self.accesses.setdefault(field, []).append(
            _Access(
                field=field,
                attr=attr_key,
                write=write,
                root=root,
                locks=held,
                path=func.module.path,
                line=node.lineno,
                symbol=func.label,
                before=frozenset(state["before"]),
                after=frozenset(state["after"]),
            )
        )

    def _handle_call(
        self,
        func: FunctionInfo,
        call: ast.Call,
        root: str,
        held: FrozenSet[str],
        state: Dict[str, Set[str]],
        depth: int,
    ) -> None:
        raw = dotted(call.func) or ""
        # .start()/.join() on a tracked thread variable flips the
        # publication/join ordering for the rest of this function
        if raw.endswith(".start") or raw.endswith(".join"):
            recv = raw.rsplit(".", 1)[0]
            rid = self._spawn_vars_for(func).get(recv)
            if rid is not None:
                if raw.endswith(".start"):
                    state["before"].discard(rid)
                else:
                    state["after"].add(rid)
        # mutator method on a field: self.x.append(...) writes x
        if isinstance(call.func, ast.Attribute):
            if call.func.attr in _MUTATORS and isinstance(
                call.func.value, ast.Attribute
            ) and self._is_container(func, call.func.value):
                self._record_access(
                    func,
                    call.func.value,
                    True,
                    root,
                    held,
                    state,
                )
            else:
                self._visit_node(
                    func, call.func.value, root, held, state, depth
                )
        # arguments (and the receiver chain) carry reads
        for arg in call.args:
            self._visit_node(func, arg, root, held, state, depth)
        for kw in call.keywords:
            self._visit_node(
                func, kw.value, root, held, state, depth
            )
        # interprocedural propagation
        _, target = self.index.resolve_call(func, call)
        if target is not None:
            self._walk_function(
                target,
                root,
                held=held,
                before=frozenset(state["before"]),
                after=frozenset(state["after"]),
                depth=depth + 1,
            )

    # -- lockset verdicts ---------------------------------------------
    def lockset_findings(self) -> None:
        for field in sorted(self.accesses):
            accs = self.accesses[field]
            pair = self._best_conflict(accs)
            if pair is None:
                continue
            a, b = pair
            unlocked = not a.locks or not b.locks
            rule = (
                "shared-state-unlocked"
                if unlocked
                else "lockset-inconsistent"
            )
            short = field.split(":", 1)[-1]
            self.findings.append(
                Finding(
                    rule=rule,
                    path=a.path,
                    line=a.line,
                    symbol=a.symbol,
                    key=short,
                    message=(
                        f"`{short}` {_kind(a)} by {_who(a)} "
                        f"holding {_locks(a)} and {_kind(b)} by "
                        f"{_who(b)} at {b.path}:{b.line} holding "
                        f"{_locks(b)} — no common lock or "
                        "happens-before edge"
                    ),
                )
            )

    def _best_conflict(
        self, accs: List[_Access]
    ) -> Optional[Tuple[_Access, _Access]]:
        """Deterministic worst conflicting pair for one field, or
        None. Preference: a pair with an unlocked write first, then
        any unlocked access, then inconsistent locksets."""
        best: Optional[Tuple[int, _Access, _Access]] = None
        seen: Set[Tuple] = set()
        for a in accs:
            for b in accs:
                if not self._conflicts(a, b):
                    continue
                # canonical orientation: flag the write (prefer the
                # unlocked one) as the primary site
                x, y = a, b
                if (y.write, not y.locks) > (x.write, not x.locks):
                    x, y = y, x
                sig = (x.path, x.line, x.root, y.path, y.line, y.root)
                if sig in seen:
                    continue
                seen.add(sig)
                rank = (
                    0
                    if (x.write and not x.locks)
                    else 1
                    if (not x.locks or not y.locks)
                    else 2
                )
                cand = (rank, x, y)
                if best is None or (
                    cand[0],
                    x.path,
                    x.line,
                    y.path,
                    y.line,
                ) < (
                    best[0],
                    best[1].path,
                    best[1].line,
                    best[2].path,
                    best[2].line,
                ):
                    best = cand
        return None if best is None else (best[1], best[2])

    def _conflicts(self, a: _Access, b: _Access) -> bool:
        if not (a.write or b.write):
            return False
        if a.root == b.root:
            root = self.roots.get(a.root)
            if root is None or not root.multi:
                return False
            if a is b and not a.write:
                return False
        if a.ordered_against(b.root) or b.ordered_against(a.root):
            return False
        if a.locks & b.locks:
            return False
        return True

    # -- atomicity -----------------------------------------------------
    def atomicity_findings(self) -> None:
        for mod in sorted(
            self.index.modules.values(), key=lambda m: m.path
        ):
            for qual in sorted(mod.functions):
                self._check_then_act(mod.functions[qual])

    def _own_stmts(self, node: ast.AST) -> List[List[ast.stmt]]:
        """Every statement list in ``node``'s own body (nested defs
        excluded — they are indexed as their own functions)."""
        out: List[List[ast.stmt]] = []
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(n, field, None)
                if isinstance(sub, list) and sub and isinstance(
                    sub[0], ast.stmt
                ):
                    out.append(sub)
            for h in getattr(n, "handlers", []) or []:
                out.append(h.body)
            for child in ast.iter_child_nodes(n):
                if isinstance(
                    child,
                    (
                        ast.FunctionDef,
                        ast.AsyncFunctionDef,
                        ast.ClassDef,
                        ast.Lambda,
                    ),
                ):
                    continue
                if isinstance(child, ast.stmt) or isinstance(
                    child, ast.excepthandler
                ):
                    stack.append(child)
        return out

    def _fields_read(
        self, func: FunctionInfo, node: ast.AST
    ) -> Set[str]:
        out: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and isinstance(
                sub.ctx, ast.Load
            ):
                resolved = self._field_of(func, sub)
                if resolved is not None:
                    out.add(resolved[1])
        return out

    def _fields_written(
        self, func: FunctionInfo, node: ast.AST
    ) -> Set[str]:
        out: Set[str] = set()
        for sub in ast.walk(node):
            tgt: Optional[ast.AST] = None
            if isinstance(sub, ast.Attribute) and isinstance(
                sub.ctx, (ast.Store, ast.Del)
            ):
                tgt = sub
            elif isinstance(sub, ast.Subscript) and isinstance(
                sub.ctx, (ast.Store, ast.Del)
            ):
                tgt = sub.value
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _MUTATORS
                and self._is_container(func, sub.func.value)
            ):
                tgt = sub.func.value
            if isinstance(tgt, ast.Attribute):
                resolved = self._field_of(func, tgt)
                if resolved is not None:
                    out.add(resolved[1])
        return out

    @staticmethod
    def _rebound_between(
        between: List[ast.stmt], var: str
    ) -> bool:
        """True when ``var`` is rebound to an unrelated value between
        the two lock blocks — a plain assignment whose right-hand side
        doesn't mention ``var`` severs the check-then-act data flow
        (``tok = build_fresh()``), while derivations (``cur = cur + 1``
        or ``cur += 1``) keep it."""
        for stmt in between:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Assign):
                    continue
                hit = any(
                    isinstance(t, ast.Name) and t.id == var
                    for t in sub.targets
                )
                if hit and var not in {
                    n.id
                    for n in ast.walk(sub.value)
                    if isinstance(n, ast.Name)
                }:
                    return True
        return False

    def _check_then_act(self, func: FunctionInfo) -> None:
        for body in self._own_stmts(func.node):
            withs: List[Tuple[int, ast.stmt, Set[str]]] = []
            for pos, stmt in enumerate(body):
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    ids = {
                        resolve_lock_expr(func, it.context_expr)
                        for it in stmt.items
                    }
                    ids.discard(None)
                    if ids:
                        withs.append((pos, stmt, ids))  # type: ignore[arg-type]
            for i, (p1, w1, l1) in enumerate(withs):
                reads: Dict[str, Set[str]] = {}
                for sub in ast.walk(w1):
                    if (
                        isinstance(sub, ast.Assign)
                        and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Name)
                    ):
                        fields = self._fields_read(func, sub.value)
                        if fields:
                            reads.setdefault(
                                sub.targets[0].id, set()
                            ).update(fields)
                if not reads:
                    continue
                for p2, w2, l2 in withs[i + 1 :]:
                    common = l1 & l2
                    if not common:
                        continue
                    written = self._fields_written(func, w2)
                    if not written:
                        continue
                    used = {
                        n.id
                        for n in ast.walk(w2)
                        if isinstance(n, ast.Name)
                    }
                    between = body[p1 + 1 : p2]
                    for var in sorted(reads):
                        hit = sorted(reads[var] & written)
                        if not hit or var not in used:
                            continue
                        if self._rebound_between(between, var):
                            continue
                        lock = sorted(common)[0].split(":", 1)[-1]
                        self.findings.append(
                            Finding(
                                rule="check-then-act",
                                path=func.module.path,
                                line=w2.lineno,
                                symbol=func.label,
                                key=f"{hit[0]}|{var}",
                                message=(
                                    f"`{var}` read from "
                                    f"`{hit[0]}` under `{lock}` at "
                                    f"line {w1.lineno} is used to "
                                    f"write `{hit[0]}` after the "
                                    "lock was released and "
                                    "re-acquired — the update can "
                                    "be lost to a concurrent "
                                    "writer in the window"
                                ),
                            )
                        )
                        break  # one finding per with-pair

    # -- entry ---------------------------------------------------------
    def run(self) -> List[Finding]:
        self.collect_roots()
        self.walk_all()
        self.lockset_findings()
        self.atomicity_findings()
        self.findings.sort(
            key=lambda f: (f.path, f.line, f.rule, f.key)
        )
        return self.findings


def _kind(a: _Access) -> str:
    return "written" if a.write else "read"


def _who(a: _Access) -> str:
    root = "main thread" if a.root == MAIN_ROOT else f"root {a.root}"
    return f"{a.symbol} ({root})"


def _locks(a: _Access) -> str:
    if not a.locks:
        return "no locks"
    names = sorted(x.split(":", 1)[-1] for x in a.locks)
    return "[" + ", ".join(names) + "]"


def run(index: PackageIndex) -> List[Finding]:
    return _RaceAnalysis(index).run()


def inventory(index: PackageIndex) -> List[ThreadRoot]:
    """The thread-root inventory alone (``--threads``)."""
    rr = _RaceAnalysis(index)
    rr.collect_roots()
    return sorted(rr.roots.values(), key=lambda r: r.root_id)
