"""Lock-discipline pass.

Builds an inter-procedural lock graph from every ``threading.Lock`` /
``RLock`` / ``Condition`` acquisition in the scanned tree (``with``
statements; ``queue.Queue().mutex`` counts too), then reports:

- ``lock-order``          both (A, B) and (B, A) nesting observed
                          anywhere in the package (classic inversion)
- ``lock-reentrant``      a non-reentrant lock re-acquired on a call
                          path that already holds it
- ``lock-blocking-call``  a curated blocking operation (socket sends,
                          file/parquet I/O, ``time.sleep``, thread
                          joins, queue gets, futures) under a lock
- ``lock-callback``       an externally-supplied callable (a function
                          parameter, or an ``on_*``/``*callback*``
                          name) invoked under a lock

Held-lock state propagates through package-local calls (``self.m()``,
bare names including closures, ``mod.f()`` through imports) with a
depth cap; nested function *definitions* under a lock are not treated
as running under it.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import (
    FunctionInfo,
    PackageIndex,
    dotted,
    looks_like_lock,
)
from .core import Finding

_MAX_DEPTH = 8

BLOCKING_EXACT = {
    "time.sleep",
    "socket.create_connection",
    "socket.create_server",
    "os.replace",
    "os.rename",
    "json.load",
    "json.dump",
    "subprocess.run",
    "subprocess.check_call",
    "subprocess.check_output",
    "shutil.copy",
    "shutil.copy2",
    "shutil.copytree",
    "shutil.rmtree",
    "shutil.move",
    "select.select",
    "requests.get",
    "requests.post",
}
BLOCKING_SUFFIX = (
    ".sendall",
    ".recv",
    ".accept",
    ".connect",
    ".makefile",
    ".read_text",
    ".write_text",
    ".read_bytes",
    ".write_bytes",
    ".to_parquet",
    ".to_csv",
    ".read_parquet",
    ".read_csv",
    ".read_schema",
    ".communicate",
    ".urlopen",
)
_CALLBACKISH = re.compile(r"(^on_[a-z0-9_]+$)|callback|(^|_)cb$")


def _short(lock_id: str) -> str:
    return lock_id.split(":", 1)[-1]


def resolve_lock_expr(
    func: FunctionInfo, expr: ast.AST
) -> Optional[str]:
    """Stable identity of the lock named by ``expr`` in ``func``, or
    None when the expression doesn't look like a lock. Shared by the
    lock-discipline and data-race passes so both agree on which lock a
    ``with`` statement acquires."""
    text = dotted(expr)
    if text is None:
        return None
    mod = func.module
    if text.startswith("self.") and func.class_name:
        rest = text[5:]
        known = mod.attr_locks.get(f"{func.class_name}.{rest}")
        if known:
            return known
        if looks_like_lock(rest.split(".")[-1]):
            return f"{mod.name}:{func.class_name}.{rest}"
        return None
    if "." not in text:
        f: Optional[FunctionInfo] = func
        while f is not None:
            if text in f.local_locks:
                return f.local_locks[text]
            f = f.parent
        if text in mod.module_locks:
            return mod.module_locks[text]
        if looks_like_lock(text):
            return f"{mod.name}:{func.qualname}.{text}"
        return None
    # attribute chain on an arbitrary object: only accept clearly
    # lock-ish tails (e.g. ``jm.lock``, ``self._queue.mutex``).
    # Module-scoped identity (not per-function): the same chain text
    # in two functions is taken to mean the same lock, which is what
    # lets cross-function inversions on shared objects surface.
    tail = text.split(".")[-1]
    if looks_like_lock(tail):
        return f"{mod.name}:{text}"
    return None


class _LockWalker:
    def __init__(self, index: PackageIndex):
        self.index = index
        self.findings: List[Finding] = []
        self._seen_fp: Set[str] = set()
        # ordered pair -> list of (path, line, "A -> B while in symbol")
        self.pairs: Dict[
            Tuple[str, str], List[Tuple[str, int, str]]
        ] = {}
        self.rlocks: Set[str] = set()
        self._visited: Set[Tuple[str, frozenset]] = set()

    # -- lock resolution ----------------------------------------------
    def _resolve_lock(
        self, func: FunctionInfo, expr: ast.AST
    ) -> Optional[str]:
        return resolve_lock_expr(func, expr)

    # -- finding emission ---------------------------------------------
    def _emit(self, f: Finding) -> None:
        fp = f.fingerprint() + f"@{f.path}:{f.line}"
        if fp in self._seen_fp:
            return
        self._seen_fp.add(fp)
        self.findings.append(f)

    def _check_call(
        self,
        func: FunctionInfo,
        call: ast.Call,
        held: Tuple[Tuple[str, str], ...],
        chain: Tuple[str, ...],
        depth: int,
    ) -> None:
        text, target = self.index.resolve_call(func, call)
        raw = dotted(call.func) or ""
        via = (
            ""
            if len(chain) <= 1
            else f" (call chain {' -> '.join(chain)})"
        )
        held_names = ", ".join(_short(h[0]) for h in held)
        # blocking?
        blocking = text in BLOCKING_EXACT or any(
            text.endswith(s) for s in BLOCKING_SUFFIX
        )
        if not blocking and isinstance(call.func, ast.Name):
            if call.func.id == "open":
                blocking = True
        if not blocking and raw.endswith(".join"):
            recv = raw[: -len(".join")]
            f: Optional[FunctionInfo] = func
            while f is not None and not blocking:
                if recv in f.thread_vars:
                    blocking = True
                f = f.parent
        if not blocking and raw.endswith(".get"):
            recv = raw[: -len(".get")]
            f = func
            while f is not None and not blocking:
                if recv in f.queue_vars:
                    blocking = True
                f = f.parent
        if blocking:
            self._emit(
                Finding(
                    rule="lock-blocking-call",
                    path=func.module.path,
                    line=call.lineno,
                    symbol=func.label,
                    key=f"{_short(held[-1][0])}|{text or raw}",
                    message=(
                        f"blocking call `{raw}` while holding "
                        f"[{held_names}]{via}"
                    ),
                )
            )
            return
        # externally-supplied callback?
        cb_name: Optional[str] = None
        if isinstance(call.func, ast.Name):
            name = call.func.id
            if name in func.all_params() or _CALLBACKISH.search(name):
                cb_name = name
        elif raw.startswith("self.") and _CALLBACKISH.search(
            raw.split(".")[-1]
        ):
            # calling a stored callback attribute under a lock
            cb_name = raw
        if cb_name is not None and target is None:
            self._emit(
                Finding(
                    rule="lock-callback",
                    path=func.module.path,
                    line=call.lineno,
                    symbol=func.label,
                    key=f"{_short(held[-1][0])}|{cb_name}",
                    message=(
                        f"callback `{cb_name}` invoked while holding "
                        f"[{held_names}]{via}"
                    ),
                )
            )
            return
        # inter-procedural propagation
        if target is not None and depth < _MAX_DEPTH:
            key = (
                target.label,
                frozenset(h[0] for h in held),
            )
            if key in self._visited:
                return
            self._visited.add(key)
            self._walk_body(
                target,
                list(target.node.body),
                held,
                chain + (target.qualname,),
                depth + 1,
            )

    # -- statement walking --------------------------------------------
    def _walk_body(
        self,
        func: FunctionInfo,
        body: List[ast.AST],
        held: Tuple[Tuple[str, str], ...],
        chain: Tuple[str, ...],
        depth: int,
    ) -> None:
        for stmt in body:
            self._visit(func, stmt, held, chain, depth)

    def _visit(
        self,
        func: FunctionInfo,
        node: ast.AST,
        held: Tuple[Tuple[str, str], ...],
        chain: Tuple[str, ...],
        depth: int,
    ) -> None:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef)
        ):
            return  # deferred execution: not under this lock
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                lock_id = self._resolve_lock(func, item.context_expr)
                if lock_id is None:
                    # still look for calls inside the item expression
                    for sub in ast.walk(item.context_expr):
                        if isinstance(sub, ast.Call) and held:
                            self._check_call(
                                func, sub, held, chain, depth
                            )
                    continue
                site = (func.module.path, node.lineno)
                for held_id, _ in new_held:
                    if held_id == lock_id:
                        if lock_id not in self.rlocks:
                            self._emit(
                                Finding(
                                    rule="lock-reentrant",
                                    path=func.module.path,
                                    line=node.lineno,
                                    symbol=func.label,
                                    key=_short(lock_id),
                                    message=(
                                        f"`{_short(lock_id)}` re-"
                                        "acquired while already held "
                                        f"(chain {' -> '.join(chain)})"
                                    ),
                                )
                            )
                        continue
                    self.pairs.setdefault(
                        (held_id, lock_id), []
                    ).append((site[0], site[1], func.label))
                new_held = new_held + (
                    (lock_id, f"{site[0]}:{site[1]}"),
                )
            self._walk_body(func, list(node.body), new_held, chain, depth)
            return
        if isinstance(node, ast.Call):
            if held:
                self._check_call(func, node, held, chain, depth)
            for child in ast.iter_child_nodes(node):
                self._visit(func, child, held, chain, depth)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(func, child, held, chain, depth)

    # -- entry ---------------------------------------------------------
    def run(self) -> List[Finding]:
        # RLocks are reentrant: no lock-reentrant findings for them
        for mod in self.index.modules.values():
            self.rlocks.update(mod.rlock_ids)
        for mod in sorted(self.index.modules.values(), key=lambda m: m.path):
            for qual in sorted(mod.functions):
                func = mod.functions[qual]
                self._visited.clear()
                self._walk_body(
                    func, list(func.node.body), (), (qual,), 0
                )
        # inversions
        for (a, b), sites in sorted(self.pairs.items()):
            if a >= b:
                continue
            rev = self.pairs.get((b, a))
            if not rev:
                continue
            s1, s2 = sites[0], rev[0]
            self._emit(
                Finding(
                    rule="lock-order",
                    path=s1[0],
                    line=s1[1],
                    symbol=s1[2],
                    key=f"{_short(a)}<->{_short(b)}",
                    fp=f"lock-order|{_short(a)}<->{_short(b)}",
                    message=(
                        f"lock order inversion: `{_short(a)}` -> "
                        f"`{_short(b)}` at {s1[0]}:{s1[1]} but "
                        f"`{_short(b)}` -> `{_short(a)}` at "
                        f"{s2[0]}:{s2[1]}"
                    ),
                )
            )
        return self.findings


def run(index: PackageIndex) -> List[Finding]:
    return _LockWalker(index).run()
