"""Wire-protocol additivity pass for the dp/elastic frame schema.

The dp coordinator/worker protocol (``engine/dphost.py``) is strictly
additive: old coordinators must parse frames from new workers and vice
versa across a resume boundary, so frame keys are only ever *added* —
removing or renaming one is a cross-version outage. This pass extracts
the send-side frame-key sets straight from the AST (dict literals with
a constant ``"t"`` discriminator, plus later ``msg["key"] = ...``
subscript augments on the same variable) and checks them against the
checked-in ``analysis/wire_schema.json``:

- ``wire-key-removed`` — a frame type or key present in the schema is
  no longer produced by any sender. Adding frames/keys is fine (run
  ``make lint-schema`` to fold them into the schema).
- ``wire-strict-parse`` — a recv path that rejects unknown keys or
  asserts an exact frame shape (``set(m) == {...}`` guards, or a raise
  on unrecognized keys while iterating the frame). Parsers must ignore
  what they don't understand.

Wire modules are recognized structurally: they define a ``_send``
function or their module name contains ``dphost``.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Set

from .callgraph import ModuleInfo, PackageIndex, dotted
from .core import Finding

DEFAULT_SCHEMA_PATH = Path(__file__).resolve().parent / "wire_schema.json"


def is_wire_module(mod: ModuleInfo) -> bool:
    return "dphost" in mod.name.rsplit(".", 1)[-1] or "_send" in mod.functions


def _literal_frame(node: ast.Dict) -> Optional[Dict[str, Set[str]]]:
    """``{"t": "res", ...}`` -> {"res": {const keys}}; None otherwise."""
    t_val: Optional[str] = None
    keys: Set[str] = set()
    for k, v in zip(node.keys, node.values):
        if k is None:  # **spread — dynamic extras are fine (additive)
            continue
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue
        keys.add(k.value)
        if k.value == "t" and isinstance(v, ast.Constant) and isinstance(
            v.value, str
        ):
            t_val = v.value
    if t_val is None:
        return None
    return {t_val: keys}


def extract_frames(index: PackageIndex) -> Dict[str, Set[str]]:
    """Union of send-side frame keys per frame type across all wire
    modules."""
    frames: Dict[str, Set[str]] = {}
    for mod in index.modules.values():
        if not is_wire_module(mod):
            continue
        # pass 1: dict literals carrying a constant "t"; remember which
        # variable (if any) each literal is assigned to, per function
        var_frame: Dict[int, Dict[str, str]] = {}  # id(scope) -> var -> t
        scopes = [mod.tree] + [f.node for f in mod.functions.values()]
        for scope in scopes:
            local = var_frame.setdefault(id(scope), {})
            for node in ast.walk(scope):
                if isinstance(node, ast.Dict):
                    lf = _literal_frame(node)
                    if lf:
                        for t, keys in lf.items():
                            frames.setdefault(t, set()).update(keys)
                for tgt_name, value in _assign_pairs(node):
                    if isinstance(value, ast.Dict):
                        lf = _literal_frame(value)
                        if lf:
                            local[tgt_name] = next(iter(lf))
        # pass 2: ``var["key"] = ...`` augments on frame-carrying vars
        for scope in scopes:
            local = var_frame.get(id(scope), {})
            if not local:
                continue
            for node in ast.walk(scope):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Subscript)
                ):
                    sub = node.targets[0]
                    if (
                        isinstance(sub.value, ast.Name)
                        and sub.value.id in local
                        and isinstance(sub.slice, ast.Constant)
                        and isinstance(sub.slice.value, str)
                    ):
                        frames.setdefault(local[sub.value.id], set()).add(
                            sub.slice.value
                        )
    return frames


def _assign_pairs(node: ast.AST):
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name):
                yield t.id, node.value
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        if isinstance(node.target, ast.Name):
            yield node.target.id, node.value


def schema_as_json(frames: Dict[str, Set[str]]) -> Dict:
    return {
        "version": 1,
        "frames": {t: sorted(keys) for t, keys in sorted(frames.items())},
    }


def load_schema(path: Path = DEFAULT_SCHEMA_PATH) -> Optional[Dict]:
    if not path.exists():
        return None
    return json.loads(path.read_text(encoding="utf-8"))


def write_schema(
    index: PackageIndex, path: Path = DEFAULT_SCHEMA_PATH
) -> Dict:
    doc = schema_as_json(extract_frames(index))
    path.write_text(json.dumps(doc, indent=2) + "\n", encoding="utf-8")
    return doc


def _dict_shape_expr(node: ast.AST) -> bool:
    """``set(m)`` / ``sorted(m)`` / ``m.keys()`` / ``len(m)``-style
    frame-shape expressions."""
    if isinstance(node, ast.Call):
        t = dotted(node.func)
        if t in ("set", "sorted", "frozenset") and node.args:
            return isinstance(node.args[0], ast.Name)
        if t is not None and t.endswith(".keys"):
            return True
    return False


def _is_literal_collection(node: ast.AST) -> bool:
    return isinstance(
        node, (ast.Set, ast.List, ast.Tuple, ast.Dict, ast.Constant)
    )


def _strict_parse_findings(mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    for func in mod.functions.values():
        for node in ast.walk(func.node):
            if isinstance(node, ast.Compare) and len(node.ops) == 1:
                if isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                    l, r = node.left, node.comparators[0]
                    if (
                        _dict_shape_expr(l)
                        and _is_literal_collection(r)
                        or _dict_shape_expr(r)
                        and _is_literal_collection(l)
                    ):
                        out.append(
                            Finding(
                                rule="wire-strict-parse",
                                path=mod.path,
                                line=node.lineno,
                                message="frame shape compared against a "
                                "literal — parsers must tolerate unknown "
                                "keys (additive protocol)",
                                symbol=func.label,
                                key="shape-eq",
                            )
                        )
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if not _iterates_mapping(node):
                    continue
                for sub in ast.walk(node):
                    if (
                        isinstance(sub, ast.If)
                        and _is_notin_literal(sub.test)
                        and any(
                            isinstance(s, ast.Raise) for s in sub.body
                        )
                    ):
                        out.append(
                            Finding(
                                rule="wire-strict-parse",
                                path=mod.path,
                                line=sub.lineno,
                                message="raising on unrecognized frame "
                                "keys — parsers must ignore what they "
                                "don't understand (additive protocol)",
                                symbol=func.label,
                                key="unknown-key-raise",
                            )
                        )
    return out


def _iterates_mapping(node) -> bool:
    it = node.iter
    if isinstance(it, ast.Name):
        return True
    t = dotted(it.func) if isinstance(it, ast.Call) else None
    return t is not None and t.endswith(".keys")


def _is_notin_literal(test: ast.AST) -> bool:
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.NotIn)
        and _is_literal_collection(test.comparators[0])
    )


def run(
    index: PackageIndex, schema: Optional[Dict] = None
) -> List[Finding]:
    if schema is None:
        schema = load_schema()
    out: List[Finding] = []
    wire_mods = [m for m in index.modules.values() if is_wire_module(m)]
    if schema is not None and wire_mods:
        frames = extract_frames(index)
        anchor = wire_mods[0]
        for t, keys in sorted(schema.get("frames", {}).items()):
            have = frames.get(t)
            if have is None:
                out.append(
                    Finding(
                        rule="wire-key-removed",
                        path=anchor.path,
                        line=1,
                        message=f'frame type "{t}" is in wire_schema.json '
                        "but no sender produces it anymore — wire frames "
                        "are strictly additive",
                        symbol=anchor.name,
                        key=f"{t}",
                    )
                )
                continue
            for key in sorted(set(keys) - have):
                out.append(
                    Finding(
                        rule="wire-key-removed",
                        path=anchor.path,
                        line=1,
                        message=f'key "{key}" of frame "{t}" is in '
                        "wire_schema.json but no sender emits it anymore "
                        "— wire keys are strictly additive",
                        symbol=anchor.name,
                        key=f"{t}.{key}",
                    )
                )
    for mod in wire_mods:
        out.extend(_strict_parse_findings(mod))
    return out
