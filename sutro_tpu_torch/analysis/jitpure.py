"""Device-purity and scheduler-determinism pass.

The reference's roots are ``jax.jit`` functions and Pallas kernel
bodies; PyTorch runs eagerly, so this port's counterpart of a jit root
is a **device entry point**:

- ``forward`` and ``run_layers`` of a ``models.transformer`` module
  (the trunk every prefill, decode and verify call runs),
- a function that launches a module-level ``CudaKernel`` (its
  ``.launch(...)``: the wrapper of a hand-written kernel),
- the scheduler decode window: ``run`` / ``run_multi`` methods of a
  ``*Batcher`` class in a ``*scheduler`` module.

From each root the pass walks the package-reachable call set and
reports:

- ``jit-host-sync``        ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                           ``.numpy()`` / ``torch.cuda.synchronize``,
                           and ``np.asarray`` / ``np.array`` /
                           ``float()`` / ``int()`` on a tensor parameter
                           of the root (one annotated ``Tensor``, or not
                           annotated): each waits for the card
- ``jit-nondeterminism``   wall clocks, Python ``random.*``, global
                           ``np.random`` draws, and ``torch.rand*`` /
                           ``multinomial`` / ``bernoulli`` without a
                           ``generator=`` in a device root
- ``sched-nondeterminism`` ``time.time()`` / ``random.*`` /
                           ``np.random.*`` / ``uuid.uuid4`` /
                           ``os.urandom`` reachable from the decode
                           window (``time.monotonic`` and
                           ``time.perf_counter`` stay legal: elapsed-
                           time measurement, not wall-clock decisions)

A plain version's host read on a CPU tensor is legal by the port's
rules (a wrapper runs it only for a tensor on the CPU); such lines
carry a pragma that says so.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .callgraph import FunctionInfo, ModuleInfo, PackageIndex, dotted
from .core import Finding

_MAX_DEPTH = 8

HOST_SYNC_EXACT = {"torch.cuda.synchronize"}
HOST_SYNC_SUFFIX = (".item", ".tolist", ".cpu", ".numpy")
HOST_READ_OF_PARAM = {"numpy.asarray", "numpy.array", "float", "int"}
JIT_NONDET_EXACT = {"time.time", "time.monotonic", "time.perf_counter"}
SCHED_NONDET_EXACT = {"time.time", "os.urandom", "uuid.uuid4"}
_RNG_PREFIXES = ("random.", "numpy.random.")
# numpy constructors of a seeded generator: legal with a seed argument
_SEEDED_NUMPY = {"numpy.random.default_rng", "numpy.random.Generator",
                 "numpy.random.SeedSequence", "numpy.random.PCG64"}
_TORCH_RNG_PREFIX = "torch.rand"
_TORCH_RNG_EXACT = {"torch.multinomial", "torch.bernoulli"}
_TRUNK_ROOTS = ("forward", "run_layers")
# annotations of a parameter that is a host value, never a tensor
_HOST_ANNOTATIONS = ("int", "float", "bool", "str", "ModelConfig", "range", "Params")


def _kernel_names(mod: ModuleInfo) -> Set[str]:
    """Module-level names bound to ``CudaKernel(...)``."""
    out: Set[str] = set()
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        text = dotted(node.value.func)
        if text and mod.expand(text).split(".")[-1] == "CudaKernel":
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _launches(func: FunctionInfo, kernels: Set[str]) -> bool:
    for node in ast.walk(func.node):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "launch"
            and any(isinstance(n, ast.Name) and n.id in kernels
                    for n in ast.walk(node.func.value))
        ):
            return True
    return False


def _tensor_params(func: FunctionInfo) -> Set[str]:
    """The root's parameters that may hold a tensor: annotated with a
    ``Tensor`` type, or not annotated (the counterpart of the
    reference's traced, non-static parameters)."""
    args = getattr(func.node, "args", None)
    if args is None:
        return set()
    out: Set[str] = set()
    for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        if a.arg in ("self", "cls"):
            continue
        ann = ast.unparse(a.annotation) if a.annotation is not None else ""
        if not ann or "Tensor" in ann or not any(
            word in ann for word in _HOST_ANNOTATIONS
        ):
            out.add(a.arg)
    return out


def _find_roots(
    index: PackageIndex,
) -> List[Tuple[FunctionInfo, str]]:
    """(function, kind) with kind in {device, sched}."""
    roots: List[Tuple[FunctionInfo, str]] = []
    for mod in index.modules.values():
        parts = mod.name.split(".")
        if parts[-2:] == ["models", "transformer"]:
            for name in _TRUNK_ROOTS:
                if name in mod.functions:
                    roots.append((mod.functions[name], "device"))
        kernels = _kernel_names(mod)
        if kernels:
            for func in mod.functions.values():
                if func.class_name is None and func.parent is None and _launches(
                    func, kernels
                ):
                    roots.append((func, "device"))
        # scheduler decode window
        if parts[-1].endswith("scheduler"):
            for cls, quals in mod.classes.items():
                if "Batcher" not in cls:
                    continue
                for q in quals:
                    if q.split(".")[-1] in ("run", "run_multi"):
                        roots.append((mod.functions[q], "sched"))
    # dedupe, the device kind wins over sched for the same function
    seen: Dict[str, Tuple[FunctionInfo, str]] = {}
    for func, kind in roots:
        seen.setdefault(f"{func.label}|{kind}", (func, kind))
    return list(seen.values())


def _unseeded_rng(text: str, call: ast.Call) -> bool:
    """A draw that no seed or generator pins."""
    if text.startswith("random."):
        return True
    if text.startswith("numpy.random."):
        return not (text in _SEEDED_NUMPY and (call.args or call.keywords))
    if text.startswith(_TORCH_RNG_PREFIX) or text in _TORCH_RNG_EXACT:
        return not any(k.arg == "generator" for k in call.keywords)
    return False


class _PurityWalker:
    def __init__(self, index: PackageIndex):
        self.index = index
        self.findings: List[Finding] = []
        self._seen: Set[str] = set()

    def _emit(self, f: Finding) -> None:
        fp = f.fingerprint() + f"@{f.line}"
        if fp in self._seen:
            return
        self._seen.add(fp)
        self.findings.append(f)

    def _flag_call(
        self,
        func: FunctionInfo,
        call: ast.Call,
        kind: str,
        root: FunctionInfo,
        tensor_params: Set[str],
    ) -> None:
        raw = dotted(call.func) or ""
        text = func.module.expand(raw) if raw else ""
        via = (
            "" if func is root else f" (reached from {root.qualname})"
        )
        if kind == "device":
            sync = text in HOST_SYNC_EXACT or any(
                text.endswith(s) for s in HOST_SYNC_SUFFIX
            )
            if (
                not sync
                and text in HOST_READ_OF_PARAM
                and len(call.args) >= 1
                and isinstance(call.args[0], ast.Name)
                and call.args[0].id in tensor_params
            ):
                sync = True
                raw = f"{raw}({call.args[0].id})"
            if sync:
                self._emit(
                    Finding(
                        rule="jit-host-sync",
                        path=func.module.path,
                        line=call.lineno,
                        symbol=func.label,
                        key=f"{root.qualname}|{text or raw}",
                        message=(
                            f"host-sync `{raw}` inside device entry point "
                            f"`{root.qualname}`{via}"
                        ),
                    )
                )
                return
            if text in JIT_NONDET_EXACT or _unseeded_rng(text, call):
                self._emit(
                    Finding(
                        rule="jit-nondeterminism",
                        path=func.module.path,
                        line=call.lineno,
                        symbol=func.label,
                        key=f"{root.qualname}|{text}",
                        message=(
                            f"nondeterministic `{raw}` inside device entry "
                            f"point `{root.qualname}`{via}"
                        ),
                    )
                )
        else:  # sched
            if text in SCHED_NONDET_EXACT or any(
                text.startswith(p) for p in _RNG_PREFIXES
            ):
                self._emit(
                    Finding(
                        rule="sched-nondeterminism",
                        path=func.module.path,
                        line=call.lineno,
                        symbol=func.label,
                        key=f"{root.qualname}|{text}",
                        message=(
                            f"`{raw}` reachable from the scheduler "
                            f"decode window `{root.qualname}` — decode "
                            "decisions must be deterministic and "
                            "host-clock-free"
                        ),
                    )
                )

    def walk_root(self, root: FunctionInfo, kind: str) -> None:
        tensors = _tensor_params(root) if kind == "device" else set()
        visited: Set[str] = set()
        stack: List[Tuple[FunctionInfo, int]] = [(root, 0)]
        while stack:
            func, depth = stack.pop()
            if func.label in visited:
                continue
            visited.add(func.label)
            for node in ast.walk(func.node):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and node is not func.node:
                    continue
                if not isinstance(node, ast.Call):
                    continue
                self._flag_call(func, node, kind, root, tensors)
                if depth < _MAX_DEPTH:
                    _, target = self.index.resolve_call(func, node)
                    if target is not None:
                        stack.append((target, depth + 1))


def run(index: PackageIndex) -> List[Finding]:
    w = _PurityWalker(index)
    for func, kind in _find_roots(index):
        w.walk_root(func, kind)
    w.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return w.findings
