"""ctypes binding to the native FSM mask core (native/fsm.cpp).

Flattens the schema NFA into the epsilon-eliminated CSR layout the C++
core consumes:

- For each state ``s``, edges from every state in eps-closure(s) are lifted
  onto ``s``, and each edge's target ``t`` is replaced by... nothing —
  targets stay raw, but since masks/advance always re-enter through states
  that were produced by a lifted edge, we additionally lift *acceptance*
  and keep targets as the eps-closure *representative set* by expanding
  each edge target into its closure members as separate edges. After this
  transformation the NFA has no epsilon edges and Python/C++ step semantics
  match exactly.

Builds ``native/libsutro_fsm.so`` on demand (``make -C native``) and falls
back to pure Python (fsm.MaskCache._compute) when the toolchain is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, FrozenSet, List

import numpy as np

from .nfa import NFA

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsutro_fsm.so")
_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("SUTRO_NATIVE_FSM", "1") == "0":
        # explicit opt-out (mirrors SUTRO_NATIVE_RUNTIME=0): lets a
        # suite run discriminate whether a native translation unit is
        # implicated in a memory-corruption symptom
        raise RuntimeError("native FSM disabled via SUTRO_NATIVE_FSM=0")
    if not os.path.exists(os.path.join(_NATIVE_DIR, "fsm.cpp")):
        raise FileNotFoundError("native/fsm.cpp not present")
    # always run make: a no-op when the .so is fresh, a rebuild when
    # fsm.cpp changed (the artifact is not checked in)
    subprocess.run(
        ["make", "-C", _NATIVE_DIR],
        check=True,
        capture_output=True,
        timeout=120,
    )
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fsm_create.restype = ctypes.c_void_p
    lib.fsm_create.argtypes = [
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.uint32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
    ]
    lib.fsm_destroy.argtypes = [ctypes.c_void_p]
    lib.fsm_mask.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
    ]
    lib.fsm_advance.restype = ctypes.c_int32
    lib.fsm_advance.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int32,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
    ]
    _lib = lib
    return lib


def _bitmap_to_u32(bm: np.ndarray) -> np.ndarray:
    return np.packbits(bm.astype(np.uint8), bitorder="little").view(np.uint32)


class CppMasker:
    """Drop-in accelerator for MaskCache._compute."""

    def __init__(self, nfa: NFA, table) -> None:
        lib = _load_lib()
        n = nfa.n_states

        # epsilon-eliminate: state s gets the byte edges of eps-closure(s),
        # with each target expanded to its own eps-closure members.
        closures = [
            nfa.eps_closure(frozenset([s])) for s in range(n)
        ]
        # each NFA bitmap is packed once and the lifted edges index the
        # packed rows: a string with maxLength 400 has ~28k states and
        # ~3M lifted edges, and packing per edge took ~30 s
        offsets = np.zeros(n + 1, np.int32)
        packed: List[np.ndarray] = []
        row_of: Dict[int, int] = {}   # id(bitmap) -> row of ``packed``
        rows: List[int] = []
        targets: List[int] = []
        for s in range(n):
            for cs in closures[s]:
                for bm, t in nfa.edges.get(cs, ()):  # lifted edges
                    r = row_of.get(id(bm))
                    if r is None:
                        r = row_of[id(bm)] = len(packed)
                        packed.append(_bitmap_to_u32(bm))
                    rows.extend([r] * len(closures[t]))
                    targets.extend(closures[t])
            offsets[s + 1] = len(targets)
        bitmaps = (
            np.stack(packed)[np.asarray(rows, np.int64)].reshape(-1)
            if rows else np.zeros(0, np.uint32)
        )
        accepting = np.zeros(n, np.uint8)
        for s in range(n):
            if nfa.accept in closures[s]:
                accepting[s] = 1

        tok_offsets = np.zeros(table.vocab_size + 1, np.int32)
        blobs = []
        for i, tb in enumerate(table.token_bytes):
            tok_offsets[i + 1] = tok_offsets[i] + len(tb)
            blobs.append(tb)
        tok_bytes = np.frombuffer(b"".join(blobs) or b"\x00", np.uint8).copy()

        # per-state byte distance to accept (budget-aware decoding);
        # inf -> INT32_MAX for the C side
        dist = nfa.byte_distances()
        self._state_dist = np.where(
            np.isfinite(dist), dist, np.float64(0x7FFFFFFF)
        ).astype(np.int32)

        self.vocab = table.vocab_size
        self._lib = lib
        self._handle = lib.fsm_create(
            np.int32(n),
            np.ascontiguousarray(offsets),
            np.ascontiguousarray(bitmaps),
            np.ascontiguousarray(np.array(targets, np.int32)),
            np.ascontiguousarray(accepting),
            np.int32(self.vocab),
            np.ascontiguousarray(tok_offsets),
            np.ascontiguousarray(tok_bytes),
        )

    def mask(self, states: FrozenSet[int]) -> "tuple[np.ndarray, np.ndarray]":
        """Returns (allowed [V] bool, dist_after [V] int32) — dist_after is
        the post-token byte distance to accept (INT32_MAX if disallowed)."""
        arr = np.array(sorted(states), np.int32)
        out = np.zeros(self.vocab, np.uint8)
        out_dist = np.zeros(self.vocab, np.int32)
        self._lib.fsm_mask(
            self._handle, arr, np.int32(len(arr)), self._state_dist,
            out, out_dist,
        )
        return out.astype(bool), out_dist

    def __del__(self) -> None:
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle is not None:
            try:
                lib.fsm_destroy(ctypes.c_void_p(handle))
            except Exception:
                pass
