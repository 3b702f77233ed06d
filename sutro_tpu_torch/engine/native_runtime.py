"""ctypes binding to the native scheduler runtime (native/runtime.cpp).

Wraps the C++ page allocator + admission + dense step-state core behind
the same semantics as the pure-Python PageAllocator/slot bookkeeping in
engine/scheduler.py. The dense per-step arrays (last tokens, past
lengths, page tables, sampling params) are exposed as zero-copy numpy
views over the C++ buffers, so the scheduler's per-step slot-assembly
loop does no Python work.

Builds ``native/libsutro_runtime.so`` on demand (``make -C native``);
``is_available()`` is False when the toolchain is absent and the
scheduler falls back to pure Python. Set ``SUTRO_NATIVE_RUNTIME=0`` to
force the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsutro_runtime.so")
_lib = None
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("SUTRO_NATIVE_RUNTIME", "1") == "0":
        _lib_failed = True
        return None
    try:
        if not os.path.exists(os.path.join(_NATIVE_DIR, "runtime.cpp")):
            raise FileNotFoundError("native/runtime.cpp not present")
        # always run make: a no-op when the .so is fresh, a rebuild when
        # runtime.cpp changed (the artifact is not checked in)
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        lib = ctypes.CDLL(_LIB_PATH)
    except Exception:
        _lib_failed = True
        return None

    c_rt = ctypes.c_void_p
    i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    p_i32 = ctypes.POINTER(i32)
    p_f32 = ctypes.POINTER(f32)

    lib.rt_create.restype = c_rt
    lib.rt_create.argtypes = [i32, i32, i32, i32, i64, i32]
    lib.rt_destroy.argtypes = [c_rt]
    lib.rt_free_page_count.restype = i32
    lib.rt_free_page_count.argtypes = [c_rt]
    lib.rt_inflight_tokens.restype = i64
    lib.rt_inflight_tokens.argtypes = [c_rt]
    lib.rt_active_count.restype = i32
    lib.rt_active_count.argtypes = [c_rt]
    lib.rt_try_admit.restype = i32
    lib.rt_try_admit.argtypes = [c_rt, i32, i32]
    lib.rt_try_admit_pfx.restype = i32
    lib.rt_try_admit_pfx.argtypes = [c_rt, i32, i32, i32, p_i32]
    lib.rt_alloc_pages.restype = i32
    lib.rt_alloc_pages.argtypes = [c_rt, i32, p_i32]
    lib.rt_free_pages.argtypes = [c_rt, i32, p_i32]
    lib.rt_reserve_pages.restype = i32
    lib.rt_reserve_pages.argtypes = [c_rt, i32, p_i32]
    lib.rt_arm_slot.argtypes = [c_rt, i32, i32, i32, f32, f32, i32]
    lib.rt_note_token.argtypes = [c_rt, i32, i32]
    lib.rt_note_bulk.argtypes = [c_rt, i32, i32, i32]
    lib.rt_release.argtypes = [c_rt, i32]
    lib.rt_emitted.restype = i32
    lib.rt_emitted.argtypes = [c_rt, i32]
    lib.rt_slot_npfx.restype = i32
    lib.rt_slot_npfx.argtypes = [c_rt, i32]
    lib.rt_pos.restype = i32
    lib.rt_pos.argtypes = [c_rt, i32]
    lib.rt_is_active.restype = i32
    lib.rt_is_active.argtypes = [c_rt, i32]
    for name, ptype in [
        ("rt_view_last", p_i32),
        ("rt_view_past_len", p_i32),
        ("rt_view_table", p_i32),
        ("rt_view_top_k", p_i32),
        ("rt_view_temp", p_f32),
        ("rt_view_top_p", p_f32),
    ]:
        fn = getattr(lib, name)
        fn.restype = ptype
        fn.argtypes = [c_rt]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load_lib() is not None


def _view(ptr, shape, dtype) -> np.ndarray:
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(ptr, shape=(n,))
    out = arr.view(dtype).reshape(shape)
    return out


class NativeRuntime:
    """Slot/page/step-state manager backed by native/runtime.cpp.

    The ``last``/``past_len``/``table``/``temp``/``top_p``/``top_k``
    attributes are zero-copy views into C++ memory — always current, no
    per-step assembly."""

    def __init__(
        self,
        num_pages: int,
        num_slots: int,
        max_pages_per_seq: int,
        page_size: int,
        max_batch_tokens: int,
        max_context: int,
    ):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._rt = lib.rt_create(
            num_pages, num_slots, max_pages_per_seq, page_size,
            max_batch_tokens, max_context,
        )
        self.num_slots = num_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.last = _view(
            lib.rt_view_last(self._rt), (num_slots,), np.int32
        )
        self.past_len = _view(
            lib.rt_view_past_len(self._rt), (num_slots,), np.int32
        )
        self.table = _view(
            lib.rt_view_table(self._rt),
            (num_slots, max_pages_per_seq),
            np.int32,
        )
        self.temp = _view(
            lib.rt_view_temp(self._rt), (num_slots,), np.float32
        )
        self.top_p = _view(
            lib.rt_view_top_p(self._rt), (num_slots,), np.float32
        )
        self.top_k = _view(
            lib.rt_view_top_k(self._rt), (num_slots,), np.int32
        )

    def __del__(self):
        rt = getattr(self, "_rt", None)
        if rt:
            self._lib.rt_destroy(rt)
            self._rt = None

    # -- allocator/admission ------------------------------------------

    def try_admit(self, prompt_len: int, max_new_tokens: int) -> int:
        """Returns the admitted slot index or -1."""
        return int(
            self._lib.rt_try_admit(self._rt, prompt_len, max_new_tokens)
        )

    def try_admit_pfx(
        self, prompt_len: int, max_new_tokens: int, pfx_pages: List[int]
    ) -> int:
        """Admission with a job-wide shared KV prefix at the table head
        (the pages are referenced, not owned: release frees only the
        slot's own pages). Returns the slot index or -1."""
        arr = np.asarray(pfx_pages, np.int32)
        return int(
            self._lib.rt_try_admit_pfx(
                self._rt, prompt_len, max_new_tokens, len(arr),
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        )

    def alloc_pages(self, n: int) -> Optional[List[int]]:
        """Job-scoped page block (shared-prefix KV); None when the pool
        cannot supply it. Return with ``free_pages``."""
        out = np.zeros((n,), np.int32)
        rc = self._lib.rt_alloc_pages(
            self._rt, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return [int(p) for p in out] if rc == 0 else None

    def free_pages(self, pages: List[int]) -> None:
        arr = np.asarray(pages, np.int32)
        self._lib.rt_free_pages(
            self._rt, len(arr),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def reserve_pages(self, pages: List[int]) -> bool:
        """Remove specific page ids from the free set (prefix-store
        pages held across sessions). Atomic; False when any id is not
        free — the runtime's free set is then untouched."""
        if not pages:
            return True
        arr = np.asarray(pages, np.int32)
        rc = self._lib.rt_reserve_pages(
            self._rt, len(arr),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return int(rc) == 0

    def arm_slot(
        self, slot: int, pos: int, first_token: int,
        temperature: float, top_p: float, top_k: int,
    ) -> None:
        self._lib.rt_arm_slot(
            self._rt, slot, pos, first_token,
            float(temperature), float(top_p), int(top_k),
        )

    def note_token(self, slot: int, tok: int) -> None:
        self._lib.rt_note_token(self._rt, slot, int(tok))

    def note_bulk(self, slot: int, last_tok: int, n: int) -> None:
        """n accepted tokens ending with last_tok — one ctypes crossing
        per window instead of one per token."""
        self._lib.rt_note_bulk(self._rt, slot, int(last_tok), int(n))

    def release(self, slot: int) -> None:
        self._lib.rt_release(self._rt, slot)

    # -- introspection -------------------------------------------------

    @property
    def free_count(self) -> int:
        return int(self._lib.rt_free_page_count(self._rt))

    @property
    def inflight_tokens(self) -> int:
        return int(self._lib.rt_inflight_tokens(self._rt))

    @property
    def active_count(self) -> int:
        return int(self._lib.rt_active_count(self._rt))

    def is_active(self, slot: int) -> bool:
        return bool(self._lib.rt_is_active(self._rt, slot))

    def pos(self, slot: int) -> int:
        return int(self._lib.rt_pos(self._rt, slot))

    def emitted(self, slot: int) -> int:
        return int(self._lib.rt_emitted(self._rt, slot))

    def slot_pages(self, slot: int) -> List[int]:
        """Pages OWNED by this slot (freed by ``release``) — with a
        shared prefix active, the job-owned prefix pages at the table
        head are excluded (freeing them per slot would double-free job
        pages into the pool)."""
        npfx = int(self._lib.rt_slot_npfx(self._rt, slot))
        row = self.table[slot]
        return [int(p) for p in row[npfx:] if p != 0]


def maybe_native_runtime(
    num_pages: int,
    num_slots: int,
    max_pages_per_seq: int,
    page_size: int,
    max_batch_tokens: int,
    max_context: int,
) -> Optional[NativeRuntime]:
    if not is_available():
        return None
    return NativeRuntime(
        num_pages, num_slots, max_pages_per_seq, page_size,
        max_batch_tokens, max_context,
    )
