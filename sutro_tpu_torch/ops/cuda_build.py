"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``sutro_tpu_torch/csrc/`` with a
plain C interface (the attention kernels share the warp-level helpers of
``csrc/sm90_mma.cuh``). It is compiled with ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library under ``csrc/build/`` (listed in ``.gitignore``)
at first use, and loaded with ``ctypes``. The library's file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded.

Nothing here runs at import: the CPU tests import every module of the
port on hosts with no card and no ``nvcc``. ``build()`` starts one
``nvcc`` per source, all at once, so a cold build costs the slowest
single compile.

Each kernel's wrapper module owns one :class:`CudaKernel`; its
``launches`` counter goes up by one where the wrapper launches the
kernel and nowhere else, so a run can show that its main path went
through the kernel. A kernel option counted on its own (paged decode
with the shared-prefix carry) is a second :class:`CudaKernel` over the
same source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from sutro_tpu_torch/csrc at first use"
        )
    return found


class CudaKernel:
    """One kernel library: its source, the C function it exports with
    that function's ctypes signature, and the launch counter."""

    def __init__(
        self, name: str, symbol: str, argtypes: List, replaces: str,
        source: Optional[str] = None,
    ):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces  # the TPU kernel it replaces, file:line
        self.launches = 0
        self._source = source or name  # csrc/<source>.cu
        self._fn = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self._source}.cu"

    def library_path(self) -> Path:
        # the shared headers (csrc/*.cuh) are part of every source
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self._source}-{digest}.so"

    def function(self):
        """The loaded C entry point, built on first use. The build runs
        outside the lock: it is idempotent (each compile writes its own
        temporary file and renames it into place), so two threads that
        both find the library missing both compile and one rename wins;
        the lock only makes the load happen once."""
        if self._fn is None:
            path = self.library_path()
            build([self])
            with _lock:
                if self._fn is None:
                    lib = ctypes.CDLL(str(path))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point and raise on a refused launch (the
        function returns ``cudaGetLastError()``)."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}"
            )
        self.launches += 1


def build(kernels: Iterable[CudaKernel]) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns ``{source name: compiler
    log}`` (the ``-Xptxas -v`` register and shared-memory report) for
    the sources compiled by this call; raises with the log if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = list({
        k.library_path(): k for k in kernels if not k.library_path().exists()
    }.values())  # one compile per source
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = []
    for k in todo:
        out = k.library_path()
        tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs: Dict[str, str] = {}
    failed: Optional[str] = None
    for k, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[k.source.stem] = log
        if proc.returncode != 0:
            failed = failed or f"nvcc failed for {k.source}:\n{log}"
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(k.library_path())  # atomic: readers never see half
    if failed:
        raise RuntimeError(failed)
    return logs


def sass_counts(kernel: CudaKernel) -> Dict[str, Dict[str, int]]:
    """``{function: {"mma": n, "cp_async": n, "tma": n}}`` for the
    kernel's built library: its tensor-core instructions
    (``HMMA``/``HGMMA``), its asynchronous global-to-shared copies
    (``LDGSTS``) and its TMA loads (``UTMALDG``) as ``cuobjdump -sass``
    lists them."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(kernel.library_path())],
        check=True, capture_output=True, text=True,
    ).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"mma": 0, "cp_async": 0, "tma": 0}
        elif fn is not None:
            counts[fn]["mma"] += ("HMMA" in line) or ("HGMMA" in line)
            counts[fn]["cp_async"] += "LDGSTS" in line
            counts[fn]["tma"] += "UTMALDG" in line
    return counts


_N_SM: Dict[int, int] = {}


def sm_count(device) -> int:
    """The card's multiprocessor count, read once per device (the
    wrappers that size their grids by it run thousands of times a
    serve)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _N_SM:
        _N_SM[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _N_SM[index]


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> Optional[ctypes.c_void_p]:
    """A tensor's device pointer (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())
