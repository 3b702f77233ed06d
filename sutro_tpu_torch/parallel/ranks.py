"""Rank processes of a mesh runner (one process per rank).

The reference's ``ModelRunner`` drives every device of its mesh from one
process: XLA's single controller. The port runs one process per rank:

- rank 0 is the ``ModelRunner`` the engine holds; when its mesh has more
  than one rank it starts ranks 1..W-1 itself (:class:`RankPool`,
  ``torch.multiprocessing`` with the spawn start method);
- each worker binds its own device, builds the same runner on its block
  of the weights and the pool (:func:`worker_main`), then runs every
  entry point rank 0 runs, with the same host arguments, which rank 0
  broadcasts over the mesh's control group (gloo, host memory) before
  it runs the entry itself. Tensor arguments (a window's last tokens
  still on the device) follow over the mesh's world group;
- so the engine, the scheduler and the job API see ONE runner, as in
  the reference.

Under ``torchrun`` (``mesh.init_distributed``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) nothing is spawned: rank 0's runner
puts its construction arguments into the launch's store, and every
other process calls :func:`torchrun_worker`, which builds the same
runner from them and serves it (``python -m sutro_tpu_torch.server``
does so on ranks above 0).

Each call ends with the ranks telling each other whether its body
raised. An exception that every rank raised alike (the same type and
message) is re-raised on rank 0 and the mesh stays up, as the exception
would leave a single-device runner usable. Anything else is a rank
failure: ranks that disagree, a worker that exited (its connections
break, so rank 0's next collective raises at once), or a hung rank
(rank 0 raises after ``mesh.mesh_timeout()``). Rank 0 then raises
:class:`RankFailure` with the workers' tracebacks and stops the other
ranks; the runner refuses every later call. Nothing waits forever.
Refusals that depend on the arguments alone, and fault injection, come
before anything is sent (:func:`entry`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
import weakref
from typing import Any, List, Optional

import torch
import torch.multiprocessing as mp

from . import mesh as mesh_mod


class RankFailure(RuntimeError):
    """A rank of a mesh runner failed; the runner is down."""


@dataclasses.dataclass(frozen=True)
class _TensorArg:
    index: int


def _encode(x: Any, tensors: List[torch.Tensor]) -> Any:
    if torch.is_tensor(x):
        tensors.append(x)
        return _TensorArg(len(tensors) - 1)
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v, tensors) for v in x)
    if isinstance(x, dict):
        return {k: _encode(v, tensors) for k, v in x.items()}
    return x


def _decode(x: Any, tensors: List[torch.Tensor]) -> Any:
    if isinstance(x, _TensorArg):
        return tensors[x.index]
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v, tensors) for v in x)
    if isinstance(x, dict):
        return {k: _decode(v, tensors) for k, v in x.items()}
    return x


class _Ranks:
    """What rank 0 must stop when its runner goes: the worker processes,
    the store's directory and the mesh (never the runner itself)."""

    def __init__(self, procs, errors, directory):
        self.procs = procs
        self.errors = errors
        self.dir = directory
        self.mesh = None
        self.broken = None

    def failures(self, wait: float = 0.0) -> List[str]:
        """Workers' tracebacks, and the exit codes of workers that died
        without one; waits up to ``wait`` s for a first report."""
        end = time.monotonic() + wait
        out = []
        while True:
            while not self.errors.empty():
                rank, tb = self.errors.get()
                out.append(f"rank {rank}:\n{tb}")
            dead = [p for p in self.procs if p.exitcode not in (None, 0)]
            if out or dead or time.monotonic() >= end:
                break
            time.sleep(0.05)
        reported = {int(x.split(":")[0].split()[1]) for x in out}
        for i, p in enumerate(self.procs, start=1):
            if p.exitcode not in (None, 0) and i not in reported:
                out.append(f"rank {i}: exited with code {p.exitcode}")
        return out

    def stop(self, graceful: bool) -> None:
        if graceful and self.broken is None and self.mesh is not None and self.mesh.connected:
            try:
                self.mesh.ctrl.broadcast_object((None, None, None))
            except RuntimeError:
                pass  # a worker is already gone; terminated below
        for p in self.procs:
            p.join(timeout=30 if graceful else 0.5)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if self.mesh is not None:
            self.mesh.close()
        shutil.rmtree(self.dir, ignore_errors=True)


class RankPool:
    """Rank 0's side of a mesh runner: starts the worker ranks, sends
    each entry point's call, and turns any rank's failure into
    :class:`RankFailure`."""

    def __init__(self, spec: dict, world: int):
        directory = tempfile.mkdtemp(prefix="sutro-mesh-")
        self.store_path = os.path.join(directory, "store")
        ctx = mp.get_context("spawn")
        errors = ctx.SimpleQueue()
        procs = []
        launch = mesh_mod.init_distributed()
        if launch is not None and launch[1] == world:
            # torchrun started the other ranks: they take the spec here
            self._store = mesh_mod.env_store(0, world)
            self._store.set(SPEC_KEY, pickle.dumps(spec))
        else:
            self._store = None
            for rank in range(1, world):
                p = ctx.Process(
                    target=worker_main, name=f"sutro-rank{rank}", daemon=True,
                    args=(rank, spec, self.store_path, errors, torch.get_num_threads()),
                )
                p.start()
                procs.append(p)
        self.world = world
        self.ranks = _Ranks(procs, errors, directory)
        self._lock = threading.Lock()   # one call on the mesh at a time
        self._finalizer = weakref.finalize(self, self.ranks.stop, True)

    def attach(self, mesh) -> None:
        self.ranks.mesh = mesh

    def store(self):
        if self._store is not None:
            return self._store
        return mesh_mod.file_store(self.store_path, self.world)

    def wait_up(self, store, timeout: float) -> None:
        """Wait until every worker has reached its mesh (each sets
        ``up/<rank>`` in the store), raising as soon as one has died."""
        end = time.monotonic() + timeout
        for rank in range(1, self.world):
            p = self.ranks.procs[rank - 1] if self.ranks.procs else None
            while True:
                try:
                    store.wait([f"up/{rank}"], datetime.timedelta(seconds=0.5))
                    break
                except RuntimeError as e:   # the store's wait timed out
                    if (p is not None and p.exitcode is not None) or time.monotonic() > end:
                        self.fail(e)

    def check(self) -> None:
        if self.ranks.broken is not None:
            raise RankFailure(f"the mesh runner is down: {self.ranks.broken}")
        if any(p.exitcode is not None for p in self.ranks.procs):
            self.fail(RankFailure("a worker rank exited"))

    def fail(self, exc: BaseException):
        """Stop every rank and raise RankFailure naming the failures."""
        msgs = self.ranks.failures(wait=2.0)
        self.ranks.broken = "; ".join(m.splitlines()[0] for m in msgs) or repr(exc)
        self.ranks.stop(graceful=False)
        detail = "\n".join(msgs) or repr(exc)
        raise RankFailure(f"a mesh rank failed ({exc!r}):\n{detail}") from exc

    @contextlib.contextmanager
    def guard(self):
        """A collective of rank 0 that a failed rank breaks: RankFailure."""
        try:
            yield
        except RuntimeError as e:
            self.fail(e)

    def call(self, name: str, fn, args: tuple, kwargs: dict):
        """Send ``name(*args, **kwargs)`` to every worker, then run
        ``fn`` (the same entry point here) and settle its outcome with
        the workers (:func:`settle`)."""
        with self._lock:
            self.check()
            mesh = self.ranks.mesh
            try:
                tensors: List[torch.Tensor] = []
                enc = _encode((args, kwargs), tensors)
                mesh.ctrl.broadcast_object(
                    (name, enc, [(tuple(t.shape), t.dtype) for t in tensors])
                )
                for t in tensors:
                    mesh.world.broadcast(t.detach().contiguous(), 0)
            except RuntimeError as e:   # a worker is gone
                self.fail(e)
            err = out = None
            try:
                out = fn()
            except Exception as e:
                err = e
            try:
                same = settle(mesh, err)
            except RuntimeError as e:   # a worker is gone or hung
                self.fail(err or e)
            if not same:
                self.fail(err or RankFailure("another rank's call raised"))
            if err is not None:
                raise err
            return out

    def close(self) -> None:
        self._finalizer()


def _outcome(err: Optional[BaseException]):
    return None if err is None else (type(err).__qualname__, str(err))


def settle(mesh, err: Optional[BaseException]) -> bool:
    """After a call's body on every rank: whether every rank ended it
    alike (all returned, or all raised the same type and message). One
    flag a rank is exchanged; the outcomes only when a flag is set."""
    flags = mesh.ctrl.all_gather(torch.tensor([[int(err is not None)]]), 0)
    if not flags.any():
        return True
    outs = mesh.ctrl.gather_objects(_outcome(err))
    return outs[0] is not None and all(o == outs[0] for o in outs)


def serve(runner) -> None:
    """A worker's loop: run each entry point rank 0 sends, until told to
    stop. An exception every rank raised alike leaves the loop running
    (rank 0 re-raises it); any other ends this worker."""
    mesh = runner.mesh
    while True:
        name, enc, metas = mesh.ctrl.broadcast_object()
        if name is None:
            return
        tensors = [
            mesh.world.broadcast(torch.empty(shape, dtype=dtype, device=mesh.device), 0)
            for shape, dtype in metas
        ]
        args, kwargs = _decode(enc, tensors)
        err = None
        with runner._entry_scope():
            try:
                getattr(type(runner), name).__wrapped__(runner, *args, **kwargs)
            except Exception as e:
                err = e
        if not settle(mesh, err):
            raise err or RankFailure("another rank's call raised")


SPEC_KEY = "sutro/runner-spec"


def torchrun_worker() -> None:
    """Ranks 1..W-1 of a ``torchrun`` launch: take rank 0's runner spec
    from the launch's store, build the same runner on this rank's block
    and serve it until rank 0 stops (a failure raises here, and the
    broken connections make rank 0 raise)."""
    from ..engine.runner import ModelRunner

    rank, world = mesh_mod.init_distributed()
    store = mesh_mod.env_store(rank, world)
    while True:   # rank 0 builds its runner when its engine first needs it
        try:
            store.wait([SPEC_KEY], datetime.timedelta(seconds=60))
            break
        except RuntimeError:
            continue
    spec = pickle.loads(store.get(SPEC_KEY))
    runner = ModelRunner(
        spec["mcfg"], spec["ecfg"], spec["params"], num_pages=spec["num_pages"],
        device=spec["devices"], checkpoint=spec["checkpoint"], _rank=(rank, store, time.time()),
    )
    serve(runner)


def worker_main(rank: int, spec: dict, store_path: str, errors, threads: int) -> None:
    """Entry of a spawned worker rank (imports nothing of rank 0's but
    this package)."""
    try:
        torch.set_num_threads(threads)
        from ..engine.runner import ModelRunner

        runner = ModelRunner(
            spec["mcfg"], spec["ecfg"], spec["params"], num_pages=spec["num_pages"],
            device=spec["devices"], checkpoint=spec["checkpoint"],
            _rank=(rank, store_path, spec["t0"]),
        )
        serve(runner)
    except BaseException:
        try:
            errors.put((rank, traceback.format_exc()))
        finally:
            os._exit(1)
    os._exit(0)


def entry(site=None, check=None):
    """Decorator of a runner entry point. The outermost entry of a call
    first injects the fault at ``site`` (if a fault plan is active) and
    runs ``check(self, *args, **kwargs)`` (refusals that depend on the
    arguments alone), both on rank 0 before anything is sent; then, on
    rank 0 of a mesh, the call goes to every rank. Nested entries, and
    a worker's, run the body as is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if self._entry_depth():
                return fn(self, *args, **kwargs)
            if site is not None:
                from ..engine import faults

                if faults.ACTIVE is not None:
                    faults.inject(site)
            if check is not None:
                check(self, *args, **kwargs)
            with self._entry_scope():
                pool = self._pool
                if pool is None:
                    return fn(self, *args, **kwargs)
                return pool.call(fn.__name__, lambda: fn(self, *args, **kwargs), args, kwargs)
        return wrapper
    return deco
