"""Device mesh over ``torch.distributed``: one process per rank.

Port of ``sutro_tpu/parallel/mesh.py``. The axes are the reference's,
``("data", "pipe", "seq", "expert", "model")``:

- ``model`` (TP), innermost: Megatron tensor parallelism, one
  all-reduce after each attention and MLP block (models/transformer.py);
- ``expert`` (EP): the MoE layers' experts split over ranks
  (ops/moe_ep.py), one all-reduce over ``("expert", "model")``;
- ``seq`` (SP): ring attention over the prompt (ops/ring_attention.py);
- ``pipe`` (PP): stages of ``L/pp`` layers (parallel/pipeline.py);
- ``data`` (DP), outermost: rows split over ranks (not ported inside a
  mesh; engine-level data parallelism is engine/dphost.py).

Ranks go onto the grid the way the reference places devices,
``np.array(devices).reshape(dp, pp, sp, ep, tp)``, so rank ``r``'s
coordinates are ``np.unravel_index(r, (dp, pp, sp, ep, tp))``.

XLA inserts the reference's collectives from sharding annotations; the
port calls them itself, through :class:`Group`: each rank builds one
process group per axis of size > 1, one over ``("expert", "model")``,
and one over the world, plus a gloo group over the world for the
control channel (parallel/ranks.py). The groups are c10d process-group
objects built directly on a store, not the process-global default
group, so one process may hold several meshes (an engine keeps two
runners resident).

**Backend**, chosen from where the ranks are, never after a failure:

- ``nccl`` when every rank has a CUDA device of its own;
- ``gloo`` on the CPU;
- ``gloo`` when ranks share a CUDA device: NCCL refuses two ranks on one
  device.

Gloo stages CUDA tensors through host copies in every collective here
(its own CUDA support covers only all-reduce and broadcast), so a gloo
mesh on one card is a correctness path, not a fast one. If NCCL's setup
fails, building the mesh raises; nothing falls back to gloo.

This module is the only one of the port that imports
``torch.distributed``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "pipe", "seq", "expert", "model")
# the groups each rank builds, in this order on every rank
GROUPS = (("pipe",), ("seq",), ("expert",), ("model",), ("expert", "model"), AXES)
DEFAULT_TIMEOUT_S = 300.0


def mesh_timeout() -> float:
    """Seconds any collective of a mesh may wait (``SUTRO_MESH_TIMEOUT``,
    default 300): a dead or hung rank makes the others raise after it."""
    return float(os.environ.get("SUTRO_MESH_TIMEOUT", DEFAULT_TIMEOUT_S))


def init_distributed() -> Optional[Tuple[int, int]]:
    """``(rank, world)`` of a process launched by ``torchrun`` (its
    ``RANK`` and ``WORLD_SIZE``; ``MASTER_ADDR`` / ``MASTER_PORT`` name the
    store, :func:`env_store`), or None outside such a launch. The
    reference forwards the ``JAX_*`` variables to
    ``jax.distributed.initialize``; here the mesh's groups are built on
    the store when the runner connects."""
    if not os.environ.get("MASTER_ADDR") or "RANK" not in os.environ:
        return None
    return int(os.environ["RANK"]), int(os.environ.get("WORLD_SIZE", "1"))


def env_store(rank: int, world: int, timeout: Optional[float] = None):
    """The TCP store of a ``torchrun`` launch (rank 0 hosts it)."""
    return dist.TCPStore(
        os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]), world,
        rank == 0, datetime.timedelta(seconds=timeout or mesh_timeout()),
    )


def file_store(path: str, world: int):
    """A store in a file that every rank of one host can open."""
    return dist.FileStore(path, world)


def backend_for(devices: Sequence[torch.device]) -> str:
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh's ranks must all be on the CPU or all on CUDA: {devices}")
    idx = [_card(d) for d in devices]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


# the share of a card kept back when ranks share it: their CUDA contexts
# and the caching allocators' slack
SHARED_CARD_MARGIN = 0.015


def _card(d: torch.device) -> int:
    return d.index if d.index is not None else 0


def shared_card_fraction(devices: Sequence, device) -> Optional[float]:
    """The share of its card that the allocator of the rank on
    ``device`` may take when ``n`` > 1 ranks of ``devices`` share that
    card: ``1/n`` less ``SHARED_CARD_MARGIN``. None on the CPU and on a
    card of its own."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    n = sum(1 for d in map(torch.device, devices)
            if d.type == "cuda" and _card(d) == _card(device))
    return 1.0 / n - SHARED_CARD_MARGIN if n > 1 else None


def _devices(devices) -> List[torch.device]:
    if devices is None:
        n = torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(d) for d in devices]


class Group:
    """One process group of a mesh: ``ranks`` (world ranks, in group-rank
    order) and this rank's place in it. Collectives take and return
    tensors on the rank's device."""

    def __init__(self, pg, ranks: List[int], rank: int, backend: str):
        self.pg = pg
        self.ranks = ranks
        self.rank = ranks.index(rank)
        self.size = len(ranks)
        self.backend = backend
        self.calls = 0          # collectives issued (the mesh layer's counter)
        self.seconds = 0.0      # host seconds spent in them

    def _wait(self, work) -> None:
        t0 = time.perf_counter()
        work.wait()
        self.seconds += time.perf_counter() - t0

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """What the process group sees: host copies under gloo."""
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.detach().to("cpu")
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over the group; sums in float32 under gloo (bfloat16
        partial sums are widened on the host) and returns ``t``."""
        self.calls += 1
        x = self._stage(t)
        if self.backend == "gloo" and x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        x = x.contiguous()
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._wait(self.pg.allreduce([x], opts))
        if x is not t:
            t.copy_(x)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in group order."""
        self.calls += 1
        x = self._stage(t).contiguous()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        self._wait(self.pg.allgather([outs], [x]))
        return torch.cat(outs, dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of group rank ``src`` into ``t`` on every rank."""
        self.calls += 1
        x = self._stage(t).contiguous()
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        self._wait(self.pg.broadcast([x], opts))
        if x is not t:
            t.copy_(x)
        return t

    def send(self, t: torch.Tensor, dst: int, tag: int = 0) -> None:
        self.calls += 1
        self._wait(self.pg.send([self._stage(t).contiguous()], dst, tag))

    def recv(self, t: torch.Tensor, src: int, tag: int = 0) -> torch.Tensor:
        """Into ``t`` (its shape and dtype say what arrives)."""
        self.calls += 1
        x = self._stage(t)
        x = x if x.is_contiguous() else x.contiguous()
        self._wait(self.pg.recv([x], src, tag))
        if x is not t:
            t.copy_(x)
        return t

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in group order (host only)."""
        data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        n = torch.tensor([data.numel()], dtype=torch.int64)
        sizes = self.all_gather(n).tolist()
        buf = torch.zeros(max(sizes), dtype=torch.uint8)
        buf[: data.numel()] = data
        outs = self.all_gather(buf[None], 0)
        return [pickle.loads(outs[i, : sizes[i]].numpy().tobytes()) for i in range(self.size)]

    def broadcast_object(self, obj=None, src: int = 0):
        """``obj`` of group rank ``src`` on every rank (host only)."""
        n = torch.zeros(1, dtype=torch.int64)
        data = None
        if self.rank == src:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
            n[0] = data.numel()
        self.broadcast(n, src)
        if data is None:
            data = torch.empty(int(n[0]), dtype=torch.uint8)
        self.broadcast(data, src)
        return obj if self.rank == src else pickle.loads(data.numpy().tobytes())

    def shift(self, tensors: List[torch.Tensor], tag: int = 0) -> List[torch.Tensor]:
        """One step around the ring: each tensor goes to group rank
        ``r + 1`` and comes from ``r - 1`` (the reference's
        ``ppermute``). Even ranks send first and odd ranks receive first,
        so no two ranks wait on each other's send."""
        self.calls += 1
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        outs = []
        for i, t in enumerate(tensors):
            x = self._stage(t).contiguous()
            o = torch.empty_like(x)
            pair = [lambda: self.pg.send([x], nxt, tag + i),
                    lambda: self.pg.recv([o], prv, tag + i)]
            for post in pair if self.rank % 2 == 0 else pair[::-1]:
                self._wait(post())
            outs.append(o)
        return [o.to(t.device) for o, t in zip(outs, tensors)]


class Mesh:
    """The ``(data, pipe, seq, expert, model)`` grid of ``devices`` (one
    per rank) and, once :meth:`connect` ed, this rank's process groups.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does; ``rank`` is this process's rank, ``device`` its device."""

    def __init__(self, sizes: Sequence[int], devices: Sequence[torch.device]):
        self.shape: Dict[str, int] = dict(zip(AXES, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes))
        self.devices = list(devices)
        self.backend = backend_for(self.devices)
        self.rank = 0
        self.groups: Dict[Tuple[str, ...], Optional[Group]] = {}
        self.connected = False

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        r = self.rank if rank is None else rank
        return dict(zip(AXES, (int(c) for c in np.unravel_index(r, tuple(self.shape.values())))))

    def members(self, axes: Sequence[str], rank: Optional[int] = None) -> List[int]:
        """World ranks that share every coordinate but ``axes`` with
        ``rank``, in the order of their coordinates along ``axes``."""
        c = self.coords(rank)
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        idx = tuple(slice(None) if a in axes else c[a] for a in AXES)
        return [int(r) for r in grid[idx].reshape(-1)]

    def connect(self, store, rank: int, timeout: Optional[float] = None) -> "Mesh":
        """Build this rank's groups on ``store`` (every rank calls it).
        Raises if a group cannot be set up; nothing falls back."""
        self.rank = rank
        td = datetime.timedelta(seconds=timeout or mesh_timeout())
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        for axes in GROUPS:
            ranks = self.members(axes)
            if len(ranks) == 1:
                self.groups[axes] = None
                continue
            prefix = "g/" + ",".join(axes) + "/" + ",".join(map(str, ranks))
            self.groups[axes] = Group(
                self._pg(dist.PrefixStore(prefix, store), ranks.index(rank), len(ranks), td),
                ranks, rank, self.backend,
            )
        # the control channel: gloo over the world, host tensors only,
        # waiting as long as an engine may sit idle between calls
        self.ctrl = Group(
            dist.ProcessGroupGloo(dist.PrefixStore("ctrl", store), rank, self.size,
                                  datetime.timedelta(days=7)),
            list(range(self.size)), rank, "gloo",
        )
        self.connected = True
        return self

    def _pg(self, store, rank: int, size: int, timeout):
        if self.backend == "gloo":
            return dist.ProcessGroupGloo(store, rank, size, timeout)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(store, rank, size, opts)
        # NCCL communicators start lazily: one all-reduce here makes a
        # setup failure raise while the mesh is built
        probe = torch.zeros(1, device=self.device)
        pg.allreduce([probe]).wait()
        torch.cuda.synchronize(self.device)
        return pg

    def group(self, *axes: str) -> Optional[Group]:
        """This rank's group over ``axes`` (None when it has one member)."""
        return self.groups.get(tuple(axes))

    @property
    def world(self) -> Optional[Group]:
        return self.groups.get(AXES)

    def close(self) -> None:
        for g in (*self.groups.values(), getattr(self, "ctrl", None)):
            if g is not None:
                try:
                    g.pg.shutdown()
                except (RuntimeError, AttributeError):
                    pass  # already torn down by a failed peer
        self.groups = {}
        self.connected = False


def make_mesh(
    dp: int = 1,
    ep: int = 1,
    tp: int = 1,
    devices: Optional[Sequence] = None,
    *,
    sp: int = 1,
    pp: int = 1,
) -> Mesh:
    """The grid over the first ``dp*pp*sp*ep*tp`` of ``devices`` (one per
    rank; default ``cuda:0 .. cuda:N-1``). Raises when there are fewer."""
    devices = _devices(devices)
    need = dp * pp * sp * ep * tp
    if need > len(devices):
        raise ValueError(
            f"Mesh dp*pp*sp*ep*tp={need} exceeds available devices "
            f"{len(devices)}"
        )
    return Mesh((dp, pp, sp, ep, tp), devices[:need])


def auto_mesh(ecfg, devices: Optional[Sequence] = None) -> Mesh:
    """Resolve the engine config against the devices given."""
    devices = _devices(devices)
    dp, pp, sp, ep, tp = ecfg.resolved_mesh(len(devices))
    return make_mesh(dp, ep, tp, devices, sp=sp, pp=pp)


def mesh_shape(mesh: Mesh) -> Tuple[int, int, int, int, int]:
    return tuple(mesh.shape[a] for a in AXES)  # type: ignore[return-value]
