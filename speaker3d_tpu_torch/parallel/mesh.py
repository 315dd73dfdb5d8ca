"""Device mesh and sharding over ``torch.distributed``, and the per-process
split of host-side work lists.

The counterpart of ``speaker3d_tpu/parallel/mesh.py``: a ``('data',
'model')`` mesh, data parallelism over ``data`` (the batch split, gradients
summed) and the classifier's classes over ``model`` (the vocab-parallel AAM
loss, ``train/losses.py``). JAX runs one process per host that addresses
many devices; the port runs one process per card (torchrun's idiom), so a
mesh is a grid of global ranks. Each rank knows its coordinates, the
process groups of its two axes and of the whole mesh, and its device. On
the CPU the backend is ``gloo``, on the card ``nccl``; nothing falls back
from one to the other.

A mesh made with no process group (one process that never called
``init_multihost``) is the world of that process alone: its collectives
are identities, so every mesh path runs unchanged in one process.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device

AXES = ("data", "model")


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """The ``('data', 'model')`` grid of global ranks (``devices``, as the
    JAX mesh's grid of devices) seen from this rank: ``shape``, this rank's
    ``coords`` (None outside the mesh), the process groups of the ``data``
    axis (the ranks of this rank's model column), the ``model`` axis (the
    ranks of its data row) and the whole mesh, and its ``device``."""

    def __init__(self, devices: np.ndarray, device):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}
        self.axis_names = AXES
        self.device = resolve_device(device)
        self.rank = _world()[0]
        self.coords = self.coords_of(self.rank)
        self.groups = self._new_groups()

    @property
    def size(self) -> int:
        return self.devices.size

    def coords_of(self, rank: int) -> Optional[dict]:
        """``{'data': i, 'model': j}`` of a global rank, None outside."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            return None
        return {"data": int(where[0][0]), "model": int(where[0][1])}

    def _new_groups(self) -> dict:
        """One group per data column, per model row and for the whole mesh,
        keyed by the axes they span; only this rank's are kept. Every rank of
        the world calls ``new_group`` for every group, in one order, as
        ``torch.distributed`` requires, also for groups it is not in."""
        groups = {"data": None, "model": None, AXES: None}
        if not (dist.is_available() and dist.is_initialized()):
            return groups
        spans = ([("data", self.devices[:, j]) for j in
                  range(self.shape["model"])]
                 + [("model", self.devices[i, :]) for i in
                    range(self.shape["data"])]
                 + [(AXES, self.devices.reshape(-1))])
        for axes, ranks in spans:
            ranks = [int(r) for r in ranks]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                groups[axes] = group
        return groups

    def group(self, axes: Union[str, Tuple[str, ...]]):
        """The process group spanning ``axes`` ('data', 'model' or both);
        None when this process is the whole world."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups[AXES if set(axes) == set(AXES) else axes[0]]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return self.coords[axis]

    def members(self, axes) -> list:
        """The global ranks of this rank's group over ``axes``, in mesh
        order (row-major)."""
        i, j = self.index("data"), self.index("model")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        rows = slice(None) if "data" in axes else slice(i, i + 1)
        cols = slice(None) if "model" in axes else slice(j, j + 1)
        return [int(r) for r in self.devices[rows, cols].reshape(-1)]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, coords="
                f"{self.coords}, device={self.device})")


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None,
              device=DEFAULT_DEVICE) -> Mesh:
    """Mesh over ('data', 'model') of the global ranks ``devices`` (all of
    the world's by default); the data axis defaults to all that remain.
    ``device`` is this rank's (``cuda`` is the card that ``init_multihost``
    made current)."""
    devices = list(devices) if devices is not None else list(
        range(_world()[1]))
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    grid = np.asarray(devices[: data * model], np.int64).reshape(data, model)
    return Mesh(grid, device)


def balanced_devices(n_total: int) -> list:
    """The first ``n_total / nodes`` ranks OF EACH node, in node order: a
    mesh over fewer ranks than the world then gives every node (torchrun's
    ``LOCAL_WORLD_SIZE`` ranks each) rows of it. ``range(n)`` would take
    node 0's ranks first."""
    _, world = _world()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_nodes = max(1, world // per_node)
    if n_total % n_nodes:
        raise ValueError(f"{n_total} mesh devices not divisible by "
                         f"{n_nodes} processes")
    per = n_total // n_nodes
    out = []
    for p in range(n_nodes):
        ranks = list(range(p * per_node, min((p + 1) * per_node, world)))
        if len(ranks) < per:
            raise ValueError(f"process {p} has {len(ranks)} devices, "
                             f"needs {per}")
        out.extend(ranks[:per])
    return out


class Placement(NamedTuple):
    """Where a tensor lives on a mesh, as JAX's ``NamedSharding``: ``spec``
    names the mesh axis that splits each dimension (None: whole)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def data_sharded(mesh: Mesh, ndim: int = 1) -> Placement:
    return Placement(mesh, ("data",) + (None,) * (ndim - 1))


def model_sharded(mesh: Mesh, ndim: int = 2) -> Placement:
    return Placement(mesh, ("model",) + (None,) * (ndim - 1))


def shard(x, placement: Placement) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``placement``, on
    the mesh's device: a dimension split over an axis of size n gives the
    rank at coordinate i its i-th of n contiguous blocks (``P('data')`` is
    contiguous rows), as JAX lays a global array out on a mesh."""
    mesh = placement.mesh
    x = torch.as_tensor(x)
    for dim, axis in enumerate(placement.spec):
        if axis is None:
            continue
        n, i = mesh.shape[axis], mesh.index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} is not "
                             f"divisible by the {axis} axis ({n})")
        block = x.shape[dim] // n
        x = x.narrow(dim, i * block, block)
    return x.to(mesh.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` held along ``axis`` joined on ``dim`` in
    coordinate order: the inverse of ``shard`` on that axis."""
    group = mesh.group(axis)
    if group is None:
        return x
    members = mesh.members(axis)
    parts = [torch.empty_like(x) for _ in members]
    dist.all_gather(parts, x.contiguous(), group=group)
    # a group's ranks are numbered in ascending global order
    by_rank = dict(zip(sorted(members), parts))
    return torch.cat([by_rank[r] for r in members], dim=dim)


def all_reduce_(x: torch.Tensor, mesh: Mesh, axes, op=None) -> torch.Tensor:
    """``x`` reduced in place over ``axes`` (SUM unless ``op``)."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _PSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the cotangent:
    the transpose JAX's ``psum`` takes under shard_map autodiff."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (identity for None)."""
    return x if group is None else _PSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Maximum over ``group`` of a tensor that needs no gradient."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _env(name: str) -> Optional[str]:
    return os.environ.get("SPEAKER3D_" + name) or None


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device=DEFAULT_DEVICE,
                   timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join this process to the run's process group: the counterpart of the
    JAX package's ``jax.distributed`` start, called at the top of every
    CLI's ``main()``.

    Each field resolves as the argument, then ``SPEAKER3D_COORDINATOR_
    ADDRESS`` / ``SPEAKER3D_NUM_PROCESSES`` / ``SPEAKER3D_PROCESS_ID``, then
    torchrun's ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. With
    no coordinator anywhere this is a no-op that touches no backend and
    returns False. With one, it starts the group (``gloo`` for a CPU
    ``device``, ``nccl`` for the card, after making the rank's card,
    ``LOCAL_RANK`` or the rank modulo the cards, current) and failures
    propagate: a silent fall-back to N single runs would write N copies of
    every checkpoint and shard nothing. Returns True iff a process group is
    up after the call."""
    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = _env("COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if num_processes is None:
        v = _env("NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
        num_processes = int(v) if v else None
    if process_id is None:
        v = _env("PROCESS_ID") or os.environ.get("RANK")
        process_id = int(v) if v else None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} is set but the number of "
            f"processes ({num_processes}) or this process's id "
            f"({process_id}) is not: set SPEAKER3D_NUM_PROCESSES and "
            f"SPEAKER3D_PROCESS_ID (or torchrun's WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kwargs)
    return True


def process_rank_count() -> tuple:
    """(rank, count): SPEAKER3D_PROC_INDEX/COUNT (set by local fan-out),
    else the process group's (``init_multihost``), else RANK/WORLD_SIZE
    (torchrun), else (0, 1)."""
    if "SPEAKER3D_PROC_INDEX" in os.environ:
        return (int(os.environ["SPEAKER3D_PROC_INDEX"]),
                int(os.environ.get("SPEAKER3D_PROC_COUNT", 1)))
    if dist.is_available() and dist.is_initialized():
        return _world()
    if "RANK" in os.environ:
        return int(os.environ["RANK"]), int(os.environ.get("WORLD_SIZE", 1))
    return 0, 1


def process_rank() -> int:
    """This process's shard identity (``process_rank_count``), which names
    its per-rank output files."""
    return process_rank_count()[0]


def process_shard(items, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Round-robin shard of a work list by process (rank::world)."""
    rank, count = process_rank_count()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = count
    return list(items)[process_index::process_count]


def is_main_process() -> bool:
    """Rank 0 of the process group, or a process with none: the one that
    writes logs, checkpoints and the config copy."""
    return _world()[0] == 0
