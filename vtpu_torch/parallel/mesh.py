"""The meshes of the port (counterpart of vtpu/parallel/mesh.py).

JAX runs every mesh from one controller over a ``Mesh`` of devices; the
port runs one process per rank over ``torch.distributed`` instead. A
``World`` is one rank's place in the n-rank world it joined
(``join_world``). A ``Mesh`` is one rank's view of that world laid out on
named axes, ``('dp', 'tp')``, ``('sp',)``, ``('pp',)``,
``('slice', 'dp', 'tp')`` or ``('dp', 'ep')``, with one process group per
axis. ``mesh.axis(name)`` is this rank's view of one axis as an
``AxisMesh`` (its index along the axis, the axis' size, the group), which
is what every collective (collectives.py) and every sharding rule
(sharding.py) reads.

Axis order matters as it does in the reference: the last axis is the most
tightly coupled (tensor parallelism's per-layer all-reduces), the first the
loosest (data parallelism's one gradient reduction a step; the slice axis
of a multislice mesh, which crosses nodes). Ranks are laid out on the grid
in order, so a node's ranks are contiguous along the last axes.

The groups come from ``torch.distributed.device_mesh.DeviceMesh`` (named
per-axis groups; the checkpoint's DTensors are laid out on it). Under gloo
its device type is "cpu" even when the ranks compute on a card: gloo takes
host tensors, and every collective stages through host memory
(collectives.py).

Serving's mesh is an ``AxisMesh`` over a ``('tp',)`` world of its own
(``make_tp_mesh``), under its serving name ``TpMesh``; each further engine
of that world takes the same ranks on a group of its own (``own_group``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a rank that dies mid-collective fails its peers after this long instead
# of hanging them
GROUP_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """One rank's view of one mesh axis, ``('tp',)`` unless named
    otherwise: the rank's index along it, the axis' size, the device the
    rank computes on, the backend, and the process group every collective
    over the axis runs on (whole_world_axis, Mesh.axis). A mesh built by hand
    has no group: it names one rank's shard, which is all the head-local
    kernel calls and ``shard_params`` read, and a collective on it raises
    (collectives.py)."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    group: Optional[Any] = None
    axis: str = "tp"

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a {self.axis} axis of {self.size}")

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}

    def close(self) -> None:
        """Leave the process group (every rank of a serving world calls this
        once at the end)."""
        if dist.is_initialized():
            dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's place in a world of ``size`` processes: its rank, the
    device it computes on and the backend (join_world). A world built by
    hand joined nothing: the mesh builders validate against it and build
    no group."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"

    def close(self) -> None:
        """Leave the world (every rank calls this once at the end)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def join_world(n: int, backend: str, init_method: str, rank: int, device) -> World:
    """Join an ``n``-rank world as ``rank`` and return its World.

    ``backend`` is "nccl" (one card per rank) or "gloo" (CPU tensors, or
    ranks sharing one card; collectives stage through host memory); it is
    never guessed. ``init_method`` is the rendezvous, e.g.
    ``file:///tmp/x/store`` or ``tcp://localhost:29500``. The group times
    out after GROUP_TIMEOUT_S, so a dead rank fails the run."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device per rank, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return World(rank=rank, size=n, device=device, backend=backend)


# serving's name for its mesh, a ('tp',) world of its own
TpMesh = AxisMesh


def whole_world_axis(world: World, axis: str = "tp") -> AxisMesh:
    """The AxisMesh whose one axis is the whole of the joined ``world``."""
    return AxisMesh(rank=world.rank, size=world.size, device=world.device,
                    backend=world.backend, group=dist.group.WORLD, axis=axis)


def own_group(mesh: AxisMesh) -> AxisMesh:
    """``mesh`` on a process group of its own over the same ranks: a second
    serving engine's broadcast protocol in the same world runs on it, so
    the two engines' collectives never interleave. ``dist.new_group``'s
    rule holds: every rank of the world calls this, in the same order.

    Gloo only. Each engine's group is driven by a thread of its own on
    every rank, so collectives of different groups run concurrently in no
    order common to the ranks; NCCL communicators used so can deadlock
    (as can a synchronizing call, a pinned allocation or a blocking copy,
    made while another communicator's kernel spins). NCCL waits for a
    per-rank order of every engine's collectives."""
    if mesh.backend == "nccl":
        raise ValueError(
            f"{mesh.axis}={mesh.size}: a process group of its own for a further engine is "
            "gloo only; several engines' NCCL groups driven concurrently have no "
            "collective order common to the ranks and can deadlock")
    group = mesh.group
    if group is None:
        raise RuntimeError(f"{mesh.axis}={mesh.size} rank {mesh.rank}: this mesh joined no "
                           "process group to split")
    ranks = [r if group is dist.group.WORLD else dist.get_global_rank(group, r)
             for r in range(mesh.size)]
    fresh = dist.new_group(ranks=ranks, backend=mesh.backend,
                           timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dataclasses.replace(mesh, group=fresh)


def make_tp_mesh(tp: int, backend: str, init_method: str, rank: int, device) -> TpMesh:
    """Join a ``tp``-rank serving world as ``rank`` and return its mesh
    (join_world's arguments; every collective runs over the whole world)."""
    return whole_world_axis(join_world(tp, backend, init_method, rank, device))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of its world laid out on named axes.

    ``grid`` holds the world's ranks in the mesh's shape; ``shape`` reads
    as a JAX Mesh's does ({name: size}, in axis order) and ``coords`` gives
    this rank's index along each axis. ``device_mesh`` is the DeviceMesh
    whose per-axis groups the collectives run on (None for a mesh built on
    a World built by hand)."""

    world: World
    axis_names: tuple
    grid: np.ndarray
    device_mesh: Optional[Any] = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def coords(self) -> dict[str, int]:
        at = np.argwhere(self.grid == self.world.rank)[0]
        return {name: int(i) for name, i in zip(self.axis_names, at)}

    @property
    def device(self) -> torch.device:
        return self.world.device

    def axis(self, name: str) -> AxisMesh:
        """This rank's view of axis ``name``: its index along it, the axis'
        size and (on a joined world) the axis' process group."""
        if name not in self.axis_names:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        group = None if self.device_mesh is None else self.device_mesh.get_group(name)
        return AxisMesh(rank=self.coords[name], size=self.shape[name],
                        device=self.world.device, backend=self.world.backend, group=group,
                        axis=name)


def _mesh(world: World, names: tuple, ranks: Sequence[int], shape: tuple) -> Mesh:
    """The mesh of ``ranks`` (every rank of the world, in grid order) laid
    out as ``shape`` on ``names``: on a joined world every rank builds the
    same per-axis groups, in the same order."""
    if len(ranks) != world.size:
        raise ValueError(f"a mesh of {len(ranks)} ranks in a world of {world.size}: every "
                         "rank of the world joins the mesh")
    grid = np.asarray(ranks, dtype=np.int64).reshape(shape)
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import DeviceMesh

        device_type = "cpu" if world.backend == "gloo" else world.device.type
        device_mesh = DeviceMesh(device_type, torch.from_numpy(grid), mesh_dim_names=names)
    return Mesh(world=world, axis_names=tuple(names), grid=grid, device_mesh=device_mesh)


def _count(world: World, n_devices: Optional[int]) -> int:
    n = world.size if n_devices is None else n_devices
    if n > world.size:
        raise ValueError(f"requested {n} devices, have {world.size}")
    return n


def mesh_shape_for(n_devices: int, tp: int | None = None) -> tuple[int, int]:
    """Pick a (dp, tp) factorization. Prefers the largest power-of-two tp that
    divides n_devices, capped at 4 so dp stays >= 2 on an 8-chip host."""
    if tp is None:
        tp = 1
        while tp * 2 <= min(4, n_devices) and n_devices % (tp * 2) == 0:
            tp *= 2
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide n_devices={n_devices}")
    return n_devices // tp, tp


def make_mesh(world: World, n_devices: int | None = None, tp: int | None = None) -> Mesh:
    """The ('dp', 'tp') mesh of the world's ranks (mesh_shape_for's split)."""
    n = _count(world, n_devices)
    dp, tpn = mesh_shape_for(n, tp)
    return _mesh(world, ("dp", "tp"), range(n), (dp, tpn))


def make_axis_mesh(world: World, axis: str, n_devices: int | None = None) -> Mesh:
    """A 1D mesh over one named axis ('sp' for sequence, 'ep' for expert,
    'pp' for pipeline parallelism)."""
    n = _count(world, n_devices)
    return _mesh(world, (axis,), range(n), (n,))


def make_sp_mesh(world: World, n_devices: int | None = None) -> Mesh:
    """The 1D ('sp',) mesh of ring and Ulysses sequence parallelism."""
    return make_axis_mesh(world, "sp", n_devices)


def _slice_ids(world: World, total: int) -> Optional[list]:
    """Each rank's node when the launcher says (torchrun's
    LOCAL_WORLD_SIZE: ranks are numbered node by node), else None."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None or int(local) >= total:
        return None
    return [r // int(local) for r in range(total)]


def make_multislice_mesh(world: World, n_slices: int, per_slice: int | None = None,
                         tp: int | None = None, slice_ids: Sequence[int] | None = None) -> Mesh:
    """The 3D ('slice', 'dp', 'tp') mesh of a multislice job.

    A TPU slice's ``slice_index`` has no CUDA counterpart: a slice is a
    node. ``slice_ids`` gives each rank's slice; without it the launcher's
    LOCAL_WORLD_SIZE does (ranks numbered node by node); without either,
    as on one host, consecutive ranks form a slice, as the reference groups
    virtual devices. 'tp' stays inside a slice and the batch splits over
    ('slice', 'dp'), so the gradient reduction is hierarchical: over 'dp'
    inside each slice, then one hop over 'slice'."""
    if per_slice is None:
        if world.size % n_slices:
            raise ValueError(f"{world.size} devices do not split into {n_slices} slices")
        per_slice = world.size // n_slices
    total = n_slices * per_slice
    if total > world.size:
        raise ValueError(f"requested {total} devices, have {world.size}")
    ids = list(slice_ids) if slice_ids is not None else _slice_ids(world, total)
    if ids is not None and len(set(ids[:total])) == n_slices:
        by_slice: dict = {}
        for r in range(total):
            by_slice.setdefault(ids[r], []).append(r)
        groups = [by_slice[s] for s in sorted(by_slice)]
        if any(len(g) != per_slice for g in groups):
            raise ValueError(
                f"slices are uneven: {[len(g) for g in groups]} != {per_slice} each")
        ordered = [r for g in groups for r in g]
    else:
        ordered = list(range(total))
    dp, tpn = mesh_shape_for(per_slice, tp)
    return _mesh(world, ("slice", "dp", "tp"), ordered, (n_slices, dp, tpn))


def make_dp_ep_mesh(world: World, n_devices: int | None = None, ep: int | None = None) -> Mesh:
    """The 2D ('dp', 'ep') mesh of expert-parallel training: 'ep' inner,
    because the MoE all-to-all is the chatty collective."""
    n = _count(world, n_devices)
    if ep is None:
        ep = 1
        while ep * 2 <= min(4, n) and n % (ep * 2) == 0:
            ep *= 2
    if n % ep:
        raise ValueError(f"ep={ep} does not divide n_devices={n}")
    return _mesh(world, ("dp", "ep"), range(n), (n // ep, ep))
