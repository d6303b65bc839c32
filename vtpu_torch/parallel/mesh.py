"""The tensor-parallel mesh of one rank (counterpart of vtpu/parallel/mesh.py).

JAX serves tensor parallelism from one controller over a ``('tp',)`` Mesh
(``make_axis_mesh("tp", n)``); the port runs one process per rank over
``torch.distributed`` instead. A ``TpMesh`` is one rank's view of that
world: its rank, the world size, the process group, the backend and the
device the rank computes on. ``mesh.shape["tp"]`` reads as it does on a JAX
Mesh, so code written against the reference's mesh reads the same.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional

import torch
import torch.distributed as dist

# a rank that dies mid-collective fails its peers after this long instead
# of hanging them
GROUP_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class TpMesh:
    """One rank's view of a ``('tp',)`` world. ``group`` is the process
    group every collective of the world runs over (make_tp_mesh sets it).
    A mesh built by hand has none: it names one rank's head shard, which
    is all the head-local kernel calls and ``shard_params`` read, and a
    collective on it raises (collectives.py)."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    group: Optional[Any] = None

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a tp world of {self.size}")

    @property
    def shape(self) -> dict[str, int]:
        return {"tp": self.size}

    def close(self) -> None:
        """Leave the process group (every rank calls this once at the end)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_tp_mesh(tp: int, backend: str, init_method: str, rank: int, device) -> TpMesh:
    """Join a ``tp``-rank world as ``rank`` and return its mesh.

    ``backend`` is "nccl" (one card per rank) or "gloo" (CPU tensors, or
    ranks sharing one card; collectives stage through host memory, see
    collectives.py); it is never guessed. ``init_method`` is the rendezvous,
    e.g. ``file:///tmp/x/store`` or ``tcp://localhost:29500``. The group
    times out after GROUP_TIMEOUT_S, so a dead rank fails the run."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a CUDA device per rank, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=tp, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return TpMesh(rank=rank, size=tp, device=device, backend=backend, group=dist.group.WORLD)
