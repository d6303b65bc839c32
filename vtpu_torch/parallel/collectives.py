"""The collectives of tensor-parallel serving: every one goes through here.

Two kinds run on the serving path: the all-reduce of the row-parallel
partial sums (after ``wo`` and after ``w_down`` in every layer), and the
broadcast of rank 0's step calls to the other ranks (serving/adapters.py).
JAX's single controller needs neither by hand: XLA places the all-reduces
from the shardings and every chip sees the same program.

Where a tensor lives and where the backend takes it can differ: gloo takes
CPU tensors (ranks that share one card run over gloo, since NCCL refuses two
ranks on one device), NCCL takes CUDA tensors. ``_staged`` makes that move
explicitly, before the collective, for every op alike: a CUDA tensor under
gloo goes through host memory and back. Nothing tries the backend first and
falls back on a refusal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(mesh):
    """The mesh's process group; a mesh built by hand joined none."""
    if mesh.group is None:
        raise RuntimeError(f"tp={mesh.size} rank {mesh.rank}: this mesh joined no process "
                           "group (make_tp_mesh), so no collective runs on it")
    return mesh.group


def _staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the backend takes it: on the host for gloo, on the rank's
    card for nccl. The same tensor when it already lies there."""
    want = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return x if x.device == want else x.to(want)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the tp ranks, in x's dtype. The identity when
    ``mesh`` is None or holds one rank.

    The partial sums are reduced in float32 and cast back once: a bf16
    all-reduce rounds at every hop and drifts from the single-card trunk,
    whose matmul sums the whole row in f32 before its one rounding. (The
    reference leaves the reduction dtype to XLA, which does not pin it.)"""
    if mesh is None or mesh.size == 1:
        return x
    acc = _staged(x.to(torch.float32), mesh)
    if acc is x:
        acc = acc.clone()  # an f32 x on the backend's device: never reduce in place
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=_group(mesh))
    return acc.to(device=x.device, dtype=x.dtype)


def broadcast_(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` on every rank with rank ``src``'s ``x``, in place.
    Returns x."""
    buf = _staged(x, mesh)
    dist.broadcast(buf, src=src, group=_group(mesh))
    if buf is not x:
        x.copy_(buf)
    return x
