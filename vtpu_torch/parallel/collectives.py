"""Every collective of the port goes through here, serving's and training's.

Serving runs three kinds: the all-reduce of the row-parallel partial sums
(after ``wo`` and after ``w_down`` in every layer), the broadcast of rank
0's step calls to the other ranks (serving/adapters.py), and the
all-gather of a migrating session's head shards. Training
adds the collectives JAX differentiates through in ``shard_map`` bodies:
``ppermute`` (ring attention, the pipeline), ``all_to_all`` (Ulysses, the
expert exchange) and ``psum``. JAX's single controller needs none of them
by hand for the tensor-parallel trunk: XLA places the all-reduces from the
shardings and every chip sees the same program.

Where a tensor lives and where the backend takes it can differ: gloo takes
CPU tensors (ranks that share one card run over gloo, since NCCL refuses two
ranks on one device), NCCL takes CUDA tensors. ``_staged`` makes that move
explicitly, before the collective, for every op alike: a CUDA tensor under
gloo goes through host memory and back. Nothing tries the backend first and
falls back on a refusal.

Autograd. Each op's backward is the transpose JAX uses, chosen so that a
loss replicated on every rank, backpropagated on every rank, gives every
rank the gradient ``jax.grad`` gives (nothing counted once per rank):

- ``all_reduce_sum`` (Megatron's **g**): the sum forward, the identity
  backward. It turns partial sums into a value every rank holds whole, and
  the cotangent of such a value arrives whole on every rank.
- ``copy_to_axis`` (Megatron's **f**): the identity forward, the sum
  backward. It marks where a value every rank holds whole enters work that
  differs by rank (before a column-parallel projection, a parameter
  replicated over a data axis): its gradient is the sum of every rank's.
- ``ppermute``: the inverse permutation backward.
- ``all_to_all``: the exchange with its two axes swapped backward.

``torch.distributed.nn``'s all-reduce differentiates to another all-reduce,
which counts a replicated loss's gradient once per rank; these ops do not.
A backward that runs a collective must run on every rank of its group in
the same order: every caller builds the same graph on every rank, and what
a rank does differently lives in tensor values, never in which ops run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(mesh):
    """The mesh's process group; a mesh built by hand joined none."""
    if mesh.group is None:
        raise RuntimeError(f"{mesh.axis}={mesh.size} rank {mesh.rank}: this mesh joined no "
                           "process group, so no collective runs on it")
    return mesh.group


def _staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the backend takes it: on the host for gloo, on the rank's
    card for nccl. The same tensor when it already lies there."""
    want = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return x if x.device == want else x.to(want)


def _peer(mesh, r: int) -> int:
    """The global rank of rank ``r`` of the mesh's group."""
    group = _group(mesh)
    return r if group is dist.group.WORLD else dist.get_global_rank(group, r)


def _reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, reduced in float32 and cast
    back to x's dtype once. x itself is never written."""
    acc = _staged(x.to(torch.float32), mesh)
    if acc is x:
        acc = acc.clone()  # an f32 x on the backend's device: never reduce in place
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=_group(mesh))
    return acc.to(device=x.device, dtype=x.dtype)


def _permute(x: torch.Tensor, perm, mesh) -> torch.Tensor:
    """Send x to each pair's destination and receive from its source: a
    rank that is no destination receives zeros, as ``lax.ppermute`` gives."""
    me = mesh.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    buf = _staged(x.contiguous(), mesh)
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, _peer(mesh, d), _group(mesh)) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, _peer(mesh, s), _group(mesh)) for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


def _exchange(x: torch.Tensor, split: int, concat: int, mesh) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: x split into size chunks along
    ``split``, chunk j to rank j, and the chunks received concatenated
    along ``concat`` in rank order."""
    n = mesh.size
    if x.shape[split] % n:
        raise ValueError(f"all_to_all over {n} ranks: axis {split} of {tuple(x.shape)} "
                         "does not split")
    send = _staged(torch.stack(x.chunk(n, dim=split)).contiguous(), mesh)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=_group(mesh))
    return torch.cat(recv.to(x.device).unbind(0), dim=concat)


class _Sum(torch.autograd.Function):
    """g: the sum forward, the cotangent as it is backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """f: x as it is forward, the sum of the cotangents backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.mesh), None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, mesh):
        ctx.perm, ctx.mesh = perm, mesh
        return _permute(x, perm, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, [(d, s) for s, d in ctx.perm], ctx.mesh), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, mesh):
        ctx.axes, ctx.mesh = (split, concat), mesh
        return _exchange(x, split, concat, mesh)

    @staticmethod
    def backward(ctx, grad):
        split, concat = ctx.axes
        return _exchange(grad, concat, split, ctx.mesh), None, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks, in x's dtype (g: the identity
    backward). The identity when ``mesh`` is None or holds one rank.

    The partial sums are reduced in float32 and cast back once: a bf16
    all-reduce rounds at every hop and drifts from the single-card trunk,
    whose matmul sums the whole row in f32 before its one rounding. (The
    reference leaves the reduction dtype to XLA, which does not pin it.)"""
    if mesh is None or mesh.size == 1:
        return x
    return _Sum.apply(x, mesh) if _tracked(x) else _reduce(x, mesh)


def copy_to_axis(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as it is (f: the sum over the mesh's ranks backward). The
    identity when ``mesh`` is None or holds one rank, or when nothing
    differentiates through x."""
    if mesh is None or mesh.size == 1 or not _tracked(x):
        return x
    return _Copy.apply(x, mesh)


def ppermute(x: torch.Tensor, perm, mesh) -> torch.Tensor:
    """``lax.ppermute`` over the mesh's ranks: ``perm`` is a list of
    (source, destination) pairs of the group's ranks; a rank that is no
    destination gets zeros. Differentiable: the inverse permutation
    backward."""
    return _Permute.apply(x, tuple(perm), mesh)


def all_to_all(x: torch.Tensor, split: int, concat: int, mesh) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)`` over the mesh's ranks. Differentiable: the exchange with
    the two axes swapped backward."""
    return _Exchange.apply(x, split, concat, mesh)


def broadcast_(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` on every rank with the ``x`` of the mesh's rank
    ``src``, in place. Returns x."""
    buf = _staged(x, mesh)
    dist.broadcast(buf, src=_peer(mesh, src), group=_group(mesh))
    if buf is not x:
        x.copy_(buf)
    return x


def all_gather(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` (the same shape and dtype on each), in the mesh's
    rank order, on x's device."""
    buf = _staged(x.contiguous(), mesh)
    out = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(out, buf, group=_group(mesh))
    return [o.to(x.device) for o in out]
