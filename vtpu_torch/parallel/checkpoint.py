"""Sharded checkpoint and resume of the train state (counterpart of
vtpu/parallel/checkpoint.py, orbax there, ``torch.distributed.checkpoint``
here).

A checkpoint written from one mesh restores onto any other geometry: each
rank's shard is saved as a DTensor laid out on the mesh (``Shard(axis)``
over 'tp' by the dense rule, ``Replicate()`` over the data axes), and the
restore builds its targets on the new mesh, so DCP reshards on read and
each rank reads only the slices it holds. Replicated shards are written
once. The optimizer's moments are laid out as their parameters, its step
count replicated.

Layout: ``<dir>/<step>/``, one DCP checkpoint a step. A save writes into
``<dir>/.tmp-<step>/`` and, after every rank has written, rank 0 renames
it, so a preempted save never leaves a partial step behind; then it prunes
all but the newest ``keep``. Every rank calls save and restore (both are
collectives); the directory is one that every rank sees.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from vtpu_torch.convert import _expected_shapes
from vtpu_torch.device import resolve_device
from vtpu_torch.parallel.sharding import param_split_axes
from vtpu_torch.parallel.train import AdamW, leaves, named_leaves


def _host(x: torch.Tensor, mesh) -> torch.Tensor:
    """Where a DTensor's local shard lives: the host under gloo (the
    DeviceMesh's device type is "cpu" there), the rank's card under nccl."""
    x = x.detach()
    return x.cpu() if mesh.world.backend == "gloo" else x


def _dtensor(local: torch.Tensor, path: str, mesh):
    """``local``, this rank's shard of leaf ``path``, as a DTensor on the
    mesh (a plain tensor with no mesh)."""
    if mesh is None:
        return local.detach()
    from torch.distributed.tensor import DTensor, Replicate, Shard

    axis = param_split_axes()[path]
    placements = [Shard(axis) if name == "tp" and axis is not None else Replicate()
                  for name in mesh.axis_names]
    return DTensor.from_local(_host(local, mesh), mesh.device_mesh, placements,
                              run_check=False)


def _barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier()


class TrainCheckpointer:
    """Save and restore the train state (``init_train_state``'s) with
    keep-N retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` as step ``step`` (every rank calls this)."""
        mesh, optim = state["mesh"], state["opt_state"]
        named = named_leaves(state["params"])
        moments: dict = {"mu": {}, "nu": {}}
        count = 0.0
        for path, p in named:
            st = optim.state.get(p, {})
            count = float(st["step"]) if st else 0.0
            for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                moments[key][path] = _dtensor(st[name] if st else torch.zeros_like(p), path, mesh)
        sd = {"params": {path: _dtensor(p, path, mesh) for path, p in named}, **moments,
              "count": torch.tensor(count)}
        tmp = self.directory / f".tmp-{step}"
        final = self.directory / str(step)
        dcp.save(sd, checkpoint_id=str(tmp))
        _barrier(mesh)
        if mesh is None or mesh.world.rank == 0:
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(self.directory / str(old))
        _barrier(mesh)

    def restore(self, cfg, mesh, opt: AdamW, step: Optional[int] = None,
                device=None) -> tuple[dict, int]:
        """(state, step) of step ``step`` (the latest by default), laid out
        on ``mesh``, which may split its ranks otherwise than the mesh that
        wrote it (with no mesh, on ``device``). Raises FileNotFoundError
        when there is no step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint step found")
        tp = mesh.shape.get("tp", 1) if mesh is not None else 1
        device = resolve_device(device) if mesh is None else mesh.device
        staging = "cpu" if mesh is None or mesh.world.backend == "gloo" else device
        axes, shapes = param_split_axes(), _expected_shapes(cfg)
        sd: dict = {"count": torch.tensor(0.0)}
        for key in ("params", "mu", "nu"):
            sd[key] = {}
            for path, axis in axes.items():
                shape = list(shapes[path.split(".")[-1]])
                if axis is not None:
                    shape[axis] //= tp
                sd[key][path] = _dtensor(torch.zeros(shape, dtype=cfg.dtype, device=staging),
                                         path, mesh)
        dcp.load(sd, checkpoint_id=str(self.directory / str(step)))

        def local(x):
            return (x.to_local() if hasattr(x, "to_local") else x).to(device)

        tree = {path: local(x).requires_grad_() for path, x in sd["params"].items()}
        params = {"embed": tree["embed"], "final_norm": tree["final_norm"],
                  "layers": {p.split(".", 1)[1]: x for p, x in tree.items()
                             if p.startswith("layers.")}}
        optim = opt.init(params)
        count = float(sd["count"])
        if count:
            for (path, _), p in zip(named_leaves(params), leaves(params)):
                optim.state[p] = {"step": torch.tensor(count),
                                  "exp_avg": local(sd["mu"][path]),
                                  "exp_avg_sq": local(sd["nu"][path])}
        return {"params": params, "opt_state": optim, "mesh": mesh}, step

    def close(self) -> None:
        """Nothing to release: every save has finished when it returns."""
