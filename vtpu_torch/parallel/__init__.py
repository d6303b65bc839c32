"""Parallelism of the port (counterpart of vtpu/parallel): one process per
rank over ``torch.distributed``, where JAX runs one controller over a mesh.

- ``mesh``: the world a rank joins (``World``, ``join_world``) and its
  meshes, dp x tp, sp, pp, multislice and dp x ep, one process group per
  axis; ``AxisMesh`` is a mesh's view of one axis, and ``TpMesh`` (the
  same class) serving's ('tp',) mesh, ``own_group`` the same ranks on a
  group of their own (a second engine in the world).
- ``collectives``: every collective, with the backward JAX differentiates
  by (the Megatron pair ``copy_to_axis`` / ``all_reduce_sum``,
  ``ppermute``, ``all_to_all``), and serving's ``broadcast_`` and
  ``all_gather``.
- ``sharding``: which slice of each parameter a rank holds, and its rows
  of a batch.
- ``train``: the AdamW train step on one card and over dp x tp and
  multislice meshes; ``checkpoint``: sharded save and resume onto any
  geometry.
- ``ring``, ``ulysses``, ``longctx``: sequence parallelism; ``pipeline``:
  the GPipe schedule; ``expert``: expert parallelism.
- ``launch``: starting the ranks, and the loop serving's ranks other than
  0 run.

Each function of a parallel path takes this rank's shard of the
parameters and of the data (``shard_params``, ``place_batch``,
``place_sp_tokens``, ``shard_stages``, ``shard_ep_params``) and returns
this rank's shard of a sharded output and the whole of a replicated one,
as a ``shard_map`` body does; the gradient each rank gets of its shard is
that shard of ``jax.grad``'s.
"""

from vtpu_torch.parallel.collectives import (
    all_gather, all_reduce_sum, all_to_all, broadcast_, copy_to_axis, ppermute,
)
from vtpu_torch.parallel.mesh import (
    AxisMesh, Mesh, TpMesh, World, join_world, make_axis_mesh, make_dp_ep_mesh, make_mesh,
    make_multislice_mesh, make_sp_mesh, make_tp_mesh, mesh_shape_for, own_group,
)
from vtpu_torch.parallel.sharding import (
    batch_sharding, head_shard, moe_tp_param_shardings, param_shardings, param_split_axes,
    place_batch, shard_moe_params, shard_params,
)
from vtpu_torch.parallel.ring import ring_attention
from vtpu_torch.parallel.longctx import place_sp_tokens, sp_loss, sp_prefill
from vtpu_torch.parallel.ulysses import ulysses_attention
from vtpu_torch.parallel.expert import (
    ep_moe_forward, ep_moe_loss, make_ep_ffn, moe_param_shardings, shard_ep_params,
)
from vtpu_torch.parallel.pipeline import (
    microbatch, pipeline_apply, pp_loss, pp_transformer_forward, shard_stages,
)
from vtpu_torch.parallel.train import (
    adamw, init_train_state, make_train_step, next_token_loss,
)
from vtpu_torch.parallel.checkpoint import TrainCheckpointer

__all__ = [
    "AxisMesh",
    "Mesh",
    "TpMesh",
    "TrainCheckpointer",
    "World",
    "adamw",
    "all_gather",
    "all_reduce_sum",
    "all_to_all",
    "batch_sharding",
    "broadcast_",
    "copy_to_axis",
    "ep_moe_forward",
    "ep_moe_loss",
    "head_shard",
    "init_train_state",
    "join_world",
    "make_axis_mesh",
    "make_dp_ep_mesh",
    "make_ep_ffn",
    "make_mesh",
    "make_multislice_mesh",
    "make_sp_mesh",
    "make_tp_mesh",
    "make_train_step",
    "mesh_shape_for",
    "microbatch",
    "moe_param_shardings",
    "moe_tp_param_shardings",
    "next_token_loss",
    "own_group",
    "param_shardings",
    "param_split_axes",
    "pipeline_apply",
    "place_batch",
    "place_sp_tokens",
    "ppermute",
    "pp_loss",
    "pp_transformer_forward",
    "ring_attention",
    "shard_ep_params",
    "shard_moe_params",
    "shard_params",
    "shard_stages",
    "sp_loss",
    "sp_prefill",
    "ulysses_attention",
]
