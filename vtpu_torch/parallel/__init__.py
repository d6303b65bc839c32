"""Tensor-parallel serving of the port (counterpart of vtpu/parallel, the
serving mesh only): one process per rank over ``torch.distributed``.

``mesh`` (TpMesh, make_tp_mesh), ``collectives`` (every TP collective),
``sharding`` (which slice of each tensor a rank holds) and ``launch``
(starting the ranks, and the loop the ranks other than 0 run). The rest of
vtpu/parallel (training, pipeline, ring, ulysses, long-context, expert
parallelism) is a later slice.
"""

from vtpu_torch.parallel.collectives import all_reduce_sum, broadcast_
from vtpu_torch.parallel.mesh import TpMesh, make_tp_mesh
from vtpu_torch.parallel.sharding import (
    head_shard, moe_param_shardings, param_shardings, shard_moe_params, shard_params,
)

__all__ = [
    "TpMesh",
    "all_reduce_sum",
    "broadcast_",
    "head_shard",
    "make_tp_mesh",
    "moe_param_shardings",
    "param_shardings",
    "shard_moe_params",
    "shard_params",
]
