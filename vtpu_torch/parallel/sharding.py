"""Which slice of each tensor a tensor-parallel rank holds (counterpart of
vtpu/parallel/sharding.py).

Megatron-style, as in the reference: q/k/v/gate/up are split on their
output axis (each rank owns n_heads / tp heads and d_ff / tp hidden units),
o/down on their input axis, so each layer's attention and MLP end in one
partial sum per rank, summed by ``collectives.all_reduce_sum``. Norms are
replicated.

The embedding stays replicated here. The reference splits its d_model axis
(``P(None, "tp")``), and XLA then reduces the tied logits matmul over 'tp'
and gathers the embedded rows. A replicated table computes the same
function with neither collective, and gloo, which serves ranks that share
one card, has no all-gather of CUDA tensors. At the flagship widths
(vocab 8192 x d_model 1024, bf16) it is 16.8 MB per rank.

The KV cache and the paged pool split their head axis (``_PAGED_HEAD_AXIS``,
counted from the end so the same rule covers the pool [L, n_blocks, page,
H, Dh], its scale pools [L, n_blocks, page, H] and the dense cache); page
tables and lengths are replicated. A rank allocates its head shard directly
(transformer.init_kv_cache / init_paged_kv_cache with ``mesh``); the
unsharded pool never exists.

The MoE family under serving's 'tp' (``moe_tp_param_shardings``,
``shard_moe_params``): attention as above, the router replicated (f32,
tiny, and it decides the routing), the expert stacks [L, E, ...] split on
their expert axis when tp divides n_experts and replicated otherwise, the
embedding replicated as in the dense rule.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# split axis of each per-layer weight over 'tp' (None: replicated), in the
# layout of transformer.init_params: [L, d_in, d_out]
_LAYER_AXIS = {
    "wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_gate": 2, "w_up": 2, "w_down": 1,
    "attn_norm": None, "mlp_norm": None,
}

# head axis of each KV plane, counted from the end
_PAGED_HEAD_AXIS = {"k": -2, "v": -2, "k_scale": -1, "v_scale": -1}


def param_shardings() -> dict[str, Any]:
    """The split axis of every parameter, as a tree shaped like
    transformer.init_params' (None: replicated)."""
    return {"embed": None, "layers": dict(_LAYER_AXIS), "final_norm": None}


def param_split_axes() -> dict[str, Any]:
    """``param_shardings`` flat: the split axis of each leaf by its path
    ("embed", "layers.wq", ..., "final_norm"), in init_params' order."""
    return {"embed": None, **{f"layers.{k}": a for k, a in _LAYER_AXIS.items()},
            "final_norm": None}


def head_shard(x, axis: int, mesh):
    """This rank's contiguous 1/tp of ``x`` along ``axis`` (a numpy array or
    a tensor; negative axes count from the end). A tensor comes back as its
    own contiguous copy, so the unsharded storage is not kept alive."""
    axis = axis % x.ndim
    n, tp = x.shape[axis], mesh.size
    if n % tp:
        raise ValueError(f"tp={tp} must divide axis {axis} of a {tuple(x.shape)} tensor")
    part = n // tp
    out = x[(slice(None),) * axis + (slice(mesh.rank * part, (mesh.rank + 1) * part),)]
    if torch.is_tensor(out):
        return out.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(out)


def _shard(params: dict, rules: dict, mesh) -> dict:
    """This rank's slice of every leaf of ``params`` per ``rules`` (a tree of
    split axes, None: replicated, kept as it is)."""
    if mesh.size == 1:
        return params

    def part(x, axis):
        return x if axis is None else head_shard(x, axis, mesh)

    return {
        "embed": part(params["embed"], rules["embed"]),
        "layers": {key: part(x, rules["layers"][key]) for key, x in params["layers"].items()},
        "final_norm": part(params["final_norm"], rules["final_norm"]),
    }


def shard_params(params: dict, mesh) -> dict:
    """This rank's shard of a full parameter tree (tensors or numpy arrays):
    each leaf sliced per ``param_shardings``, replicated ones as they are."""
    return _shard(params, param_shardings(), mesh)


# the MoE's expert stacks [L, E, d_in, d_out]: the expert axis
_EXPERT_AXIS = 1


def moe_tp_param_shardings(n_experts: int, tp: int) -> dict[str, Any]:
    """The split axis of every MoE parameter under ``tp`` ranks, as a tree
    shaped like models.moe.init_moe_params' (None: replicated): the expert
    stacks split their expert axis only when ``tp`` divides ``n_experts``."""
    ep = _EXPERT_AXIS if n_experts % tp == 0 else None
    layers = {key: _LAYER_AXIS[key] for key in ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm")}
    layers.update(router=None, w_gate=ep, w_up=ep, w_down=ep)
    return {"embed": None, "layers": layers, "final_norm": None}


def shard_moe_params(params: dict, mesh) -> dict:
    """This rank's shard of a full MoE parameter tree (tensors or numpy
    arrays), per ``moe_tp_param_shardings`` (n_experts read off the
    router)."""
    return _shard(params, moe_tp_param_shardings(params["layers"]["router"].shape[-1],
                                                 mesh.size), mesh)


# the axes a batch splits over, in mesh order: data parallelism, the slices
# of a multislice mesh, and the expert axis (each ep rank routes its own rows)
_BATCH_AXES = ("slice", "dp", "ep")


def batch_sharding(mesh) -> tuple[str, ...]:
    """The mesh axes the batch [B, ...] splits over (the reference's
    ``P(("slice", "dp"), None)`` on a multislice mesh, ``P("dp", None)``
    on a dp x tp one): the sequence and every other axis replicated."""
    return tuple(a for a in mesh.axis_names if a in _BATCH_AXES)


def place_batch(tokens, mesh):
    """This rank's rows of a global batch [B, ...] (a tensor or a numpy
    array, the same on every rank): its contiguous block over
    ``batch_sharding``'s axes, the first axis outermost."""
    axes = batch_sharding(mesh)
    n = int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))
    if tokens.shape[0] % n:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by {axes} mesh size {n}")
    block, rows = 0, tokens.shape[0] // n
    for a in axes:
        block = block * mesh.shape[a] + mesh.coords[a]
    return tokens[block * rows:(block + 1) * rows]

