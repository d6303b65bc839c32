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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# split axis of each per-layer weight over 'tp' (None: replicated), in the
# layout of transformer.init_params: [L, d_in, d_out]
_LAYER_AXIS = {
    "wq": 2, "wk": 2, "wv": 2, "w_gate": 2, "w_up": 2,
    "wo": 1, "w_down": 1,
    "attn_norm": None, "mlp_norm": None,
}

# head axis of each KV plane, counted from the end
_PAGED_HEAD_AXIS = {"k": -2, "v": -2, "k_scale": -1, "v_scale": -1}


def param_shardings() -> dict[str, Any]:
    """The split axis of every parameter, as a tree shaped like
    transformer.init_params' (None: replicated)."""
    return {"embed": None, "layers": dict(_LAYER_AXIS), "final_norm": None}


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


def shard_params(params: dict, mesh) -> dict:
    """This rank's shard of a full parameter tree (tensors or numpy arrays):
    each leaf sliced per ``param_shardings``, replicated ones as they are."""
    if mesh.size == 1:
        return params
    rules = param_shardings()

    def part(x, axis):
        return x if axis is None else head_shard(x, axis, mesh)

    return {
        "embed": part(params["embed"], rules["embed"]),
        "layers": {key: part(x, rules["layers"][key]) for key, x in params["layers"].items()},
        "final_norm": part(params["final_norm"], rules["final_norm"]),
    }
