"""Carry a parameter tree from numpy into the port's layout.

The port keeps the reference's layouts (stacked [L, d_in, d_out] weights
applied as ``x @ w``, tied embeddings), so conversion is a copy plus a cast
to ``cfg.dtype``. Callers hand over float32 copies: numpy has no bfloat16 of
its own, and the extension type a bf16 array converts to is refused by
``torch.from_numpy``. bf16 -> f32 -> bf16 is lossless."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.parallel.sharding import shard_params

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "attn_norm", "mlp_norm")


def _expected_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, f, l, qd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.qkv_dim
    return {
        "embed": (cfg.vocab, d), "final_norm": (d,),
        "wq": (l, d, qd), "wk": (l, d, qd), "wv": (l, d, qd), "wo": (l, qd, d),
        "w_gate": (l, d, f), "w_up": (l, d, f), "w_down": (l, f, d),
        "attn_norm": (l, d), "mlp_norm": (l, d),
    }


def _array(name: str, arr: Any, shape: tuple[int, ...]) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype not in (np.float32, np.float64, np.float16):
        raise TypeError(
            f"parameter {name} has dtype {arr.dtype}; pass float32 copies "
            "(np.asarray(x, np.float32))")
    if tuple(arr.shape) != shape:
        raise ValueError(f"parameter {name} has shape {arr.shape}, expected {shape}")
    return arr


def params_from_numpy(tree: dict, cfg, device=None, mesh=None) -> dict:
    """{"embed", "layers": {...}, "final_norm"} of float numpy arrays ->
    the port's parameter dict on ``device`` in ``cfg.dtype``. With ``mesh``
    (a TpMesh) only this rank's tensor-parallel shard is sliced out and
    carried over (parallel/sharding.py), so the whole tree never reaches
    the device."""
    device = resolve_device(device)
    shapes = _expected_shapes(cfg)
    full = {
        "embed": _array("embed", tree["embed"], shapes["embed"]),
        "layers": {key: _array(key, tree["layers"][key], shapes[key]) for key in _LAYER_KEYS},
        "final_norm": _array("final_norm", tree["final_norm"], shapes["final_norm"]),
    }
    part = full if mesh is None else shard_params(full, mesh)

    def tensor(arr):
        return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=cfg.dtype)

    return {"embed": tensor(part["embed"]),
            "layers": {key: tensor(x) for key, x in part["layers"].items()},
            "final_norm": tensor(part["final_norm"])}
