"""Carry a parameter tree from numpy into the port's layout.

The port keeps the reference's layouts (stacked [L, d_in, d_out] weights
applied as ``x @ w``, tied embeddings), so conversion is a copy plus a cast
to ``cfg.dtype``. Callers hand over float32 copies: numpy has no bfloat16 of
its own, and the extension type a bf16 array converts to is refused by
``torch.from_numpy``. bf16 -> f32 -> bf16 is lossless. The MoE router and
the SSM's ``a_log`` and ``dt_bias`` stay float32 in a bf16 model, as the
reference keeps them."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.parallel.sharding import shard_moe_params, shard_params


def _expected_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, f, l, qd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.qkv_dim
    return {
        "embed": (cfg.vocab, d), "final_norm": (d,),
        "wq": (l, d, qd), "wk": (l, d, qd), "wv": (l, d, qd), "wo": (l, qd, d),
        "w_gate": (l, d, f), "w_up": (l, d, f), "w_down": (l, f, d),
        "attn_norm": (l, d), "mlp_norm": (l, d),
    }


def _moe_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, f, l, e = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
    return {**_expected_shapes(cfg), "router": (l, d, e), "w_gate": (l, e, d, f),
            "w_up": (l, e, d, f), "w_down": (l, e, f, d)}


def _ssm_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, di, n, l = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_layers
    return {
        "embed": (cfg.vocab, d), "final_norm": (d,),
        "in_proj": (l, d, 2 * di), "conv_w": (l, cfg.d_conv, di), "x_proj": (l, di, 2 * n + 1),
        "dt_bias": (l,), "a_log": (l, di, n), "d_skip": (l, di), "out_proj": (l, di, d),
        "norm": (l, d),
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


def _checked(tree: dict, shapes: dict) -> dict:
    """The tree's arrays, each checked against its shape."""
    return {
        "embed": _array("embed", tree["embed"], shapes["embed"]),
        "layers": {key: _array(key, tree["layers"][key], shapes[key])
                   for key in shapes if key not in ("embed", "final_norm")},
        "final_norm": _array("final_norm", tree["final_norm"], shapes["final_norm"]),
    }


def _to_torch(part: dict, cfg, device, f32: tuple = ()) -> dict:
    """Carry a checked tree to ``device``: every leaf in ``cfg.dtype`` but
    the layer leaves named in ``f32``, which stay float32."""

    def tensor(arr, dtype):
        return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=dtype)

    return {"embed": tensor(part["embed"], cfg.dtype),
            "layers": {key: tensor(x, torch.float32 if key in f32 else cfg.dtype)
                       for key, x in part["layers"].items()},
            "final_norm": tensor(part["final_norm"], cfg.dtype)}


def params_from_numpy(tree: dict, cfg, device=None, mesh=None) -> dict:
    """{"embed", "layers": {...}, "final_norm"} of float numpy arrays ->
    the port's parameter dict on ``device`` in ``cfg.dtype``. With ``mesh``
    (a TpMesh) only this rank's tensor-parallel shard is sliced out and
    carried over (parallel/sharding.py), so the whole tree never reaches
    the device."""
    full = _checked(tree, _expected_shapes(cfg))
    return _to_torch(full if mesh is None else shard_params(full, mesh), cfg,
                     resolve_device(device))


def moe_params_from_numpy(tree: dict, cfg, device=None, mesh=None) -> dict:
    """The MoE family's tree (``init_moe_params``' layout) -> the port's
    parameter dict on ``device``: every leaf in ``cfg.dtype`` but the
    router, which stays float32 as the reference keeps it. With ``mesh``
    only this rank's shard (``shard_moe_params``) is carried over."""
    full = _checked(tree, _moe_shapes(cfg))
    return _to_torch(full if mesh is None else shard_moe_params(full, mesh), cfg,
                     resolve_device(device), f32=("router",))


def ssm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The selective SSM's tree (``init_ssm_params``' layout) -> the port's
    parameter dict on ``device``: every leaf in ``cfg.dtype`` but ``a_log``
    and ``dt_bias``, which stay float32 as the reference keeps them."""
    return _to_torch(_checked(tree, _ssm_shapes(cfg)), cfg, resolve_device(device),
                     f32=("a_log", "dt_bias"))
