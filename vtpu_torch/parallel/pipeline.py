"""Pipeline parallelism: the transformer's layers staged over a 'pp' axis
(counterpart of vtpu/parallel/pipeline.py).

The GPipe schedule of the reference's ``_pp_body``: stage i owns L/n
contiguous layers (``shard_stages``) and runs them on every one of the
M + n - 1 ticks; stage 0 feeds microbatch t at tick t, every other stage
the activation stage i - 1 sent it the tick before (``ppermute``, i to
i + 1), and the last stage's output at tick t is microbatch t - (n - 1).
Only the last stage keeps its outputs; the sum over 'pp' (``all_reduce_sum``)
then hands them whole to every stage.

Gradients are the reference's ``jax.grad``: the microbatches enter the
schedule through ``copy_to_axis``, so their cotangent, which arises on
stage 0 alone, comes back whole to every stage, and with it the embedding
lookup's share of the embedding's gradient; the LM head's share arises on
every stage alike. What a stage does differently lives in values, never in
which ops run (collectives.py): every stage blends its input from the
microbatch and the received activation by 0/1 weights and weights its
outputs by whether it is the last.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from vtpu_torch.models.transformer import _rope_tables, transformer_layer
from vtpu_torch.ops import rms_norm
from vtpu_torch.ops.loss import next_token_ce
from vtpu_torch.parallel.collectives import all_reduce_sum, copy_to_axis, ppermute


def microbatch(x, n_micro: int):
    """[B, ...] -> [M, B/M, ...] microbatches for the pipeline schedule."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


def shard_stages(params: dict, mesh, axis: str = "pp") -> dict:
    """This stage's contiguous L/n of every stacked layer leaf of
    ``params`` (each its own copy); the embedding and the final norm whole.
    A tree of layer leaves alone ({name: [L, ...]}) gives its slice."""
    n, idx = mesh.shape[axis], mesh.coords[axis]
    layers = params.get("layers", params)
    n_layers = next(iter(layers.values())).shape[0]
    if n_layers % n:
        raise ValueError(f"n_layers={n_layers} not divisible by '{axis}' mesh size {n}")
    part = n_layers // n
    local = {k: w[idx * part:(idx + 1) * part].clone() for k, w in layers.items()}
    if "layers" not in params:
        return local
    return {**params, "layers": local}


def pipeline_apply(layer_params: dict, xs: torch.Tensor,
                   stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run the stacked layers over microbatches through the pipeline.

    layer_params: this stage's layers ({name: [L/n, ...]}, shard_stages);
    xs: [M, ...] microbatched activations, the same on every stage;
    stage_fn(lp, x) -> x applies ONE layer. Returns [M, ...] outputs, whole
    on every stage."""
    pp = mesh.axis(axis)
    n, m = pp.size, xs.shape[0]
    if m < n:
        raise ValueError(f"need >= {n} microbatches to fill the pipeline, got {m}")
    n_local = next(iter(layer_params.values())).shape[0]
    first, last = float(pp.rank == 0), float(pp.rank == n - 1)
    xs = copy_to_axis(xs, pp)
    perm = [(i, i + 1) for i in range(n - 1)]  # stage 0 receives zeros
    recv = torch.zeros_like(xs[0])
    outs = []
    for t in range(m + n - 1):
        # past M, stage 0 replays the last microbatch; its result never
        # reaches the last stage before the schedule ends
        y = xs[min(t, m - 1)] * first + recv * (1.0 - first)
        for j in range(n_local):
            y = stage_fn({k: w[j] for k, w in layer_params.items()}, y)
        if t >= n - 1:  # the last stage just finished microbatch t - (n - 1)
            outs.append(y * last)
        if t < m + n - 2:
            recv = ppermute(y, perm, pp)
    return all_reduce_sum(torch.stack(outs), pp)


def pp_transformer_forward(params, cfg, tokens: torch.Tensor, mesh,
                           n_micro: int | None = None) -> torch.Tensor:
    """Pipelined forward of the flagship transformer: logits [B, S, V] f32,
    whole on every stage. ``params``: this stage's shard (shard_stages).
    The embedding and the LM head run on every stage (tiny next to the
    layer stack); the stack is pipelined over 'pp'."""
    n = mesh.shape["pp"]
    if cfg.n_layers % n:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by 'pp' mesh size {n}")
    if n_micro is None:
        n_micro = max(n, 2)
    b, s = tokens.shape
    dev = tokens.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))

    def layer(lp, x):
        positions = torch.arange(s, device=dev).expand(x.shape[0], s)
        y, _kv = transformer_layer(cfg, lp, x, cos, sin, positions)
        return y

    x = params["embed"][tokens].to(cfg.dtype)
    ys = pipeline_apply(params["layers"], microbatch(x, n_micro), layer, mesh)
    y = rms_norm(ys.reshape(b, s, cfg.d_model), params["final_norm"])
    return (y @ params["embed"].T).float()


def pp_loss(params, cfg, tokens: torch.Tensor, mesh, n_micro: int | None = None) -> torch.Tensor:
    """Next-token cross-entropy through the pipeline (differentiable)."""
    return next_token_ce(pp_transformer_forward(params, cfg, tokens, mesh, n_micro), tokens)
