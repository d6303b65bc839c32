"""Expert parallelism: the MoE's expert axis split over an 'ep' axis
(counterpart of vtpu/parallel/expert.py).

The reference has two paths over the same model (models/moe.py): expert
stacks annotated ``P(None, 'ep', ...)`` with XLA placing the exchange, and
``make_ep_ffn``'s explicit ``shard_map``. The port has the explicit one:
each rank routes its own rows of the batch, a dispatch einsum groups the
slots by expert, one ``all_to_all`` hands every rank the slots of its
experts, ``expert_ffn`` runs them on the rank's expert shard, a second
``all_to_all`` returns them, and the combine einsum weighs them back; the
aux statistic is averaged over the axis. Capacity comes from the rank's
own token count, as the reference computes it (``expert.py:63``), so
where a choice drops the output differs from the dense route's.

A rank's parameters are its expert shard (``shard_ep_params``): attention,
router, norms and embedding whole, the expert stacks [L, E/n, ...]. On a
('dp', 'ep') mesh the batch splits over both axes (sharding.place_batch).
The replicated leaves enter through ``copy_to_axis`` over every batch
axis and the expert stacks over the others, so each rank's gradient is its
shard of ``jax.grad``'s (collectives.py).
"""

from __future__ import annotations

import torch

from vtpu_torch.models.moe import expert_ffn, moe_forward, route
from vtpu_torch.ops.loss import next_token_ce
from vtpu_torch.parallel.collectives import all_reduce_sum, all_to_all, copy_to_axis
from vtpu_torch.parallel.sharding import _EXPERT_AXIS, _shard, batch_sharding

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def moe_param_shardings(mesh, ep_axis: str = "ep") -> dict:
    """The split axis over ``ep_axis`` of every MoE parameter, as a tree
    shaped like models.moe.init_moe_params' (None: replicated): the expert
    stacks [L, E, ...] on their expert axis; attention and the router
    replicated (the router must see every expert's logit)."""
    if ep_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.shape} has no axis {ep_axis!r}")
    layers = {k: None for k in ("wq", "wk", "wv", "wo", "router", "attn_norm", "mlp_norm")}
    layers.update({k: _EXPERT_AXIS for k in _EXPERT_KEYS})
    return {"embed": None, "layers": layers, "final_norm": None}


def _check_experts(n_experts: int, n: int, axis: str) -> None:
    if n_experts % n:
        raise ValueError(
            f"expert parallelism needs n_experts % mesh['{axis}'] == 0, "
            f"got {n_experts} experts over {n} devices"
        )


def shard_ep_params(params: dict, mesh, axis: str = "ep") -> dict:
    """This rank's shard of a full MoE tree per ``moe_param_shardings``."""
    _check_experts(params["layers"]["router"].shape[-1], mesh.shape[axis], axis)
    return _shard(params, moe_param_shardings(mesh, axis), mesh.axis(axis))


def make_ep_ffn(mesh, axis: str = "ep"):
    """An ``ffn(lp, x, cfg) -> (out, aux)`` for models.moe.moe_forward:
    x is this rank's rows [B_loc, S, D], lp's expert stacks its shard
    [E/n, ...]."""
    ep = mesh.axis(axis)

    def ffn(lp, x, cfg):
        n = ep.size
        _check_experts(cfg.n_experts, n, axis)
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        dispatch, combine, aux = route(lp["router"], flat, cfg, cfg.capacity(b * s))
        # [T, E, C] x [T, D] -> [E, C, D]: every expert's slots, grouped so
        # the exchange hands each rank its experts' slots from every rank
        slots = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), flat)
        recv = all_to_all(slots, 0, 1, ep)  # [E/n, n C, D]
        back = all_to_all(expert_ffn(lp, recv), 1, 0, ep)  # [E, C, D]
        out = torch.einsum("tec,ecd->td", combine.to(x.dtype), back)
        return out.reshape(b, s, d), all_reduce_sum(aux, ep) / n

    return ffn


def _data_parallel(params: dict, mesh, axis: str) -> dict:
    """Every replicated leaf through ``copy_to_axis`` over each batch axis,
    the expert stacks over each but ``axis``."""
    rules = moe_param_shardings(mesh, axis)
    axes = batch_sharding(mesh)

    def over(w, split):
        for a in axes:
            if split is None or a != axis:
                w = copy_to_axis(w, mesh.axis(a))
        return w

    return {"embed": over(params["embed"], None),
            "layers": {k: over(w, rules["layers"][k]) for k, w in params["layers"].items()},
            "final_norm": over(params["final_norm"], None)}


def ep_moe_forward(params: dict, cfg, tokens: torch.Tensor, mesh, axis: str = "ep"):
    """Expert-parallel full-sequence forward of this rank's rows
    (``place_batch``) on its shard (``shard_ep_params``): (logits of the
    rows [B_loc, S, V] f32, aux averaged over ``axis``)."""
    return moe_forward(_data_parallel(params, mesh, axis), cfg, tokens,
                       ffn=make_ep_ffn(mesh, axis))


def ep_moe_loss(params: dict, cfg, tokens: torch.Tensor, mesh, axis: str = "ep") -> torch.Tensor:
    """``moe_loss`` of the global batch through ``ep_moe_forward``, whole
    on every rank: the cross-entropy averaged over every batch axis, plus
    0.01 x the aux, itself averaged over ``axis`` in the block and over the
    other batch axes here."""
    logits, aux = ep_moe_forward(params, cfg, tokens, mesh, axis)
    ep = mesh.axis(axis)
    loss = all_reduce_sum(next_token_ce(logits, tokens), ep) / ep.size + 0.01 * aux
    for a in batch_sharding(mesh):
        if a != axis:
            loss = all_reduce_sum(loss, mesh.axis(a)) / mesh.shape[a]
    return loss
