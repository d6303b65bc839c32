"""The next-token train step on one card and over dp x tp and multislice
meshes (counterpart of vtpu/parallel/train.py).

The reference annotates and jits: parameters carry tp shardings, the batch
is dp-split, and XLA emits the per-layer tp all-reduces and the gradient
reduction. Here each rank runs the trunk on its tp shard of the
parameters (sharding.py) and its rows of the batch (``place_batch``): the
Megatron pair in the trunk (collectives.py) gives every tp rank the
reference's gradient of its shard, and after the backward one all-reduce
a batch axis ('dp', then 'slice' on a multislice mesh: within a slice
first, then one hop across) sums the gradients, whose loss was already
divided by the number of row blocks. The loss is the global batch's mean.

The optimizer is ``torch.optim.AdamW`` with optax.adamw's defaults, not
torch's: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on every leaf
(optax's ``mask=None``). Both apply p -= lr (m_hat / (sqrt(v_hat) + eps)
+ wd p). The moments live in the parameters' dtype, as optax keeps them.

Training runs with ``use_kernels=False``, as the reference's step sets
``use_pallas=False``: the flash kernel has no backward in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from vtpu_torch.models.transformer import transformer_forward
from vtpu_torch.ops.loss import next_token_ce
from vtpu_torch.parallel.collectives import all_reduce_sum
# place_batch is the reference's train.place_batch; the rule lives in sharding.py
from vtpu_torch.parallel.sharding import batch_sharding, place_batch, shard_params  # noqa: F401


def next_token_loss(params: dict, cfg, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy of the dense trunk on ``tokens`` [B, S].
    ``mesh``: a 'tp' axis (``Mesh.axis("tp")``) with ``params`` its shard,
    or None."""
    return next_token_ce(transformer_forward(params, cfg, tokens, mesh), tokens)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw's hyperparameters; ``init`` builds the torch optimizer
    over a parameter tree's leaves, in the tree's order (``leaves``)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(leaves(params), lr=self.lr, betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay)


def adamw(lr: float = 1e-3) -> AdamW:
    """optax.adamw(lr), as a torch optimizer's recipe."""
    return AdamW(lr=lr)


def leaves(tree: dict) -> list:
    """The tensors of a parameter tree in a fixed order: embed, the layer
    leaves in the tree's order, final_norm."""
    return [tree["embed"], *tree["layers"].values(), tree["final_norm"]]


def named_leaves(tree: dict) -> list[tuple[str, torch.Tensor]]:
    """``leaves`` with their paths ("embed", "layers.wq", ...)."""
    return ([("embed", tree["embed"])]
            + [(f"layers.{k}", w) for k, w in tree["layers"].items()]
            + [("final_norm", tree["final_norm"])])


def _leaf(x: torch.Tensor, device) -> torch.Tensor:
    return x.detach().to(device).clone().requires_grad_()


def init_train_state(params: dict, cfg, mesh=None, lr: float = 1e-3):
    """(state, opt): ``params`` is the full tree (the port's seeded
    ``init_params``, or ``convert.params_from_numpy``); the state holds
    this rank's tp shard of it as trainable leaves on the mesh's device (or
    the tree's own, with no mesh), the optimizer over them
    (``"opt_state"``) and the mesh."""
    opt = adamw(lr)
    if mesh is not None and "tp" in mesh.shape:
        params = shard_params(params, mesh.axis("tp"))
    device = params["embed"].device if mesh is None else mesh.device
    local = {"embed": _leaf(params["embed"], device),
             "layers": {k: _leaf(w, device) for k, w in params["layers"].items()},
             "final_norm": _leaf(params["final_norm"], device)}
    return {"params": local, "opt_state": opt.init(local), "mesh": mesh}, opt


def _batch_axes(mesh) -> list:
    return [] if mesh is None else [mesh.axis(a) for a in batch_sharding(mesh)]


def reduce_grads(params: dict, axes: list) -> None:
    """Sum every leaf's gradient over each axis of ``axes``, in place: one
    all-reduce of all the gradients (flat, f32) an axis."""
    if not axes:
        return
    grads = [p.grad for p in leaves(params)]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    for ax in axes:
        flat = all_reduce_sum(flat, ax)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def make_train_step(cfg, opt: AdamW) -> Callable:
    """``step(state, tokens) -> (state, loss)``: one AdamW step on this
    rank's rows ``tokens`` (``place_batch`` of the global batch); the loss
    is the global batch's mean, whole on every rank. The state is updated
    in place; after the step each leaf's ``.grad`` holds the gradient it
    applied."""
    train_cfg = dataclasses.replace(cfg, use_kernels=False)

    def step(state, tokens):
        mesh, params, optim = state["mesh"], state["params"], state["opt_state"]
        optim.zero_grad()
        tp = mesh.axis("tp") if mesh is not None and "tp" in mesh.shape else None
        loss = next_token_loss(params, train_cfg, tokens, tp)
        axes = _batch_axes(mesh)
        for ax in axes:
            loss = all_reduce_sum(loss, ax) / ax.size
        loss.backward()
        reduce_grads(params, axes)
        optim.step()
        return state, loss.detach()

    return step
