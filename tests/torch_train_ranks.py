"""Rank programs of the training tests' spawned gloo worlds
(tests/test_torch_{parallel,seqpar,pp,ep,checkpoint}.py).

A spawned rank imports this module by name, so it imports torch, numpy and
vtpu_torch only, never jax. Each program runs every arm of its test file in
one world and returns plain numpy results; the test process holds them
against the JAX package. Weights come in as the reference's float32 numpy
trees, tokens as numpy arrays, the same on every rank.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from vtpu_torch.convert import moe_params_from_numpy, params_from_numpy
from vtpu_torch.models.moe import moe_forward
from vtpu_torch.models.transformer import prefill
from vtpu_torch.parallel import (
    TrainCheckpointer, ep_moe_forward, ep_moe_loss, init_train_state, make_axis_mesh,
    make_dp_ep_mesh, make_mesh, make_multislice_mesh, make_sp_mesh, make_train_step,
    pipeline_apply, place_batch, place_sp_tokens, pp_loss, pp_transformer_forward,
    ring_attention, shard_ep_params, shard_stages, sp_loss, sp_prefill, ulysses_attention,
)
from vtpu_torch.parallel.launch import launch
from vtpu_torch.parallel.train import named_leaves

WORLD_TIMEOUT_S = 240


def start_world(fn, n: int, store, args: tuple):
    """Run ``fn`` on an ``n``-rank gloo world of CPU ranks (a ``file://``
    store at ``store``) in a background thread, so the test process's JAX
    work overlaps it. Returns ``get()``, which waits for the world and
    returns its ranks' results in rank order (or fails the test that reads
    it with the world's error)."""
    out: dict = {}

    def run():
        try:
            out["ranks"] = launch(fn, n, "gloo", ["cpu"] * n, f"file://{store}", args=args,
                                  timeout=WORLD_TIMEOUT_S)
        except Exception as exc:  # handed to the tests that read this world
            out["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def get():
        thread.join(timeout=2 * WORLD_TIMEOUT_S)
        if "ranks" not in out:
            raise AssertionError(f"the {n}-rank world failed: {out.get('error')!r}")
        return out["ranks"]

    return get


def gather(ranks: list, key: str, path: str, axis, along: str,
           coords: str = "coords") -> np.ndarray:
    """Leaf ``path`` of each rank's ``ranks[r][key]`` put back together:
    the shards of the ranks at index 0 of every other axis (``coords``:
    the key of each rank's mesh coordinates), concatenated along ``axis``
    in their order on mesh axis ``along`` (axis None: rank 0's, the leaf
    being whole on every rank)."""
    if axis is None:
        return ranks[0][key][path]
    lead = [r for r in ranks if all(v == 0 for a, v in r[coords].items() if a != along)]
    lead.sort(key=lambda r: r[coords][along])
    return np.concatenate([r[key][path] for r in lead], axis=axis)


def _np(x: torch.Tensor) -> np.ndarray:
    """A copy (a CPU f32 tensor's numpy() would share its storage, which a
    later step writes)."""
    return x.detach().float().cpu().numpy().copy()


def _tree(tree: dict, grad: bool = False) -> dict:
    """{path: numpy} of a parameter tree's leaves, or of their gradients."""
    return {path: _np(p.grad if grad else p) for path, p in named_leaves(tree)}


def _moments(state: dict) -> dict:
    """The optimizer's state of each leaf: {"exp_avg": {path: numpy},
    "exp_avg_sq": {path: numpy}, "step": {path: count}}."""
    optim = state["opt_state"]
    named = named_leaves(state["params"])
    out = {key: {path: _np(optim.state[p][key]) for path, p in named}
           for key in ("exp_avg", "exp_avg_sq")}
    out["step"] = {path: float(optim.state[p]["step"]) for path, p in named}
    return out


def _trainable(params: dict) -> dict:
    """A copy of every leaf, each a leaf that collects its gradient."""
    def leaf(x):
        return x.detach().clone().requires_grad_()

    return {"embed": leaf(params["embed"]),
            "layers": {k: leaf(w) for k, w in params["layers"].items()},
            "final_norm": leaf(params["final_norm"])}


def _sgd(params: dict, lr: float) -> None:
    with torch.no_grad():
        for _, p in named_leaves(params):
            p -= lr * p.grad
            p.grad = None


# ------------------------------------------------------------ dp x tp


def parallel_world(world, tree, cfg, multi_tree, multi_cfg, tokens, multi_tokens, lr,
                   steps) -> dict:
    """dp2 x tp2: the sharded prefill of this rank's rows; the train step's
    first loss, its gradients and the parameters it left, then ``steps``
    more losses; then a multislice 2 x 1 x 2 mesh's two losses."""
    mesh = make_mesh(world, 4, tp=2)
    tp = mesh.axis("tp")
    out = {"coords": mesh.coords, "shape": mesh.shape}
    rows = torch.from_numpy(place_batch(tokens, mesh))
    with torch.no_grad():
        logits, _ = prefill(params_from_numpy(tree, cfg, device="cpu", mesh=tp), cfg, rows,
                            mesh=tp)
    out["prefill"] = _np(logits)
    full = params_from_numpy(tree, cfg, device="cpu")
    state, opt = init_train_state(full, cfg, mesh, lr=lr)
    step = make_train_step(cfg, opt)
    state, loss = step(state, rows)
    out["loss0"] = loss.item()
    out["grads"] = _tree(state["params"], grad=True)
    out["params1"] = _tree(state["params"])
    out["losses"] = [float(step(state, rows)[1]) for _ in range(steps)]

    ms = make_multislice_mesh(world, 2, per_slice=2, tp=2)
    out["multi_shape"], out["multi_coords"] = ms.shape, ms.coords
    out["multi_rows"] = place_batch(multi_tokens, ms)
    mstate, mopt = init_train_state(params_from_numpy(multi_tree, multi_cfg, device="cpu"),
                                    multi_cfg, ms)
    mstep = make_train_step(multi_cfg, mopt)
    mrows = torch.from_numpy(out["multi_rows"])
    out["multi_losses"] = [float(mstep(mstate, mrows)[1]) for _ in range(2)]
    return out


# ------------------------------------------------------- sequence parallel


def seqpar_world(world, tree, cfg, qkv, qkv_ul, tokens, sp_tokens) -> dict:
    """sp=4: ring and Ulysses on this rank's chunks of q/k/v (and their
    gradients of sum(out * w)), sp_prefill's logits chunk, sp_loss and its
    gradients."""
    mesh = make_sp_mesh(world, 4)
    out = {}
    for name, fn, arrays in (("ring", ring_attention, qkv), ("ulysses", ulysses_attention, qkv_ul)):
        q, k, v, w = (torch.from_numpy(place_sp_tokens(a, mesh)).requires_grad_() for a in arrays)
        o = fn(q, k, v, mesh)
        (o * w.detach()).sum().backward()
        out[name] = _np(o)
        out[f"{name}_grads"] = [_np(x.grad) for x in (q, k, v)]
    params = params_from_numpy(tree, cfg, device="cpu")
    chunk = torch.from_numpy(place_sp_tokens(tokens, mesh))
    with torch.no_grad():
        out["sp_prefill"] = _np(sp_prefill(params, cfg, chunk, mesh))
    params = _trainable(params)
    loss = sp_loss(params, cfg, torch.from_numpy(place_sp_tokens(sp_tokens, mesh)), mesh)
    loss.backward()
    out["sp_loss"] = loss.item()
    out["sp_grads"] = _tree(params, grad=True)
    return out


# ---------------------------------------------------------------- pipeline


def _tanh_layer(lp, x):
    return torch.tanh(x @ lp["w"])


def pp_world(world, w, xs, tree, cfg, tokens, lr, steps) -> dict:
    """pp=4: pipeline_apply over stacked linear layers; the pipelined
    forward's logits; pp_loss and its gradients on this stage's shard;
    then ``steps`` SGD steps' losses."""
    mesh = make_axis_mesh(world, "pp", 4)
    out = {"coords": mesh.coords}
    layers = shard_stages({"w": torch.from_numpy(w)}, mesh)
    with torch.no_grad():
        out["apply"] = _np(pipeline_apply(layers, torch.from_numpy(xs), _tanh_layer, mesh))
    params = shard_stages(params_from_numpy(tree, cfg, device="cpu"), mesh)
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        out["forward"] = _np(pp_transformer_forward(params, cfg, toks, mesh))
    params = _trainable(params)
    loss = pp_loss(params, cfg, toks, mesh)
    loss.backward()
    out["loss0"] = loss.item()
    out["grads"] = _tree(params, grad=True)
    losses = []
    _sgd(params, lr)
    for _ in range(steps):
        loss = pp_loss(params, cfg, toks, mesh)
        loss.backward()
        _sgd(params, lr)
        losses.append(loss.item())
    out["losses"] = losses
    return out


# ------------------------------------------------------------------ experts


def ep_world(world, tree, cfg, tokens, train_tokens, lr, steps) -> dict:
    """ep=4: ep_moe_forward's logits of this rank's rows and its aux, and
    ep_moe_loss with its gradients; dp2 x ep2: the forward, then ``steps``
    SGD steps on ep_moe_loss."""
    out = {}
    full = moe_params_from_numpy(tree, cfg, device="cpu")
    for name, mesh in (("ep", make_axis_mesh(world, "ep", 4)),
                       ("dp_ep", make_dp_ep_mesh(world, 4, ep=2))):
        params = shard_ep_params(full, mesh)
        rows = torch.from_numpy(place_batch(tokens, mesh))
        with torch.no_grad():
            logits, aux = ep_moe_forward(params, cfg, rows, mesh)
        out[name] = {"logits": _np(logits), "aux": float(aux), "coords": mesh.coords,
                     "expert_shape": list(params["layers"]["w_gate"].shape)}
        params = _trainable(params)
        train_rows = torch.from_numpy(place_batch(train_tokens, mesh))
        loss = ep_moe_loss(params, cfg, train_rows, mesh)
        loss.backward()
        out[name]["loss0"] = loss.item()
        out[name]["grads"] = _tree(params, grad=True)
        losses = []
        _sgd(params, lr)
        for _ in range(steps):
            loss = ep_moe_loss(params, cfg, train_rows, mesh)
            loss.backward()
            _sgd(params, lr)
            losses.append(loss.item())
        out[name]["losses"] = losses
    # the dense MoE forward of this rank's ep rows on its full weights
    mesh = make_axis_mesh(world, "ep", 4)
    with torch.no_grad():
        out["dense_rows"] = _np(moe_forward(full, cfg, torch.from_numpy(
            place_batch(tokens, mesh)))[0])
    return out


# -------------------------------------------------------------- checkpoint


def checkpoint_world(world, tree, cfg, tokens, tokens2, root) -> dict:
    """Save on dp2 x tp2 after one step, restore on the same mesh (then one
    more step from each state), save again, restore on dp1 x tp4 (then one
    step); keep=2 retention; a restore with no step. Every rank reports its
    shards of the parameters and of the optimizer's moments, and its step
    counts."""
    mesh = make_mesh(world, 4, tp=2)
    full = params_from_numpy(tree, cfg, device="cpu")
    state, opt = init_train_state(full, cfg, mesh)
    step = make_train_step(cfg, opt)
    rows, rows2 = (torch.from_numpy(place_batch(t, mesh)) for t in (tokens, tokens2))
    state, loss0 = step(state, rows)
    out = {"coords": mesh.coords, "loss0": loss0.item()}
    ckpt = TrainCheckpointer(f"{root}/ckpt")
    ckpt.save(1, state)
    out["latest"] = ckpt.latest_step()
    restored, at = ckpt.restore(cfg, mesh, opt)
    out["restored_step"] = at
    out["saved"] = _tree(state["params"])
    out["restored"] = _tree(restored["params"])
    out["moments_equal"] = all(
        torch.equal(state["opt_state"].state[p][key], restored["opt_state"].state[q][key])
        for (_, p), (_, q) in zip(named_leaves(state["params"]), named_leaves(restored["params"]))
        for key in ("exp_avg", "exp_avg_sq", "step"))
    _, l1 = step(state, rows2)
    _, l2 = step(restored, rows2)
    out["continue"] = (float(l1), float(l2))
    out["continued_equal"] = all(np.array_equal(a, b) for a, b in zip(
        _tree(state["params"]).values(), _tree(restored["params"]).values()))

    ckpt.save(5, state)
    mesh_b = make_mesh(world, 4, tp=4)
    reshard, at = ckpt.restore(cfg, mesh_b, opt)
    out["reshard_step"] = at
    out["reshard_shape"] = mesh_b.shape
    out["reshard_coords"] = mesh_b.coords
    out["resharded"] = _tree(reshard["params"])
    out["saved5"] = _tree(state["params"])
    out["saved5_opt"] = _moments(state)
    out["reshard_opt"] = _moments(reshard)
    rows_b = torch.from_numpy(place_batch(tokens2, mesh_b))
    _, lb = make_train_step(cfg, opt)(reshard, rows_b)
    out["reshard_loss"] = float(lb)
    ckpt.close()

    keep = TrainCheckpointer(f"{root}/keep", keep=2)
    for s in (1, 2, 3):
        keep.save(s, state)
    out["keep_steps"] = keep.all_steps()
    out["keep_latest"] = keep.latest_step()
    empty = TrainCheckpointer(f"{root}/none")
    try:
        empty.restore(cfg, mesh, opt)
        out["missing"] = None
    except FileNotFoundError as exc:
        out["missing"] = str(exc)
    return out
