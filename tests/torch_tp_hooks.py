"""Rank hooks of the tensor-parallel CPU tests (``Run.hook``, by module
path, so a spawned rank imports this module and no jax): each is called on
every rank with its adapter before the wave and returns a function of the
rank's final state whose dict joins the rank's result."""

import torch

from vtpu_torch.serving.adapters import _OP_SWAP_IN, _OP_SWAP_OUT

PLANES = ("k", "v", "k_scale", "v_scale")


def swap_watch(model):
    """Every block this rank swaps in, held byte for byte against a copy of
    what left its pool at the swap-out to the same host block (taken on the
    stream before the gather): ``swap_checked``, ``swap_differ``. Rank 0
    wraps its adapter's swap calls, a follower its run of the swap ops;
    the null block 0 of the construction's staging pair is skipped."""
    counts = {"swap_checked": 0, "swap_differ": 0}
    saved: dict = {}

    def out(state, blocks, host):
        for b, h in zip(blocks, host):
            if b:
                saved[h] = {k: state[k][:, b].clone() for k in PLANES if k in state}

    def back(state, blocks, host):
        for b, h in zip(blocks, host):
            if b:
                same = all(torch.equal(state[k][:, b], x) for k, x in saved.pop(h).items())
                counts["swap_checked"] += 1
                counts["swap_differ"] += 0 if same else 1

    if model.mesh.rank == 0:
        swap_out, swap_in = model.swap_out, model.swap_in

        def watched_out(state, blocks, host, stage):
            out(state, blocks, host)
            return swap_out(state, blocks, host, stage)

        def watched_in(state, blocks, host, stage):
            state = swap_in(state, blocks, host, stage)
            back(state, blocks, host)
            return state

        model.swap_out, model.swap_in = watched_out, watched_in
    else:
        run = model._run

        def watched_run(op, dims, args, state):
            if op == _OP_SWAP_OUT:
                out(state, args[0].tolist(), args[1].tolist())
            state = run(op, dims, args, state)
            if op == _OP_SWAP_IN:
                back(state, args[0].tolist(), args[1].tolist())
            return state

        model._run = watched_run
    return lambda state: dict(counts)


def kv_state(model):
    """The rank's KV planes as float numpy (``pool``) and the keys of the
    dense prefixes it still holds (``prefix_keys``), after the wave."""
    return lambda state: {
        "pool": {k: x.float().cpu().numpy() for k, x in state.items() if k in PLANES},
        "prefix_keys": sorted(model._prefixes)}
