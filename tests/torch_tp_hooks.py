"""Rank hooks of the tensor-parallel CPU tests (``Run.hook``, by module
path, so a spawned rank imports this module and no jax): each is called on
every rank with its adapter before the wave and returns a function of the
rank's final state whose dict joins the rank's result."""

import torch

from vtpu_torch.serving.adapters import (
    _OP_SNAPSHOT, _OP_SWAP_IN, _OP_SWAP_OUT, _OP_UPLOAD,
)

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


def kv_dtype(model):
    """The rank's resolved ``kv_int8`` and the dtype of its KV plane, after
    the wave (``kv_int8``, ``kv_dtype``)."""
    return lambda state: {"kv_int8": model.cfg.kv_int8, "kv_dtype": str(state["k"].dtype)}


def tier_watch(model):
    """This rank's host tier across a migration round: every block a
    swap-out or a tier upload fills is held until a swap-in or a snapshot
    reads it back (``tier_held``, the blocks still held after the round:
    [] when the tier is free), and around every snapshot and upload op the
    whole tier is compared byte for byte: a snapshot writes no block, an
    upload only its own tier blocks (``tier_foreign``, blocks written
    otherwise, over ``tier_ops`` ops). Rank 0 wraps its adapter's calls, a
    follower its run of the ops."""
    held: set = set()
    counts = {"tier_ops": 0, "tier_foreign": 0}

    def copy():
        return {k: x.clone() for k, x in model._host_pool.items()}

    def written(prev) -> set:
        now = model._host_pool
        blocks = len(next(iter(now.values()))) if now else 0  # kv_swap=0: no tier
        return {h for h in range(blocks)
                if any(not torch.equal(prev[k][h].view(torch.uint8), x[h].view(torch.uint8))
                       for k, x in now.items())}

    def watched(op, ids, tier, call):
        """``call()`` under watch; ``ids`` the op's host-tier blocks."""
        if op == _OP_SWAP_OUT or (op == _OP_UPLOAD and tier):
            held.update(ids)
        elif op in (_OP_SWAP_IN, _OP_SNAPSHOT):
            held.difference_update(ids)
        if op not in (_OP_SNAPSHOT, _OP_UPLOAD):
            return call()
        prev = copy()
        out = call()
        counts["tier_ops"] += 1
        counts["tier_foreign"] += len(written(prev) - (set(ids) if tier else set()))
        return out

    if model.mesh.rank == 0:
        swap_out, swap_in = model.swap_out, model.swap_in
        snapshot, upload = model.snapshot, model.upload
        model.swap_out = lambda state, blocks, host, stage: watched(
            _OP_SWAP_OUT, host, False, lambda: swap_out(state, blocks, host, stage))
        model.swap_in = lambda state, blocks, host, stage: watched(
            _OP_SWAP_IN, host, False, lambda: swap_in(state, blocks, host, stage))
        model.snapshot = lambda state, blocks, host, stage: watched(
            _OP_SNAPSHOT, host, False, lambda: snapshot(state, blocks, host, stage))
        model.upload = lambda state, payload, ids, stage, tier=False: watched(
            _OP_UPLOAD, ids if tier else [], tier,
            lambda: upload(state, payload, ids, stage, tier))
    else:
        run = model._run

        def watched_run(op, dims, args, state):
            if op in (_OP_SWAP_OUT, _OP_SWAP_IN, _OP_SNAPSHOT):
                ids, tier = args[1].tolist(), False
            elif op == _OP_UPLOAD:
                tier = bool(dims[2])
                ids = args[0].tolist() if tier else []
            else:
                return run(op, dims, args, state)
            return watched(op, ids, tier, lambda: run(op, dims, args, state))

        model._run = watched_run
    return lambda state: {"tier_held": sorted(held), **counts}


def fail_follower(model):
    """A rank hook that fails every follower before it follows: a world's
    check that a follower thread's error fails its rank."""
    if model.mesh.rank != 0:
        raise RuntimeError("no follower here")
    return lambda state: {}
