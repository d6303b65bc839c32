"""Start the ranks of a tensor-parallel world, and what each rank runs.

The reference has no counterpart: JAX serves tensor parallelism from one
controller process. Here every rank is a process. ``launch_tp`` starts
them with the ``spawn`` start method (CUDA cannot be forked), joins them
with a deadline, kills the survivors as soon as one rank fails, and raises
that failure. ``serve_worker`` is the loop of every rank but 0: it follows
rank 0's ServingEngine step by step (serving/adapters.py). The rank entry
functions below live in this package, so a spawned rank imports
``vtpu_torch`` and nothing else of its parent.

    launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], "file:///tmp/w/store",
              args=(weights, runs, prompts, 16))

On CUDA, build the kernels in the parent first (``_build.build_all()``):
the ranks then load the libraries instead of each running nvcc.
"""

from __future__ import annotations

import multiprocessing
import queue
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from vtpu_torch.ops import _build
from vtpu_torch.parallel.mesh import make_tp_mesh
from vtpu_torch.parallel.sharding import shard_params

# how long launch_tp waits for a rank that exited to deliver its result
_GRACE_S = 2.0


def _rank_main(fn, rank: int, tp: int, backend: str, device: str, init_method: str,
               args: tuple, results) -> None:
    """A spawned rank: join the world, run ``fn(mesh, *args)``, report. A
    failure is reported before the rank leaves the group, so the parent
    hears the cause before the errors it sets off in the other ranks."""
    mesh = None
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks of a CPU world share its cores
        mesh = make_tp_mesh(tp, backend, init_method, rank, device)
        out = fn(mesh, *args)
    except Exception:  # the rank's boundary: report to the parent, then fail
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()
    results.put((rank, True, out))


def launch_tp(fn: Callable, tp: int, backend: str, devices: Sequence, init_method: str,
              args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``tp`` spawned ranks, rank r on
    ``devices[r]``, joined through ``init_method`` over ``backend``; return
    the ranks' results in rank order. ``fn`` and ``args`` must pickle (a
    module-level function). If a rank raises or dies, or the world outlasts
    ``timeout`` seconds, every rank still running is killed and
    RuntimeError names each failure (a rank's error often sets off errors
    in the others: the one that came first is the cause)."""
    if len(devices) != tp:
        raise ValueError(f"{tp} ranks need {tp} devices, got {list(devices)}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"tp-rank{r}", daemon=True,
                         args=(fn, r, tp, backend, str(devices[r]), init_method, args, results))
             for r in range(tp)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    failures: dict[int, str] = {}  # rank -> what went wrong, in the order heard
    gone: dict[int, float] = {}  # rank -> when it was first seen exited without a result
    deadline = time.monotonic() + timeout
    settle = None  # after the first failure: hear the other ranks until then
    timed_out = False
    try:
        while len(out) + len(failures) < tp:
            now = time.monotonic()
            if settle is not None and now > settle:
                break
            if now > deadline:
                timed_out = True
                break
            try:
                rank, ok, value = results.get(timeout=0.1)
            except queue.Empty:
                pass
            else:
                if ok:
                    out[rank] = value
                else:
                    failures[rank] = f"rank {rank} raised:\n{value}"
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in out or r in failures or p.exitcode is None:
                    continue
                # an exited rank's result may still be in the pipe: wait a little
                if now - gone.setdefault(r, now) > _GRACE_S:
                    failures[r] = f"rank {r} exited with code {p.exitcode} and no result"
            if failures and settle is None:
                settle = now + _GRACE_S
    finally:
        failed = bool(failures) or timed_out or len(out) < tp
        for p in procs:
            if failed and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    if failed:
        codes = ", ".join(f"rank {r}: {p.exitcode}" for r, p in enumerate(procs))
        why = list(failures.values()) + (
            [f"the tp={tp} world did not finish within {timeout:.0f} s"] if timed_out else [])
        raise RuntimeError(f"tensor-parallel world failed ({codes}): " + "\n".join(why))
    return [out[r] for r in range(tp)]


def serve_worker(params, cfg, serving, mesh):
    """The loop of every rank but 0: build the same adapter as rank 0's
    ServingEngine (``params`` this rank's shard, the same ModelConfig and
    ServingConfig) and run rank 0's calls on this rank's shard until
    rank 0's ``stop()``. Returns the rank's final state."""
    from vtpu_torch.serving.adapters import TransformerSlotModel

    model = TransformerSlotModel(params, cfg, kv_page=serving.kv_page,
                                 kv_pool_blocks=serving.kv_pool_blocks,
                                 paged_attn=serving.paged_attn, mesh=mesh)
    state, running = None, True
    while running:
        running, state = model.follow(state)
    return state


def _load_weights(weights, cfg, mesh):
    """This rank's shard of ``weights``: a seed for init_params (every rank
    draws the same full weights and keeps its slices) or a numpy tree (only
    this rank's slices are carried over)."""
    from vtpu_torch.convert import params_from_numpy
    from vtpu_torch.models import init_params

    if isinstance(weights, int):
        return shard_params(init_params(weights, cfg, device=mesh.device), mesh)
    return params_from_numpy(weights, cfg, device=mesh.device, mesh=mesh)


def _serve_wave(mesh, params, cfg, serving, prompts: Sequence, new_tokens: int) -> dict:
    """One engine's life on every rank: rank 0 serves ``prompts``, all
    submitted at once, and stops the workers; the others follow it. Every
    rank's dict holds the shape of its KV plane ``kv_shape``; rank 0's adds
    ``streams``, ``statuses``, ``stats`` and ``wall_s``."""
    from vtpu_torch.serving import ServingEngine

    if mesh.rank != 0:
        state = serve_worker(params, cfg, serving, mesh)
        return {"kv_shape": list(state["k"].shape)}
    eng = ServingEngine(params, cfg, serving, mesh=mesh)
    eng.start()
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        streams = [list(r.stream()) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise RuntimeError(f"rank 0's serving loop failed: {eng.loop_error!r}")
    return {"kv_shape": list(eng.state["k"].shape), "streams": streams,
            "statuses": [r.status for r in reqs], "stats": eng.stats(), "wall_s": wall}


def serve_requests(mesh, weights, runs: Sequence, prompts: Sequence, new_tokens: int,
                   warmup: bool = False) -> list[dict]:
    """Rank entry: serve ``prompts`` once per ``(ModelConfig,
    ServingConfig)`` of ``runs``, ``new_tokens`` each, all submitted at
    once. Rank 0 drives a ServingEngine; the other ranks run serve_worker.
    With ``warmup`` one prompt is served first by an engine of its own, so
    the counted wave's engine, stats and launch counts see none of it.
    Launch counts are set to 0 on every rank just before the counted
    wave's engine is built and read just after it stops.

    Returns one dict per run. Every rank's holds ``launches`` and the
    shape of its KV plane ``kv_shape``; rank 0's adds ``streams``,
    ``statuses``, ``stats`` and ``wall_s`` (the counted wave)."""
    done = []
    for cfg, serving in runs:
        params = _load_weights(weights, cfg, mesh)
        if warmup:
            _serve_wave(mesh, params, cfg, serving, prompts[:1], new_tokens)
        _build.reset_launches()
        res = _serve_wave(mesh, params, cfg, serving, prompts, new_tokens)
        res["launches"] = _build.launches()
        done.append(res)
    return done


def forced_decode_logits(mesh, weights, cfg, kv_page, prompt: Sequence[int],
                         forced: Sequence[int]) -> list:
    """Rank entry: teacher-forced decode through the adapter, as a parity
    check between layouts. Slot 0 of two is prefilled with ``prompt``
    (paged: mapped to blocks 1, 2, ...), then each token of ``forced`` is
    decoded with slot 1 inactive. Rank 0 returns the per-step logits of
    slot 0 (lists of floats); the other ranks follow and return None."""
    from vtpu_torch.serving import ServingConfig
    from vtpu_torch.serving.adapters import TransformerSlotModel

    params = _load_weights(weights, cfg, mesh)
    if mesh.rank != 0:
        serve_worker(params, cfg, ServingConfig(kv_page=kv_page), mesh)
        return None
    model = TransformerSlotModel(params, cfg, kv_page=kv_page, mesh=mesh)
    dev = model.device
    try:
        state = model.init_state(2)
        if kv_page is not None:
            # the engine's reservation, written directly as the engine does
            state["table"][0] = torch.arange(1, state["table"].shape[1] + 1, device=dev)
        unit = kv_page or 8
        bucket = -(-len(prompt) // unit) * unit
        padded = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        padded[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        _, state = model.prefill_into_slot(model.params, state, padded, 0, len(prompt))
        active = torch.tensor([True, False], device=dev)
        out = []
        for tok in forced:
            tokens = torch.tensor([tok, 0], dtype=torch.int32, device=dev)
            logits, state = model.decode_step(model.params, state, tokens, active, 0)
            out.append(logits[0].float().cpu().tolist())
    finally:
        model.stop_workers()
    return out
