"""Start the ranks of a world, and what each serving rank runs.

The reference has no counterpart: JAX runs every mesh from one controller
process. Here every rank is a process. ``launch`` starts them with the
``spawn`` start method (CUDA cannot be forked), hands each its ``World``
(mesh.py; the rank builds its meshes from it), joins them with a deadline,
kills the survivors as soon as one rank fails, and raises that failure.
``launch_tp`` is the same for a serving world: each rank gets its
``TpMesh``, the world's one axis. ``serve_worker`` is the loop of every
rank but 0: it follows rank 0's ServingEngine op by op
(serving/adapters.py). The rank entry functions below live in this
package, so a spawned rank imports ``vtpu_torch`` and nothing else of its
parent. ``serve_requests`` serves ``Run`` waves of the dense or the MoE
family (by the config's type); a ``Script`` has rank 0 act within a wave
(a prefix, parks and resumes, a fault armed, or with ``Moves`` a migration
round between several engines of the world, each tensor-parallel one on a
process group of its own and followed on every other rank by a thread of
its own; the round's runner is loaded by import path, as a rank hook is).

    launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], "file:///tmp/w/store",
              args=([weights], [Run(cfg, serving, prompts, 16)]))

On CUDA, build the kernels in the parent first (``_build.build_all()``):
the ranks then load the libraries instead of each running nvcc.
"""

from __future__ import annotations

import dataclasses
import importlib
import multiprocessing
import queue
import threading
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from vtpu_torch.ops import _build
from vtpu_torch.parallel.mesh import join_world, own_group, whole_world_axis
from vtpu_torch.parallel.sharding import shard_moe_params, shard_params

# how long launch_tp waits for a rank that exited to deliver its result
_GRACE_S = 2.0


def _rank_main(fn, rank: int, n: int, backend: str, device: str, init_method: str,
               args: tuple, results) -> None:
    """A spawned rank: join the world, run ``fn`` on its World, report. A
    failure is reported before the rank leaves the group, so the parent
    hears the cause before the errors it sets off in the other ranks."""
    world = None
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks of a CPU world share its cores
        world = join_world(n, backend, init_method, rank, device)
        out = fn(world, *args)
    except Exception:  # the rank's boundary: report to the parent, then fail
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if world is not None:
            world.close()
    results.put((rank, True, out))


def launch(fn: Callable, n: int, backend: str, devices: Sequence, init_method: str,
           args: tuple = (), timeout: float = 600.0, name: str = "rank") -> list:
    """Run ``fn(world, *args)`` on ``n`` spawned ranks (processes named
    ``name`` and the rank), rank r on ``devices[r]``, joined through
    ``init_method`` over ``backend``; return the ranks' results in rank
    order. ``fn`` and ``args`` must pickle (a module-level function). If a
    rank raises or dies, or the world outlasts ``timeout`` seconds, every
    rank still running is killed and RuntimeError names each failure (a
    rank's error often sets off errors in the others: the one that came
    first is the cause)."""
    if len(devices) != n:
        raise ValueError(f"{n} ranks need {n} devices, got {list(devices)}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"{name}{r}", daemon=True,
                         args=(fn, r, n, backend, str(devices[r]), init_method, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    failures: dict[int, str] = {}  # rank -> what went wrong, in the order heard
    gone: dict[int, float] = {}  # rank -> when it was first seen exited without a result
    deadline = time.monotonic() + timeout
    settle = None  # after the first failure: hear the other ranks until then
    timed_out = False
    try:
        while len(out) + len(failures) < n:
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
        failed = bool(failures) or timed_out or len(out) < n
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
            [f"the {n}-rank world did not finish within {timeout:.0f} s"] if timed_out else [])
        raise RuntimeError(f"{n}-rank world failed ({codes}): " + "\n".join(why))
    return [out[r] for r in range(n)]


def _tp_rank(world, fn: Callable, *args):
    """launch_tp's rank entry: ``fn`` on the world's one axis."""
    return fn(whole_world_axis(world), *args)


def launch_tp(fn: Callable, tp: int, backend: str, devices: Sequence, init_method: str,
              args: tuple = (), timeout: float = 600.0) -> list:
    """``launch`` of a tensor-parallel serving world: ``fn(mesh, *args)``
    with each rank's TpMesh."""
    return launch(_tp_rank, tp, backend, devices, init_method, (fn, *args), timeout,
                  name="tp-rank")


@dataclasses.dataclass(frozen=True)
class Moves:
    """A migration round (``Script.moves``), picklable. Rank 0 builds one
    engine a name of ``engines``, each on the Run's ServingConfig with its
    overrides (a dict of fields: a pool size, a FaultPlan), serving the
    Run's config on the Run's weights: every engine not named in
    ``one_device`` under the mesh on a process group of its own
    (``own_group``, in this order on every rank), each named one on rank
    0's device with the whole weights. Rank 0's client thread then calls
    ``runner`` ("module:function", imported there, as ``Run.hook`` is)
    with {name: engine} and the Run; the runner reads ``steps`` and
    ``fleet`` (the names it serves through one EngineFleet), builds and
    stops whatever it adds, and returns the round's results."""

    runner: str
    engines: tuple = (("src", {}), ("dst", {}))
    steps: tuple = ()
    one_device: tuple = ()
    fleet: tuple = ()


@dataclasses.dataclass(frozen=True)
class Script:
    """What rank 0 does within a wave besides submitting its prompts: a
    picklable description (``Run.script``).

    prefix       tokens registered with ``register_prefix`` before
                 ``start()``; the first ``prefixed`` prompts (all with
                 None) are submitted as its suffixes, the rest as they are
    drop_prefix  ``unregister_prefix`` once every stream has ended
    park_after   > 0: the overcommit round. The first half of the prompts
                 is submitted, and each session parked inside the delivery
                 of its park_after-th token; once all are parked the second
                 half likewise; then the first half resumes and streams to
                 its end, then the second
    arm          (prompt index, token count, seam): the ServingConfig's
                 FaultPlan arms ``seam`` inside the delivery of that
                 prompt's token-count-th token
    moves        a migration round (``Moves``) in place of the wave: the
                 prompts are its sessions"""

    prefix: Optional[tuple] = None
    prefixed: Optional[int] = None
    drop_prefix: bool = False
    park_after: int = 0
    arm: Optional[tuple] = None
    moves: Optional[Moves] = None


@dataclasses.dataclass(frozen=True)
class Run:
    """One counted wave of ``serve_requests``, picklable.

    cfg          a ModelConfig or a MoEConfig: the family the ranks serve
    serving      the ServingConfig of rank 0's engine and every adapter
    prompts      the wave's prompts, each a token sequence
    new_tokens   every request's budget
    sample       a picklable custom sampler for rank 0's engine, or None
    submit       one dict of ``submit`` keywords a prompt (priority,
                 deadline_ms), or None; with it every prompt is queued
                 before the loop starts, so the first tick head sees all
    script       rank 0's actions within the wave (``Script``)
    hook         "module:function" or None: imported on every rank and
                 called with that rank's adapter before the wave; it
                 returns a function of the rank's final state whose dict
                 joins the rank's result (a check's instrumentation)"""

    cfg: Any
    serving: Any
    prompts: Sequence
    new_tokens: int
    sample: Optional[Callable] = None
    submit: Optional[Sequence[dict]] = None
    script: Script = Script()
    hook: Optional[str] = None


def _adapter(params, cfg, serving, mesh, device=None):
    """The slot adapter of ``cfg``'s family on this rank's shard (with no
    mesh, the whole ``params`` on ``device``): the MoE for a MoEConfig,
    else the dense transformer. The dense family's ``kv_int8="auto"`` is
    resolved here, on every rank from the same (slots, max_seq), as the
    reference's ``ServingEngine(params, cfg, mesh=)`` resolves it; the MoE
    reads it as int8, as the reference's ``model=`` adapter does."""
    from vtpu_torch.models.moe import MoEConfig
    from vtpu_torch.serving.adapters import MoeSlotModel, TransformerSlotModel
    from vtpu_torch.serving.engine import resolve_kv_int8

    if isinstance(cfg, MoEConfig):
        cls = MoeSlotModel
    else:
        cls, cfg = TransformerSlotModel, resolve_kv_int8(cfg, serving)
    return cls(params, cfg, kv_page=serving.kv_page, kv_pool_blocks=serving.kv_pool_blocks,
               paged_attn=serving.paged_attn, device=device, mesh=mesh)


def _by_path(path: str) -> Callable:
    """The function a "module:function" path names."""
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def _hook(path: Optional[str], model) -> Callable[[dict], dict]:
    """``Run.hook`` installed on ``model``: the function of the final state
    it returns (with None, one that adds nothing)."""
    if path is None:
        return lambda state: {}
    return _by_path(path)(model)


def _follow_engines(params, cfg, workers: dict, hook: Optional[str]) -> dict:
    """A non-zero rank's side of a migration round: one ``serve_worker``
    thread an engine of ``workers`` ({name: (ServingConfig, its mesh on a
    group of its own)}), joined. A thread that raises fails the rank at
    once with its traceback (launch then stops the world), so rank 0 never
    waits on a broadcast nobody follows. Returns {name: serve_worker's
    result}."""
    out: dict = {}
    failed: list = []

    def follow(name, serving, mesh):
        try:
            out[name] = serve_worker(params, cfg, serving, mesh, hook)
        except BaseException:  # the thread's boundary: the rank's main thread raises it
            failed.append(f"the follower of engine {name!r} raised:\n"
                          + traceback.format_exc())

    threads = [threading.Thread(target=follow, args=(name, serving, mesh),
                                name=f"follow-{name}", daemon=True)
               for name, (serving, mesh) in workers.items()]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads) and not failed:
        for t in threads:
            t.join(timeout=0.05)
    if failed:
        raise RuntimeError(failed[0])
    return out


def serve_worker(params, cfg, serving, mesh, hook: Optional[str] = None):
    """The loop of every rank but 0: build the same adapter as rank 0's
    ServingEngine (``params`` this rank's shard, the same config and
    ServingConfig) and run rank 0's calls on this rank's shard until
    rank 0's ``stop()``. Returns (the rank's final state, what ``hook``'s
    function of it adds)."""
    model = _adapter(params, cfg, serving, mesh)
    done = _hook(hook, model)
    state, running = None, True
    while running:
        running, state = model.follow(state)
    return state, done(state)


def _load_weights(weights, cfg, mesh, whole: bool = False):
    """This rank's shard of ``weights`` for ``cfg``'s family: a seed for
    the family's init (every rank draws the same full weights and keeps its
    slices) or a numpy tree (only this rank's slices are carried over).
    With ``whole``, all of them, on the rank's device."""
    from vtpu_torch.convert import moe_params_from_numpy, params_from_numpy
    from vtpu_torch.models import init_params
    from vtpu_torch.models.moe import MoEConfig, init_moe_params

    moe = isinstance(cfg, MoEConfig)
    if isinstance(weights, int):
        full = (init_moe_params if moe else init_params)(weights, cfg, device=mesh.device)
        if whole:
            return full
        return shard_moe_params(full, mesh) if moe else shard_params(full, mesh)
    convert = moe_params_from_numpy if moe else params_from_numpy
    return convert(weights, cfg, device=mesh.device, mesh=None if whole else mesh)


def _on_token(req, n: int, action) -> None:
    """Run ``action()`` on the loop thread right after ``req``'s n-th token
    is put on its stream (inside that delivery), once."""
    from vtpu_torch.serving import Terminal

    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if not isinstance(item, Terminal):
            seen[0] += 1
            if seen[0] == n:
                req.out.put = put
                action()

    req.out.put = hook


def _wait(cond, what: str, timeout: float = 300.0) -> None:
    """Wait for a state the loop thread reaches on its own; the bound only
    turns a hang into a failure."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"{what} never happened")
        time.sleep(0.002)


def _move_wave(mesh, params, weights, run: Run) -> dict:
    """``Script.moves``' round on every rank: every rank builds each
    tensor-parallel engine's group in the same order; rank 0 builds the
    engines and runs the round's runner on a client thread of its own
    (this one), the other ranks follow each engine on a thread of its own.
    Rank 0's dict is the runner's result with ``kv_shape``, its seconds
    (``groups_s`` the groups, ``build_s`` the engines and weights,
    ``wall_s`` the runner, ``stop_s`` the engines' stops) and, per
    tensor-parallel engine, what the run's hook adds under ``hooks``; a
    follower's holds ``kv_shape`` and ``hooks``."""
    from vtpu_torch.serving import ServingEngine

    moves = run.script.moves
    t0 = time.perf_counter()
    servings = {name: dataclasses.replace(run.serving, **dict(over))
                for name, over in moves.engines}
    meshes = {name: own_group(mesh) for name in servings if name not in moves.one_device}
    if mesh.rank != 0:
        followed = _follow_engines(params, run.cfg, {n: (servings[n], meshes[n])
                                                     for n in meshes}, run.hook)
        return {"kv_shape": list(followed[next(iter(meshes))][0]["k"].shape),
                "hooks": {name: extra for name, (_, extra) in followed.items()}}
    runner = _by_path(moves.runner)
    grouped = time.perf_counter()
    whole = _load_weights(weights, run.cfg, mesh, whole=True) if moves.one_device else None
    engines, done = {}, {}
    try:
        for name, serving in servings.items():
            if name in meshes:
                model = _adapter(params, run.cfg, serving, meshes[name])
                done[name] = _hook(run.hook, model)
            else:
                model = _adapter(whole, run.cfg, serving, None, device=mesh.device)
            engines[name] = ServingEngine(serving=serving, model=model, sample=run.sample)
        # the round's counts start here: a one-device engine's graph
        # capture ran its step once, eagerly, before recording it
        _build.reset_launches()
        built = time.perf_counter()
        out = runner(engines, run)
        ran = time.perf_counter()
    finally:
        for eng in engines.values():
            eng.stop()
    for name, eng in engines.items():
        if eng.loop_error is not None:
            raise RuntimeError(f"engine {name}'s serving loop failed: {eng.loop_error!r}")
    out.update(groups_s=grouped - t0, build_s=built - grouped, wall_s=ran - built,
               stop_s=time.perf_counter() - ran)
    out["hooks"] = {name: fn(engines[name].state) for name, fn in done.items()}
    out["kv_shape"] = list(engines[next(iter(meshes))].state["k"].shape)
    return out


def _overcommit_round(eng, prompts: Sequence, new_tokens: int, park_after: int) -> list:
    """Script.park_after's round; returns the requests in prompt order."""
    half = len(prompts) // 2
    groups = [list(prompts[:half]), list(prompts[half:])]
    reqs: list = []
    for group in groups:
        batch = [eng.submit(p, max_new_tokens=new_tokens) for p in group]
        for req in batch:
            _on_token(req, park_after, lambda req=req: eng.park(req))
        _wait(lambda: all(r in eng._parked or r.status is not None for r in batch),
              "the parks")
        reqs += batch
    for part in (reqs[:half], reqs[half:]):
        for req in part:
            eng.resume(req)
        _wait(lambda: all(r.status is not None for r in part), "the resumed streams' ends")
    return reqs


def _serve_wave(mesh, params, run: Run, weights=None) -> dict:
    """One engine's life on every rank: rank 0 serves ``run``'s prompts,
    all submitted at once (or as its script says), and stops the workers;
    the others follow it. Every rank's dict holds the shape of its KV
    plane ``kv_shape`` and what the run's hook adds; rank 0's adds
    ``streams``, ``logprobs``, ``statuses``, ``stats``, ``signals``,
    ``wall_s`` and, with a prefix on a paged pool, its ``prefix_blocks``."""
    from vtpu_torch.serving import ServingEngine

    if run.script.moves is not None:
        return _move_wave(mesh, params, weights, run)
    if mesh.rank != 0:
        state, extra = serve_worker(params, run.cfg, run.serving, mesh, run.hook)
        return {"kv_shape": list(state["k"].shape), **extra}
    model = _adapter(params, run.cfg, run.serving, mesh)
    done = _hook(run.hook, model)
    eng = ServingEngine(serving=run.serving, model=model, sample=run.sample)
    script, prompts, new = run.script, list(run.prompts), run.new_tokens
    out: dict = {}
    try:
        t0 = time.perf_counter()
        kws = ([dict(kw) for kw in run.submit] if run.submit is not None
               else [{} for _ in prompts])
        if script.prefix is not None:
            pid = eng.register_prefix(list(script.prefix))
            if eng._paged:
                out["prefix_blocks"] = list(eng._prefixes[pid]["blocks"])
            n = len(prompts) if script.prefixed is None else script.prefixed
            for kw in kws[:n]:
                kw["prefix"] = pid
        if script.park_after:
            eng.start()
            reqs = _overcommit_round(eng, prompts, new, script.park_after)
        elif run.submit is not None or script.prefix is not None or script.arm is not None:
            reqs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in zip(prompts, kws)]
            if script.arm is not None:
                i, n, seam = script.arm
                _on_token(reqs[i], n, lambda: run.serving.faults.arm(seam))
            eng.start()
        else:
            eng.start()
            reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        streams = [list(r.stream()) for r in reqs]
        wall = time.perf_counter() - t0
        if script.prefix is not None and script.drop_prefix:
            eng.unregister_prefix(pid)
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise RuntimeError(f"rank 0's serving loop failed: {eng.loop_error!r}")
    out.update({"kv_shape": list(eng.state["k"].shape), **done(eng.state)})
    out.update({"streams": streams, "logprobs": [list(r.logprobs) for r in reqs],
                "statuses": [r.status for r in reqs], "stats": eng.stats(),
                "signals": eng.signals().to_dict(), "wall_s": wall})
    return out


def serve_requests(mesh, weights: Sequence, runs: Sequence[Run],
                   warmup: bool = False) -> list[dict]:
    """Rank entry: serve each ``Run`` of ``runs`` in turn, run i on the
    weights ``weights[i]`` (a seed for the family's init or a numpy tree;
    a run on the same weights object and config as the one before reuses
    its shard). Rank 0 drives a ServingEngine; the other ranks run
    serve_worker. With ``warmup`` each run's first prompt is served first
    by an engine of its own, without the run's fault plan, script or hook,
    so the counted wave's engine, stats and launch counts see none of it
    (not before a migration round, whose counts start once its engines are
    built).
    Launch counts are set to 0 on every rank just before the counted
    wave's engine is built (on rank 0 again once a migration round's
    engines are built) and read just after it stops.

    Returns one dict per run. Every rank's holds ``launches``, the shape
    of its KV plane ``kv_shape`` and what the run's hook adds; rank 0's
    adds ``streams``, ``logprobs``, ``statuses``, ``stats`` and ``wall_s``
    (the counted wave). Every rank's ``run_s`` is the run's seconds on that
    rank, a weights load and the warm-up included."""
    if len(weights) != len(runs):
        raise ValueError(f"{len(runs)} runs need {len(runs)} weights, got {len(weights)}")
    done, last, params = [], None, None
    for w, run in zip(weights, runs):
        t0 = time.perf_counter()
        if last is None or last[0] is not w or last[1] != run.cfg:
            params = _load_weights(w, run.cfg, mesh)
            last = (w, run.cfg)
        if warmup and run.script.moves is None:
            _serve_wave(mesh, params, dataclasses.replace(
                run, serving=dataclasses.replace(run.serving, faults=None),
                prompts=list(run.prompts)[:1], submit=None, script=Script(), hook=None))
        _build.reset_launches()
        res = _serve_wave(mesh, params, run, w)
        res["launches"] = _build.launches()
        res["run_s"] = time.perf_counter() - t0
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

    params = _load_weights(weights, cfg, mesh)
    if mesh.rank != 0:
        serve_worker(params, cfg, ServingConfig(kv_page=kv_page), mesh)
        return None
    model = _adapter(params, cfg, ServingConfig(kv_page=kv_page), mesh)
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
