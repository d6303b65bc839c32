"""The port's failure domains against vtpu's on the same weights (CPU, f32),
in the reference's configuration (tests/test_faults.py): typed terminals,
deadlines and overload shedding, crash containment, the fault seams of the
pool and the host tier, the fetch watchdog's ladder, the shed policies'
signals and the duty supplier, the FaultPlan schedule, engine death, and
the prefill workers of a disaggregated engine: worker death (re-queue with
backoff, bounded retries, restart) and cancels racing a worker's claim.

Held: every stream a fault or shed does not touch equals the JAX engine's
fault-free stream on the same prompt, up to the first step whose top-1/top-2
margin is under 1e-4; the typed terminals and the counters equal what the
JAX engine reports under the same plan (the watchdog's rung-1 flush is a
one-token flush in the port and a capped k-token flush in the reference,
so decode_ticks is not among them).

No verdict races the loop thread: shed bursts are queued before
``start()``; a deadline is rewound, a cancel or an engine death armed, from
inside the delivery of a chosen token (a hook on the request's queue); the
watchdog is driven by ``delayed_fetch`` stalls of 0.75 s against a 500 ms
threshold, far above a healthy fetch of these models, and a recovery window
of 1 ms that a few healthy fetches cover; where a case compares the ticks
each route served, a planned 20 ms fetch ends the recovery streak, so the
recovery lands on the same fetch on both engines. A waiting loop only
guards against a hang. One torch thread."""

import queue as _queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import decode_step as j_decode_step, prefill as j_prefill
from vtpu.serving import (
    DisaggConfig as JDisaggConfig, FaultPlan as JFaultPlan, FaultSpec as JFaultSpec,
    ServingConfig as JServingConfig, ServingEngine as JServingEngine,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel import TpMesh, shard_params
from vtpu_torch.parallel.launch import Run, launch_tp, serve_requests
from vtpu_torch.serving import (
    DisaggConfig, EngineSignals, FaultPlan, FaultSpec, PriorityDeadlineShedPolicy, Request,
    ServingConfig, ServingEngine, ShedPolicy, Status, Terminal, accepts_signals,
    load_shed_policy,
)

DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=64, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
MARGIN = 1e-4
# the watchdog: a threshold far above a healthy fetch here, stalls 1.5x it
WATCHDOG_MS = 500.0
STALL_S = 0.75
RECOVER_MS = 1.0
# a healthy fetch held this long (20x RECOVER_MS, 1/25 of the threshold):
# planned on the fetch after a recovery streak starts, it ends the streak
# at that fetch on both engines whatever the host's load
STREAK_S = 0.02
# the loops the port serves on one device
LOOPS = {"pipelined": {}, "sync": dict(pipeline_decode=False), "host_sampler": {},
         "device_loop": dict(decode_loop_k=4), "spec": dict(spec_tokens=2),
         "fused": dict(decode_loop_k=4, spec_tokens=2)}
# the failure-domain counters held against the JAX engine's
KEYS = ("shed_deadline", "shed_overload", "faulted_requests", "faults_injected",
        "watchdog_degrades", "watchdog_recoveries", "generated_tokens")
WORLD_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, tree, params_from_numpy(tree, CFG, device="cpu")


_REFS: dict = {}


def _ref(weights, prompt, steps):
    """The JAX engine's fault-free greedy stream of ``prompt`` (served
    alone) and each step's top-1/top-2 logit margin from the JAX trunk."""
    key = (prompt.tobytes(), steps)
    if key not in _REFS:
        jp = weights[0]
        eng = JServingEngine(jp, JCFG, JServingConfig(slots=2, prefill_buckets=(16,),
                                                      max_new_tokens=steps))
        eng.start()
        try:
            stream = list(eng.submit(prompt, max_new_tokens=steps).stream())
        finally:
            eng.stop()
        logits, cache = j_prefill(jp, JCFG, jnp.asarray(prompt[None]))
        row = np.asarray(logits)[0, -1]
        margins = []
        for tok in stream:
            top2 = np.sort(row)[-2:]
            margins.append(float(top2[1] - top2[0]))
            logits, cache = j_decode_step(jp, JCFG, cache, jnp.asarray([tok], jnp.int32))
            row = np.asarray(logits)[0]
        _REFS[key] = (stream, margins)
    return _REFS[key]


def _agree(got, ref, n=None):
    """``got`` equals the reference stream (its first ``n`` tokens, all by
    default) up to its first step whose margin is under MARGIN; returns the
    tokens compared."""
    want, margins = ref
    if n is not None:
        want, margins = want[:n], margins[:n]
    assert len(got) == len(want), (got, want)
    compared = 0
    for a, b, m in zip(got, want, margins):
        if m < MARGIN:
            break
        assert a == b, (got, want)
        compared += 1
    return compared


def _argmax(row):
    return int(np.argmax(row))


def _serving(cls=ServingConfig, **kw):
    base = dict(slots=2, prefill_buckets=(16,), max_new_tokens=6)
    base.update(kw)
    return cls(**base)


def _plan(side, *specs):
    """A FaultPlan of ``specs`` ((seam, at, count, arg) tuples) for one
    side's engine, or None without specs."""
    if not specs:
        return None
    plan, spec = (JFaultPlan, JFaultSpec) if side == "jax" else (FaultPlan, FaultSpec)
    return plan([spec(*s) for s in specs])


def _engine(weights, side, loop=None, specs=(), sample=None, **kw):
    """A JAX or port engine with ``_serving(**LOOPS[loop], **kw)`` and the
    plan of ``specs`` (or the ``faults`` given)."""
    kw = {**LOOPS.get(loop or "pipelined", {}), **kw}
    if loop == "host_sampler":
        sample = _argmax
    plan = kw.pop("faults", None) or _plan(side, *specs)
    if side == "jax":
        return JServingEngine(weights[0], JCFG, _serving(JServingConfig, faults=plan, **kw),
                              sample=sample)
    return ServingEngine(weights[2], CFG, _serving(faults=plan, **kw), device="cpu",
                         sample=sample)


def _both(weights, fn, loop=None, specs=(), **kw):
    """Run ``fn(engine)`` on the JAX engine and on the port's, each built
    from the same config and plan; returns {"jax": ..., "port": ...}. Each
    engine stops, whatever ``fn`` does."""
    out = {}
    for side in ("jax", "port"):
        eng = _engine(weights, side, loop, specs, **kw)
        try:
            out[side] = fn(eng)
        finally:
            eng.stop()
    return out


def _stats(eng, extra=()):
    st = eng.stats()
    return {k: st[k] for k in KEYS + tuple(extra)}


def _on_token(req, n, action):
    """Run ``action()`` on the loop thread right after ``req``'s n-th token
    is put on its stream (inside that delivery)."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if isinstance(item, (int, np.integer)):
            seen[0] += 1
            if seen[0] == n:
                action()

    req.out.put = hook


def _wait(cond, what, timeout=60.0):
    """A hang guard, never a verdict: poll ``cond`` until it holds."""
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, f"{what} did not happen within {timeout} s"
        time.sleep(0.002)


# ------------------------------------------------------- typed terminals


def test_terminal_status_ok_and_cancelled(weights):
    """Every stream ends with one typed terminal: a clean run OK, a cancel
    (asked inside the delivery of its first token) CANCELLED."""
    ok_p, victim_p = _prompt(1, 5), _prompt(2, 5)

    def run(eng):
        ok = eng.submit(ok_p, max_new_tokens=4)
        victim = eng.submit(victim_p, max_new_tokens=48)
        _on_token(victim, 1, lambda: (victim.cancel(), victim.cancel()))
        eng.start()
        got = list(ok.stream())
        tail = list(victim.stream())
        return got, ok.status, victim.status, tail

    res = _both(weights, run)
    got, ok_status, v_status, tail = res["port"]
    assert ok_status == Status.OK and v_status == Status.CANCELLED
    assert 1 <= len(tail) < 48 and all(isinstance(t, int) for t in tail)
    _agree(got, _ref(weights, ok_p, 4))
    assert res["jax"][1:3] == (ok_status, v_status)


def test_finish_idempotent_single_sentinel():
    """``Request.finish`` puts ONE Terminal however many enders race it; the
    first status wins."""
    req = Request(tokens=np.zeros((1,), np.int32))
    assert req.finish(Status.SHED_DEADLINE) is True
    assert req.finish(Status.FAULTED) is False
    assert req.status == Status.SHED_DEADLINE
    sentinels = []
    while True:
        try:
            sentinels.append(req.out.get_nowait())
        except _queue.Empty:
            break
    assert len(sentinels) == 1 and isinstance(sentinels[0], Terminal)
    assert sentinels[0].status == Status.SHED_DEADLINE
    req2 = Request(tokens=np.zeros((1,), np.int32))
    req2.out.put(7)
    req2.finish(Status.OK)
    assert list(req2.stream()) == [7]
    assert Request(tokens=np.zeros((1,), np.int32)).deadline_ns is None


# -------------------------------------------------- deadlines + shedding


def test_deadline_shed_before_admission(weights):
    """A request past its deadline (0) sheds from the line before admission:
    an empty stream, SHED_DEADLINE, the counter and a shed event carrying
    the terminal code; the request behind it streams untouched."""
    late_p, live_p = _prompt(3, 5), _prompt(4, 5)

    def run(eng):
        late = eng.submit(late_p, max_new_tokens=4, deadline_ms=0)
        live = eng.submit(live_p, max_new_tokens=4)
        eng.start()
        out = (list(late.stream()), late.status, list(live.stream()), live.status)
        sheds = [e["val"] for e in eng.trace.events()
                 if e["rid"] == late.rid and e["event"] == "shed"]
        return out, sheds, _stats(eng)

    res = _both(weights, run)
    (late_s, late_st, live_s, live_st), sheds, st = res["port"]
    assert late_s == [] and late_st == Status.SHED_DEADLINE
    assert live_st == Status.OK
    _agree(live_s, _ref(weights, live_p, 4))
    assert st["shed_deadline"] == 1 and st["shed_overload"] == 0
    assert res["jax"][0][1::2] == (late_st, live_st)
    assert sheds == res["jax"][1] and len(sheds) == 1
    assert st == res["jax"][2]
    with pytest.raises(ValueError, match="deadline_ms"):
        _engine(weights, "port").submit(late_p, deadline_ms=-1)


@pytest.mark.parametrize("loop", ["pipelined", "sync", "device_loop", "spec", "fused"])
def test_deadline_shed_mid_stream_at_flush_boundary(weights, loop):
    """A deadline that passes mid-stream (rewound white-box inside the
    delivery of the 2nd token) aborts at the next tick head on every loop:
    the stream ends SHED_DEADLINE through the cancel path, a token in flight
    for it is dropped, the tokens delivered stand, and the slot serves the
    next request. The port delivers what the JAX engine delivers."""
    p, follow_p = _prompt(5, 5), _prompt(6, 5)

    def run(eng):
        req = eng.submit(p, max_new_tokens=48, deadline_ms=60_000.0)
        _on_token(req, 2, lambda: setattr(req, "deadline_ns", time.monotonic_ns() - 1))
        eng.start()
        got = list(req.stream())
        follow = eng.submit(follow_p, max_new_tokens=4)
        f = list(follow.stream())
        return got, req.status, f, follow.status, _stats(eng)

    res = _both(weights, run, loop=loop)
    got, status, f, f_status, st = res["port"]
    assert status == Status.SHED_DEADLINE and f_status == Status.OK
    assert 2 <= len(got) < 48
    _agree(got, _ref(weights, p, 48), n=len(got))
    _agree(f, _ref(weights, follow_p, 4))
    assert st["shed_deadline"] == 1
    assert got == res["jax"][0] and st == res["jax"][4]


def _burst(eng, policy_seed):
    """A hog and a burst of four (priorities 0-3) queued before ``start()``
    on a one-slot engine: the first tick head admits the hog, and the line
    of four overflows depth 1 by three."""
    hog = eng.submit(_prompt(7, 5), max_new_tokens=8)
    burst = [eng.submit(_prompt(policy_seed + i, 5), max_new_tokens=4, priority=i)
             for i in range(4)]
    eng.start()
    streams = [list(r.stream()) for r in burst]
    list(hog.stream())
    return [r.status for r in burst], streams, _stats(eng)


def test_overload_shed_default_policy_lowest_priority_first(weights):
    """shed_queue_depth bounds the waiting line after the tick head's
    admissions; the default policy sheds the lowest priority first, so the
    highest-priority member of the burst streams."""
    res = _both(weights, lambda eng: _burst(eng, 10), slots=1, shed_queue_depth=1)
    statuses, streams, st = res["port"]
    assert statuses == [Status.SHED_OVERLOAD] * 3 + [Status.OK]
    assert streams[:3] == [[], [], []]
    _agree(streams[3], _ref(weights, _prompt(13, 5), 4))
    assert st["shed_overload"] == 3
    assert (statuses, st) == (res["jax"][0], res["jax"][2])


class _ShedHighestFirst(ShedPolicy):
    def select(self, waiters, need):
        return sorted(waiters, key=lambda r: -r.priority)[:need]


def test_custom_shed_policy_loads_and_applies(weights):
    """A policy program replaces the default (an instance, a class or a
    'module:attr' string): here the highest priority sheds first, so the
    lowest streams."""
    assert isinstance(load_shed_policy("vtpu_torch.serving.shed:PriorityDeadlineShedPolicy"),
                      PriorityDeadlineShedPolicy)
    assert isinstance(load_shed_policy(None), PriorityDeadlineShedPolicy)
    with pytest.raises(ValueError, match="module:attr"):
        load_shed_policy("not-a-spec")
    with pytest.raises(ValueError, match="select"):
        load_shed_policy(object())
    with pytest.raises(ValueError, match="shed_queue_depth"):
        _engine(weights, "port", shed_queue_depth=-1)
    res = _both(weights, lambda eng: _burst(eng, 20), slots=1, shed_queue_depth=1,
                shed_policy=_ShedHighestFirst)
    statuses, streams, st = res["port"]
    assert statuses == [Status.OK] + [Status.SHED_OVERLOAD] * 3
    _agree(streams[0], _ref(weights, _prompt(20, 5), 4))
    assert (statuses, st) == (res["jax"][0], res["jax"][2])


class _BrokenPolicy(ShedPolicy):
    def select(self, waiters, need):
        raise TypeError("policy bug")


def test_broken_shed_policy_does_not_kill_the_loop(weights):
    """A policy that raises is logged and sheds nothing that tick; the
    engine serves every request."""
    res = _both(weights, lambda eng: _burst(eng, 26), slots=1, shed_queue_depth=1,
                shed_policy=_BrokenPolicy)
    statuses, streams, st = res["port"]
    assert statuses == [Status.OK] * 4
    for i, s in enumerate(streams):
        _agree(s, _ref(weights, _prompt(26 + i, 5), 4))
    assert st["shed_overload"] == 0
    assert (statuses, st) == (res["jax"][0], res["jax"][2])


# ----------------------------------------------------- crash containment


@pytest.mark.parametrize("loop", list(LOOPS))
def test_dispatch_exception_contained(weights, loop):
    """An exception escaping one request's delivery (dispatch_exc at its
    4th arrival; the 2nd on the fused loop, whose two flushes of 8 tokens
    make four) retires only that slot FAULTED, on every loop; the other
    stream equals the fault-free one and the engine serves on. The faulted
    request, its fault event and the counters are the JAX engine's."""
    prompts = [_prompt(30, 5), _prompt(31, 7)]

    def run(eng):
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.start()
        streams = [list(r.stream()) for r in reqs]
        follow = eng.submit(_prompt(32, 5), max_new_tokens=4)
        f = list(follow.stream())
        faults = [e["rid"] for e in eng.trace.events() if e["event"] == "fault"]
        return [r.status for r in reqs], streams, f, faults, _stats(eng)

    res = _both(weights, run, loop=loop, specs=[("dispatch_exc", 1 if loop == "fused" else 3)])
    statuses, streams, f, faults, st = res["port"]
    assert sorted(statuses) == [Status.FAULTED, Status.OK]
    ok = statuses.index(Status.OK)
    _agree(streams[ok], _ref(weights, prompts[ok], 8))
    _agree(f, _ref(weights, _prompt(32, 5), 4))
    assert st["faulted_requests"] == 1 and st["faults_injected"] == 1
    assert faults == [1 - ok]
    assert (statuses, faults, st) == (res["jax"][0], res["jax"][3], res["jax"][4])
    assert streams[1 - ok] == res["jax"][1][1 - ok]  # what reached the client first


def test_dispatch_exception_contained_under_tp(weights, tmp_path):
    """Containment, deadlines, overload shedding and the duty supplier under
    a tensor-parallel paged engine (tp=2, gloo, one world): the dispatch_exc
    run faults one request and the other streams as the fault-free
    single-device engine does, every block back in the pool; the shed run,
    queued before the loop starts, sheds the deadline-0 request and the
    overflow's two lowest priorities, and reports the supplier's duty."""
    import functools

    _, tree, _ = weights
    prompts = [_prompt(35, 5), _prompt(36, 7)]
    shed_prompts = [_prompt(37 + i, 5) for i in range(5)]
    run = Run(CFG, _serving(kv_page=8, faults=FaultPlan([FaultSpec("dispatch_exc", at=3)])),
              prompts, 6)
    shed_run = Run(CFG, _serving(slots=1, kv_page=8, shed_queue_depth=1,
                                 duty_supplier=functools.partial(float, 0.5)), shed_prompts, 4,
                   submit=[dict(priority=3), dict(priority=0, deadline_ms=0), dict(priority=0),
                           dict(priority=1), dict(priority=2)])
    box = {}

    def world():
        try:
            box["faults"] = launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"],
                                      f"file://{tmp_path}/faults", args=([tree], [run]),
                                      timeout=WORLD_TIMEOUT_S)
            box["shed"] = launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"],
                                    f"file://{tmp_path}/shed",
                                    args=([tree], [shed_run]),
                                    timeout=WORLD_TIMEOUT_S)
        except Exception as exc:
            box["error"] = exc

    th = threading.Thread(target=world, daemon=True)
    th.start()
    # the JAX engine under the same plans, single-device, meanwhile
    def jax_run(serving, ps, new, kws=None):
        eng = JServingEngine(weights[0], JCFG, serving)
        try:
            reqs = [eng.submit(p, max_new_tokens=new, **(kws[i] if kws else {}))
                    for i, p in enumerate(ps)]
            eng.start()
            streams = [list(r.stream()) for r in reqs]
            return [r.status for r in reqs], streams, eng.stats()
        finally:
            eng.stop()

    j_faults = jax_run(_serving(JServingConfig, kv_page=8,
                                faults=JFaultPlan([JFaultSpec("dispatch_exc", at=3)])),
                       prompts, 6)
    j_shed = jax_run(_serving(JServingConfig, slots=1, kv_page=8, shed_queue_depth=1),
                     shed_prompts, 4, shed_run.submit)
    th.join(timeout=2 * WORLD_TIMEOUT_S + 60)
    assert not th.is_alive(), "the tp=2 worlds outlived their timeout"
    assert "error" not in box, box.get("error")
    r0 = box["faults"][0][0]
    assert sorted(r0["statuses"]) == [Status.FAULTED, Status.OK]
    ok = r0["statuses"].index(Status.OK)
    _agree(r0["streams"][ok], _ref(weights, prompts[ok], 6))
    st = r0["stats"]
    assert st["faulted_requests"] == 1 and st["faults_injected"] == 1 and st["tp"] == 2
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert r0["statuses"] == j_faults[0]
    s0 = box["shed"][0][0]
    assert s0["statuses"] == [Status.OK, Status.SHED_DEADLINE, Status.SHED_OVERLOAD,
                              Status.SHED_OVERLOAD, Status.OK] == j_shed[0]
    _agree(s0["streams"][0], _ref(weights, shed_prompts[0], 4))
    _agree(s0["streams"][4], _ref(weights, shed_prompts[4], 4))
    assert (s0["stats"]["shed_deadline"], s0["stats"]["shed_overload"]) == (
        j_shed[2]["shed_deadline"], j_shed[2]["shed_overload"]) == (1, 2)
    assert s0["signals"]["duty"] == 0.5


def test_watchdog_is_one_device_under_a_mesh(weights):
    """The watchdog is served under a mesh since every op's header carries
    the paged route (tests/test_torch_tp_ops.py drives its ladder on a gloo
    world): under a hand-built mesh, which joined no world, each field
    passes and the engine reaches the adapter's own checks (the full tree
    is not one rank's shard) and, with a shard, the first broadcast, which
    needs a process group. No NotImplementedError names the field."""
    mesh = TpMesh(rank=0, size=2, device=torch.device("cpu"))
    for field, value in (("fetch_watchdog_ms", 5.0), ("fetch_watchdog_recover_ms", 5.0)):
        with pytest.raises(ValueError, match="one rank's shard"):
            ServingEngine(weights[2], CFG, _serving(**{field: value}), mesh=mesh)
        with pytest.raises(RuntimeError, match="joined no process group"):
            ServingEngine(shard_params(weights[2], mesh), CFG, _serving(**{field: value}),
                          mesh=mesh)


# ------------------------------------------------- worker crash recovery


def _disagg_engine(weights, side, specs=(), workers=1, **kw):
    """A disaggregated engine of tests/test_faults.py's configuration
    (16-token chunks and bucket, pages of 8, a 5 ms retry backoff) on one
    side, with the plan of ``specs``."""
    cls = JDisaggConfig if side == "jax" else DisaggConfig
    kw = dict(prefill_chunk=16, kv_page=8, worker_retry_backoff_ms=5.0,
              disagg=cls(prefill_workers=workers), **kw)
    return _engine(weights, side, specs=specs, **kw)


def test_worker_death_requeues_and_restarts(weights):
    """A prefill worker dying as it starts its claim loses one request at
    most: the loop releases its blocks, re-queues the request after the
    backoff and restarts the worker, and the stream completes equal to the
    fault-free stream; the terminal, the restart (traced with the request)
    and the counters equal the JAX engine's under the same plan."""
    prompt = _prompt(70, 12)
    out = {}
    for side in ("jax", "port"):
        eng = _disagg_engine(weights, side, specs=(("worker_death", 0),))
        try:
            req = eng.submit(prompt, max_new_tokens=6)
            eng.start()
            stream = list(req.stream())
        finally:
            eng.stop()
        restarts = [e["rid"] for e in eng.trace.events() if e["event"] == "worker_restart"]
        st = eng.stats()
        out[side] = (req.status, restarts == [req.rid], st["worker_restarts"],
                     st["faulted_requests"], st["faults_injected"], st["handoffs"],
                     st["kv_pool_free"] == st["kv_pool_blocks"])
        if side == "port":
            _agree(stream, _ref(weights, prompt, 6))
    assert out["port"] == out["jax"] == (Status.OK, True, 1, 0, 1, 1, True)


def test_worker_death_bounded_retries_then_faulted(weights):
    """Past worker_retry_limit deaths the request ends FAULTED with no
    token, and the restarted worker serves the next request (the plan has
    run dry); restarts, faults and injections equal the JAX engine's."""
    limit = 2
    follow_p = _prompt(72, 12)
    out = {}
    for side in ("jax", "port"):
        eng = _disagg_engine(weights, side, specs=(("worker_death", 0, limit + 1),),
                             worker_retry_limit=limit)
        eng.start()
        try:
            doomed = eng.submit(_prompt(71, 12), max_new_tokens=6)
            doomed_toks = list(doomed.stream())
            follow = eng.submit(follow_p, max_new_tokens=6)
            follow_toks = list(follow.stream())
        finally:
            eng.stop()
        st = eng.stats()
        out[side] = (doomed_toks, doomed.status, follow.status, len(follow_toks),
                     st["worker_restarts"], st["faulted_requests"], st["faults_injected"],
                     st["kv_pool_free"] == st["kv_pool_blocks"])
        if side == "port":
            _agree(follow_toks, _ref(weights, follow_p, 6))
    assert out["port"] == out["jax"] == (
        [], Status.FAULTED, Status.OK, 6, limit + 1, 1, limit + 1, True)


def test_cancel_vs_disagg_claim_single_typed_terminal(weights):
    """Cancels racing two prefill workers' claims (tests/test_races.py's
    case, driven without sleeps): of 16 requests, every 4th is cancelled
    while queued, every 4th + 1 inside its first token's delivery (on the
    worker thread, before its handoff), every 4th + 2 inside its 2nd
    token's (in a slot). Each ends with exactly one typed terminal, the
    statuses and token counts equal the JAX engine's, the untouched streams
    equal the fault-free ones, and every pool block comes back."""
    prompts = [_prompt(100 + i, 12) for i in range(16)]
    out = {}
    for side in ("jax", "port"):
        eng = _disagg_engine(weights, side, workers=2, max_new_tokens=4)
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        for i, r in enumerate(reqs):
            if i % 4 == 0:
                r.cancel()
            elif i % 4 in (1, 2):
                _on_token(r, i % 4, r.cancel)
        eng.start()
        try:
            toks = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
        st = eng.stats()
        assert st["kv_pool_free"] == st["kv_pool_blocks"] and st["handoff_copies"] == 0
        for r in reqs:
            assert r.out.empty() and r.status in Status.ALL  # the one terminal was read
        out[side] = ([r.status for r in reqs], [len(t) for t in toks])
        if side == "port":
            for i in range(3, 16, 4):
                _agree(toks[i], _ref(weights, prompts[i], 4))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [Status.CANCELLED] * 3 + [Status.OK] + out["port"][0][4:]
    assert out["port"][1][:4] == [0, 1, 2, 4]


# --------------------------------------------------- injection seams: pool


def test_alloc_exhaust_injection_exercises_backpressure(weights):
    """An injected dry pool runs the real backpressure path: the admission
    waits, is retried, and streams what an uninjected run streams."""
    p = _prompt(40, 5)

    def run(eng):
        req = eng.submit(p, max_new_tokens=6)
        eng.start()
        return list(req.stream()), req.status, _stats(eng, ("pool_blocked_admissions",))

    res = _both(weights, run, specs=[("alloc_exhaust", 0, 2)], kv_page=8, kv_pool_blocks=16)
    got, status, st = res["port"]
    assert status == Status.OK
    _agree(got, _ref(weights, p, 6))
    assert st["pool_blocked_admissions"] == 2 and st["faults_injected"] == 2
    assert st == res["jax"][2]


def _park_evict_resume(eng):
    """One park -> eviction -> resume round trip on an overcommit engine:
    the victim parks after its 2nd token (asked inside that delivery), a
    wave of two needs its pages, then it resumes. Returns the victim's
    stream and status, the wave's streams and the counters."""
    victim = eng.submit(_prompt(50, 8), max_new_tokens=24)
    _on_token(victim, 2, lambda: eng.park(victim))
    eng.start()
    _wait(lambda: eng.stats()["parked_sessions"] >= 1, "the park")
    got = []
    while len(got) < victim.delivered:
        got.append(victim.out.get(timeout=60))
    wave = [eng.submit(_prompt(60 + i, 8), max_new_tokens=24) for i in range(2)]
    waves = [list(r.stream()) for r in wave]
    eng.resume(victim)
    got += list(victim.stream())
    return got, victim.status, waves, _stats(eng, (
        "fault_recomputes", "swap_faults", "evicted_blocks", "parks", "resumes",
        "swap_out_bytes", "swap_in_bytes"))


OVERCOMMIT = dict(max_new_tokens=24, prefill_chunk=16, kv_page=8, kv_pool_blocks=8, kv_swap=8)


@pytest.mark.parametrize("seam,recomputes", [("swap_d2h_loss", 1), ("swap_h2d_loss", 1)])
def test_swap_loss_routes_to_recompute(weights, seam, recomputes):
    """A lost spill (swap_d2h_loss) drops the victim's pages; a lost restore
    (swap_h2d_loss) drops its host pages: either way the resume rebuilds
    it through prefill, and the stream, the wave's and the counters are
    the JAX engine's under the same plan (and the victim's is its
    never-parked stream)."""
    res = _both(weights, _park_evict_resume, specs=[(seam, 0)], **OVERCOMMIT)
    got, status, waves, st = res["port"]
    assert status == Status.OK and len(got) == 24
    _agree(got, _ref(weights, _prompt(50, 8), 24))
    for i, w in enumerate(waves):
        _agree(w, _ref(weights, _prompt(60 + i, 8), 24))
    assert st["fault_recomputes"] == recomputes and st["faults_injected"] == 1
    assert (got, st) == (res["jax"][0], res["jax"][3])


# ------------------------------------------------------- fetch watchdog


def _sequential(prompts, new):
    def run(eng):
        eng.start()
        streams = [list(eng.submit(p, max_new_tokens=new).stream()) for p in prompts]
        events = [(e["event"], e["val"]) for e in eng.trace.events()
                  if e["event"] in ("degrade", "recover")]
        return streams, events, _stats(eng, ("paged_attn_kernel_ticks",
                                             "paged_attn_gather_ticks"))
    return run


def _watchdog(**kw):
    return dict(fetch_watchdog_ms=WATCHDOG_MS, **kw)


def test_watchdog_degrades_device_loop_to_one_token_flushes(weights):
    """A fetch stalled past the threshold trips rung 1: the k-tick loop
    flushes one token at a time, its stream unchanged."""
    p = [_prompt(80, 5)]
    box = {}

    def run(eng):
        box["port" if "torch" in type(eng).__module__ else "jax"] = eng
        return _sequential(p, 10)(eng)

    res = _both(weights, run, specs=[("delayed_fetch", 1, 1, STALL_S)],
                **_watchdog(decode_loop_k=4))
    streams, events, st = res["port"]
    _agree(streams[0], _ref(weights, p[0], 10))
    assert st["watchdog_degrades"] == 1 and events == [("degrade", 1)]
    assert box["port"]._loop_cap == 1
    assert (streams, events, st) == res["jax"]


def test_watchdog_reroutes_paged_attn_to_gather(weights):
    """Rung 2 on a forced-kernel paged engine: later ticks take the gather
    route (counted as such), the stream unchanged."""
    p = [_prompt(81, 5)]
    box = {}

    def run(eng):
        box["port" if "torch" in type(eng).__module__ else "jax"] = eng
        return _sequential(p, 12)(eng)

    res = _both(weights, run, specs=[("delayed_fetch", 1, 1, STALL_S)],
                **_watchdog(kv_page=8, paged_attn="kernel", max_new_tokens=12))
    streams, events, st = res["port"]
    _agree(streams[0], _ref(weights, p[0], 12))
    assert st["watchdog_degrades"] == 1
    assert st["paged_attn_kernel_ticks"] > 0 and st["paged_attn_gather_ticks"] > 0
    assert box["port"]._paged_attn == "gather" and box["port"].model.paged_attn == "gather"
    assert (streams, events, st) == res["jax"]


def test_watchdog_recovers_device_loop_after_grace_window(weights):
    """The full cycle on rung 1: a stall clamps the flushes, healthy
    fetches over the recovery window lift the clamp, and the rung re-arms
    for a relapse; streams unchanged throughout."""
    ps = [_prompt(85, 5), _prompt(86, 5)]
    box = {}

    def run(eng):
        box["port" if "torch" in type(eng).__module__ else "jax"] = eng
        return _sequential(ps, 12)(eng)

    res = _both(weights, run, specs=[("delayed_fetch", 1, 1, STALL_S)],
                **_watchdog(decode_loop_k=4, fetch_watchdog_recover_ms=RECOVER_MS))
    streams, events, st = res["port"]
    for s, p in zip(streams, ps):
        _agree(s, _ref(weights, p, 12))
    assert st["watchdog_degrades"] == 1 and st["watchdog_recoveries"] == 1
    assert events == [("degrade", 1), ("recover", 0)]
    eng = box["port"]
    assert eng._loop_cap == eng._loop_k == 4 and eng._degrade_level == 0
    assert "loop_k1" in eng._degrade_rungs
    assert (streams, events, st) == res["jax"]


def test_watchdog_recovery_restores_paged_attn_route(weights):
    """The rung-2 recovery: a forced-kernel paged engine degraded to gather
    goes back to the kernel route once latency recovers; streams unchanged
    across both switches."""
    ps = [_prompt(87, 5), _prompt(88, 5)]
    box = {}

    def run(eng):
        box["port" if "torch" in type(eng).__module__ else "jax"] = eng
        return _sequential(ps, 12)(eng)

    # the stall trips at fetch 1, fetch 2 starts the healthy streak and the
    # held fetch 3 ends it: the recovery lands on the same tick on both
    # engines, so their kernel and gather tick counts agree
    res = _both(weights, run,
                specs=[("delayed_fetch", 1, 1, STALL_S), ("delayed_fetch", 3, 1, STREAK_S)],
                **_watchdog(kv_page=8, paged_attn="kernel", max_new_tokens=12,
                            fetch_watchdog_recover_ms=RECOVER_MS))
    streams, events, st = res["port"]
    for s, p in zip(streams, ps):
        _agree(s, _ref(weights, p, 12))
    assert st["watchdog_degrades"] == 1 and st["watchdog_recoveries"] == 1
    assert st["paged_attn_gather_ticks"] > 0
    assert box["port"]._paged_attn == "kernel" and box["port"].model.paged_attn == "kernel"
    assert (streams, events, st) == res["jax"]


def test_watchdog_ladder_degrades_and_recovers_lifo(weights):
    """Both rungs on a multi-tick forced-kernel paged engine: two stalls
    apply loop_k1 then paged_gather, and the recoveries lift paged_gather
    first, then loop_k1 (the last applied first), each after its own
    window."""
    ps = [_prompt(89, 5), _prompt(90, 5)]
    box = {}

    def run(eng):
        box["port" if "torch" in type(eng).__module__ else "jax"] = eng
        return _sequential(ps, 16)(eng)

    res = _both(weights, run, specs=[("delayed_fetch", 1, 2, STALL_S)],
                **_watchdog(kv_page=8, paged_attn="kernel", decode_loop_k=4,
                            max_new_tokens=16, fetch_watchdog_recover_ms=RECOVER_MS))
    streams, events, st = res["port"]
    for s, p in zip(streams, ps):
        _agree(s, _ref(weights, p, 16))
    assert events == [("degrade", 1), ("degrade", 2), ("recover", 1), ("recover", 0)]
    assert st["watchdog_degrades"] == 2 and st["watchdog_recoveries"] == 2
    eng = box["port"]
    assert eng._degrade_rungs == ["loop_k1", "paged_gather"] and eng._paged_attn == "kernel"
    # the inner ticks a route served differ: rung 1 is a one-token flush here
    assert (streams, events) == res["jax"][:2]
    assert {k: st[k] for k in KEYS} == {k: res["jax"][2][k] for k in KEYS}


# -------------------------------------------- shed policy engine signals


def test_shed_policy_receives_engine_signals(weights):
    """A three-argument policy receives the EngineSignals snapshot (queue
    depth pinned to its waiters, pool free and high-water mark, parked
    sessions) and sheds by memory pressure: the longest prompt. White-box:
    two tick heads by hand, no loop thread."""
    seen = {}

    def run(eng):
        side = "port" if "torch" in type(eng).__module__ else "jax"
        seen[side] = []

        class MemoryPressurePolicy(ShedPolicy):
            def select(self, waiters, need, signals=None):
                seen[side].append(signals)
                return sorted(waiters, key=lambda r: -int(r.tokens.shape[0]))[:need]

        eng._shed_policy = MemoryPressurePolicy()
        eng._shed_signals = accepts_signals(eng._shed_policy)
        live = eng.submit(_prompt(90, 5), max_new_tokens=8)
        eng._tick_head()
        assert eng._slot_req[0] is live
        short = eng.submit(_prompt(91, 4), max_new_tokens=2)
        long_ = eng.submit(_prompt(92, 14), max_new_tokens=2)
        eng._tick_head()
        return eng._stats["shed_overload"], long_, short

    res = _both(weights, run, slots=1, kv_page=8, kv_swap=4, prefill_chunk=8,
                shed_queue_depth=1)
    shed, long_, short = res["port"]
    assert shed == 1 and long_.status == Status.SHED_OVERLOAD
    assert short.status == Status.CANCELLED  # survived to the stop
    sig, jsig = seen["port"][0], seen["jax"][0]
    assert isinstance(sig, EngineSignals)
    assert (sig.queue_depth, sig.active_slots, sig.parked_sessions) == (2, 1, 0)
    assert sig.pool_free is not None and sig.pool_used_hwm is not None and sig.now_ns > 0
    for f in ("queue_depth", "active_slots", "pool_free", "pool_used_hwm", "parked_sessions",
              "prefill_backlog", "pool_blocks", "draining", "duty"):
        assert getattr(sig, f) == getattr(jsig, f), f


def test_duty_supplier_populates_engine_signals(weights):
    """duty_supplier feeds EngineSignals.duty and the shed policy's snapshot;
    a raising supplier reports None; a non-callable is refused."""
    seen = []

    class DutyAwarePolicy(ShedPolicy):
        def select(self, waiters, need, signals=None):
            seen.append(signals)
            return sorted(waiters, key=lambda r: r.priority)[:need]

    eng = _engine(weights, "port", slots=1, kv_page=8, kv_swap=4, shed_queue_depth=1,
                  shed_policy=DutyAwarePolicy, duty_supplier=lambda: 0.75)
    try:
        sig = eng.signals()
        assert sig.duty == 0.75 and sig.draining is False
        assert sig.pool_blocks == eng._n_blocks - 1
        live = eng.submit(_prompt(96, 5), max_new_tokens=8)
        eng._tick_head()
        assert eng._slot_req[0] is live
        eng.submit(_prompt(97, 5), max_new_tokens=2, priority=5)
        drop = eng.submit(_prompt(98, 5), max_new_tokens=2, priority=0)
        eng._tick_head()
        assert eng._stats["shed_overload"] == 1 and drop.status == Status.SHED_OVERLOAD
        assert seen and seen[0].duty == 0.75
    finally:
        eng.stop()

    def boom():
        raise RuntimeError("supplier unavailable")

    eng2 = _engine(weights, "port", duty_supplier=boom)
    try:
        assert eng2.signals().duty is None
    finally:
        eng2.stop()
    with pytest.raises(ValueError, match="duty_supplier"):
        _engine(weights, "port", duty_supplier=0.5)
    with pytest.raises(ValueError, match="FaultPlan"):
        _engine(weights, "port", faults=[("dispatch_exc", 0)])


def test_legacy_two_arg_shed_policy_still_works(weights):
    """A two-argument policy is detected at construction and called without
    the snapshot."""

    class LegacyPolicy:
        def select(self, waiters, need):
            return sorted(waiters, key=lambda r: r.priority)[:need]

    assert accepts_signals(LegacyPolicy()) is False
    assert accepts_signals(PriorityDeadlineShedPolicy()) is True
    assert accepts_signals(type("Star", (), {"select": lambda self, *a: []})()) is True
    eng = _engine(weights, "port", slots=1, shed_queue_depth=1, shed_policy=LegacyPolicy)
    try:
        eng.submit(_prompt(93, 5), max_new_tokens=8)
        eng._tick_head()
        keep = eng.submit(_prompt(94, 5), max_new_tokens=2, priority=5)
        drop = eng.submit(_prompt(95, 5), max_new_tokens=2, priority=0)
        eng._tick_head()
        assert eng._stats["shed_overload"] == 1
    finally:
        eng.stop()
    assert drop.status == Status.SHED_OVERLOAD
    assert keep.status == Status.CANCELLED


# ------------------------------------------------------- FaultPlan unit


def test_fault_plan_schedule_and_counters():
    plan = FaultPlan([FaultSpec("dispatch_exc", at=1, count=2),
                      FaultSpec("delayed_fetch", at=0, arg=0.25)])
    assert plan.fire("dispatch_exc") is None
    assert plan.fire("dispatch_exc") is not None
    assert plan.fire("dispatch_exc") is not None
    assert plan.fire("dispatch_exc") is None
    spec = plan.fire("delayed_fetch")
    assert spec is not None and spec.arg == 0.25
    snap = plan.snapshot()
    assert snap["arrivals"]["dispatch_exc"] == 4
    assert snap["injected"]["dispatch_exc"] == 2
    assert plan.injected_total == 3
    with pytest.raises(ValueError, match="unknown fault seam"):
        FaultSpec("nope")
    with pytest.raises(ValueError, match="count"):
        FaultSpec("dispatch_exc", count=0)
    # arm fires at the next arrival
    armed = plan.arm("engine_death")
    assert armed.at == 0 and plan.fire("engine_death") is armed
    assert plan.fire("engine_death") is None


def test_fault_plan_seeded_is_deterministic():
    """The seeded schedule is a pure function of (seed, rates), the same as
    the reference's for the same seed; a plan pickles with its schedule and
    counts (a spawned rank receives it so)."""
    import pickle

    rates = {"dispatch_exc": 0.3, "alloc_exhaust": 0.2}

    def fire_pattern(plan, n=64):
        return [(s, i) for s in sorted(rates) for i in range(n) if plan._sched[s].get(i)]

    a, b, c = FaultPlan.seeded(7, rates), FaultPlan.seeded(7, rates), FaultPlan.seeded(8, rates)
    assert fire_pattern(a) == fire_pattern(b)
    assert fire_pattern(a) != fire_pattern(c)
    assert fire_pattern(a) == fire_pattern(JFaultPlan.seeded(7, rates))
    assert a.injected_total == 0
    a.fire("dispatch_exc")
    a2 = pickle.loads(pickle.dumps(a))
    assert a2.snapshot() == a.snapshot() and fire_pattern(a2) == fire_pattern(a)
    assert a2.fire("alloc_exhaust") == a.fire("alloc_exhaust")


# --------------------------------------------------------- engine death


@pytest.mark.parametrize("loop", ["pipelined", "device_loop"])
def test_engine_death_skips_cleanup(weights, loop):
    """engine_death, armed inside the delivery of a live stream's 2nd token,
    kills the loop thread at the next flush boundary without its cleanup:
    the thread exits, no terminal reaches the live streams, the heartbeat
    stops, and stop() returns. A fresh engine then serves as before."""
    plan = FaultPlan()
    eng = _engine(weights, "port", loop, faults=plan, max_new_tokens=32)
    reqs = [eng.submit(_prompt(100 + i, 5), max_new_tokens=32) for i in range(2)]
    _on_token(reqs[0], 2, lambda: plan.arm("engine_death"))
    eng.start()
    eng._thread.join(timeout=30)
    assert not eng._thread.is_alive()
    assert eng._died and eng.loop_error is None
    assert plan.snapshot()["injected"]["engine_death"] == 1
    beat = eng._beat_ns
    assert beat > 0
    eng.stop()  # returns although the loop died
    assert eng._beat_ns == beat
    for r in reqs:
        assert r.status is None
        items = []
        while True:
            try:
                items.append(r.out.get_nowait())
            except _queue.Empty:
                break
        assert all(isinstance(t, int) for t in items)
    assert eng.stats()["faults_injected"] == 1
    fresh = _engine(weights, "port", loop)
    try:
        req = fresh.submit(_prompt(100, 5), max_new_tokens=6)
        fresh.start()
        got = list(req.stream())
    finally:
        fresh.stop()
    assert req.status == Status.OK
    _agree(got, _ref(weights, _prompt(100, 5), 6))
