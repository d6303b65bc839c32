"""The port's disaggregated prefill/decode (vtpu_torch/serving/disagg.py)
against vtpu's on the same weights (CPU, f32; int8 KV and the MoE where
named), in the reference's configuration (tests/test_disagg.py): two slots,
one 8-token bucket, 8-token chunks and pages, so prompts of 12 tokens
prefill through the chunked path in both modes.

Held: greedy streams of the disaggregated engine equal the co-scheduled
engine's and the JAX disaggregated engine's, up to the first step whose
top-1/top-2 margin (the JAX trunk teacher-forced on the stream) is under
1e-4, on the pipelined, synchronous and multi-tick loops, for exact KV,
int8 KV and the MoE; the handoff contract (``handoff_copies == 0``,
``device_gets_per_tick`` that of the loop, every pool block back by the
end) and the counters equal to the JAX engine's; prefix requests through
the worker (full pages shared, the boundary page copied) with one and two
workers; a handoff racing the overcommit eviction; cancels at each stage a
request passes; a park that lands while a worker owns the request; the
dormant ``disagg=None``; the construction refusals; the Chrome trace's
worker lane; the controller's levels, shares and repartitions on one
backlog sequence.

No verdict races the loop thread: bursts are queued before ``start()``, and
parks and cancels are asked from inside the delivery of a chosen token (a
hook on the request's queue; a first token is delivered by the worker
thread, every later one by the loop). A waiting loop only guards against a
hang. One torch thread."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.moe import (
    MoEConfig as JMoEConfig, init_moe_params as j_init_moe_params, moe_forward as j_moe_forward,
)
from vtpu.models.transformer import prefill as j_prefill
from vtpu.serving import (
    DisaggConfig as JDisaggConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from vtpu.serving.adapters import MoeSlotModel as JMoeSlotModel
from vtpu.serving.disagg import DisaggController as JDisaggController
from vtpu_torch.convert import moe_params_from_numpy, params_from_numpy
from vtpu_torch.models import ModelConfig, MoEConfig
from vtpu_torch.obs.trace import HANDOFF_SEQUENCE, PREFILL_LANE_TID, subsequence
from vtpu_torch.parallel import TpMesh, shard_params
from vtpu_torch.serving import DisaggConfig, ServingConfig, ServingEngine, Status
from vtpu_torch.serving.adapters import MoeSlotModel, SsmSlotModel
from vtpu_torch.serving.disagg import DisaggController

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32, head_dim=8)
MOE_DIMS = dict(vocab=96, d_model=64, n_heads=2, n_layers=2, d_ff=64, n_experts=4, top_k=2,
                max_seq=32, head_dim=32)
PAGE = 8
MARGIN = 1e-4
DISAGG = dict(min_prefill_tokens=8, max_prefill_tokens=64, backlog_high=2)
# the loops a disaggregated engine serves on
LOOPS = {"pipelined": {}, "sync": dict(pipeline_decode=False), "device_loop": dict(decode_loop_k=4)}
# the counters held against the JAX engine's
KEYS = ("disagg", "handoffs", "handoff_copies", "device_gets_per_tick", "kv_pool_free",
        "kv_pool_blocks", "admissions", "generated_tokens", "prefill_chunks",
        "faulted_requests", "worker_restarts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(jp):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


class _Kind:
    """One model kind on both sides: the JAX params and config, the port's
    params and config, and how each side's engine is built."""

    def __init__(self, name):
        self.name = name
        if name == "moe":
            self.jcfg = JMoEConfig(**MOE_DIMS, dtype=jnp.float32)
            self.cfg = MoEConfig(**MOE_DIMS, dtype=torch.float32)
            self.jp = j_init_moe_params(jax.random.key(5), self.jcfg)
            self.tp = moe_params_from_numpy(_tree(self.jp), self.cfg, device="cpu")
        else:
            int8 = name == "int8"
            self.jcfg = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=int8)
            self.cfg = ModelConfig(**DIMS, dtype=torch.float32, kv_int8=int8)
            self.jp = j_init_params(jax.random.key(0), self.jcfg)
            self.tp = params_from_numpy(_tree(self.jp), self.cfg, device="cpu")
        self.vocab = self.cfg.vocab

    def engine(self, side, disagg=None, **kw):
        base = dict(slots=2, prefill_buckets=(8,), max_new_tokens=6, prefill_chunk=8,
                    kv_page=PAGE)
        base.update(kw)
        if side == "jax":
            serving = JServingConfig(disagg=JDisaggConfig(**disagg) if disagg else None,
                                     **base)
            if self.name == "moe":
                return JServingEngine(None, None, serving,
                                      model=JMoeSlotModel(self.jp, self.jcfg, kv_page=PAGE))
            return JServingEngine(self.jp, self.jcfg, serving)
        serving = ServingConfig(disagg=DisaggConfig(**disagg) if disagg else None, **base)
        if self.name == "moe":
            return ServingEngine(serving=serving, model=MoeSlotModel(
                self.tp, self.cfg, kv_page=PAGE, device="cpu"))
        return ServingEngine(self.tp, self.cfg, serving, device="cpu")

    def margins(self, prompt, stream):
        """Each step's top-1/top-2 logit margin of the JAX trunk fed the
        prompt and the stream."""
        toks = jnp.asarray([list(prompt) + list(stream)], jnp.int32)
        if self.name == "moe":
            logits = j_moe_forward(self.jp, self.jcfg, toks)[0]
        else:
            logits = j_prefill(self.jp, self.jcfg, toks)[0]
        rows = np.asarray(logits)[0, len(prompt) - 1:len(prompt) - 1 + len(stream)]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        return list(top2[:, 1] - top2[:, 0])


_KINDS: dict = {}


def _kind(name):
    if name not in _KINDS:
        _KINDS[name] = _Kind(name)
    return _KINDS[name]


def _prompt(seed, n, vocab=DIMS["vocab"]):
    """The reference test's prompts (tests/test_disagg.py's _prompt)."""
    return [int(t) for t in jax.random.randint(jax.random.key(seed), (n,), 1, vocab, jnp.int32)]


def _agree(kind, prompt, got, want):
    """``got`` equals ``want`` up to the first step whose margin is under
    MARGIN; returns the tokens compared."""
    assert len(got) == len(want), (got, want)
    compared = 0
    for a, b, m in zip(got, want, kind.margins(prompt, want)):
        if m < MARGIN:
            break
        assert a == b, (got, want)
        compared += 1
    return compared


def _serve(eng, prompts, steps=6, prefix=None, before_start=True):
    """Submit (before ``start()`` by default), stream every request, stop;
    returns (streams, statuses, stats, trace events, rids)."""
    try:
        if not before_start:
            eng.start()
        pid = eng.register_prefix(prefix) if prefix is not None else None
        reqs = [eng.submit(p, max_new_tokens=steps, prefix=pid) for p in prompts]
        if before_start:
            eng.start()
        streams = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    return (streams, [r.status for r in reqs], eng.stats(), eng.trace.events(),
            [r.rid for r in reqs])


def _on_token(req, n, action):
    """Run ``action()`` right after ``req``'s n-th token is put on its
    stream, inside that delivery."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if isinstance(item, (int, np.integer)) and not isinstance(item, bool):
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


def _contract(stats, handoffs):
    assert stats["disagg"] is True
    assert stats["handoffs"] == handoffs
    assert stats["handoff_copies"] == 0
    assert stats["kv_pool_free"] == stats["kv_pool_blocks"]


_JAX_RUNS: dict = {}


def _jax_disagg(kind, prompts, steps=6):
    """The JAX disaggregated engine's streams and counters (cached)."""
    key = (kind.name, tuple(map(tuple, prompts)), steps)
    if key not in _JAX_RUNS:
        streams, statuses, st, _, _ = _serve(kind.engine("jax", DISAGG), prompts, steps)
        _JAX_RUNS[key] = (streams, statuses, {k: st[k] for k in KEYS})
    return _JAX_RUNS[key]


# ---------------------------------------------------- stream equality


@pytest.mark.parametrize("kind,loop", [
    ("exact", "pipelined"), ("exact", "sync"), ("exact", "device_loop"), ("int8", "pipelined"),
    ("moe", "pipelined"), ("moe", "device_loop")])
def test_disagg_streams_token_equal(kind, loop):
    """Disaggregated streams equal the co-scheduled engine's on the same
    loop and the JAX disaggregated engine's; the handoff contract and the
    counters equal the JAX engine's (a flush's device_gets_per_tick is
    1/k); the handoff lifecycle is in the trace in order."""
    k = _kind(kind)
    prompts = [_prompt({"exact": 40, "int8": 50, "moe": 60}[kind] + i, 12, k.vocab)
               for i in range(4 if kind == "exact" else 3)]
    ref, _, ref_st, _, _ = _serve(k.engine("port", **LOOPS[loop]), prompts)
    got, statuses, st, events, rids = _serve(k.engine("port", DISAGG, **LOOPS[loop]), prompts)
    jstreams, jstatuses, jst = _jax_disagg(k, prompts)
    assert statuses == jstatuses == [Status.OK] * len(prompts)
    for p, g, r, j in zip(prompts, got, ref, jstreams):
        _agree(k, p, g, r)
        _agree(k, p, g, j)
    assert ref_st["disagg"] is False and ref_st["handoffs"] == 0
    _contract(st, len(prompts))
    assert st["device_gets_per_tick"] == (0.25 if loop == "device_loop" else 1.0)
    for key in KEYS:
        if key != "device_gets_per_tick":
            assert st[key] == jst[key], key
    by_rid = {}
    for e in events:
        by_rid.setdefault(e["rid"], []).append(e["event"])
    for rid in rids:
        assert subsequence(HANDOFF_SEQUENCE, by_rid[rid]), by_rid[rid]


# -------------------------------------------------- prefix composition


@pytest.mark.parametrize("workers", [1, 2])
def test_disagg_prefix_zero_copy(workers):
    """Prefixed requests through the workers: the prefix's full pages are
    shared read-only, only the boundary page is copied, the install copies
    nothing; streams equal the co-scheduled prefix path's and the JAX
    engine's, and the share and copy counters equal both (two workers: the
    claim lock keeps racing workers from reserving one request twice)."""
    k = _kind("exact")
    base = 80 if workers == 1 else 140
    prefix = _prompt(base, 12)
    sufs = [_prompt(base + 1 + i, 9) for i in range(3 if workers == 1 else 4)]
    disagg = dict(DISAGG, prefill_workers=workers)
    ref, _, ref_st, _, _ = _serve(k.engine("port"), sufs, 5, prefix, before_start=False)
    got, statuses, st, _, _ = _serve(k.engine("port", disagg), sufs, 5, prefix,
                                     before_start=False)
    jgot, jstatuses, jst, _, _ = _serve(k.engine("jax", disagg), sufs, 5, prefix,
                                        before_start=False)
    assert statuses == jstatuses == [Status.OK] * len(sufs)
    for s, g, r, j in zip(sufs, got, ref, jgot):
        _agree(k, prefix + s, g, r)
        _agree(k, prefix + s, g, j)
    assert st["handoffs"] == len(sufs) and st["handoff_copies"] == 0
    assert st["prefix_install_copies"] == 0
    for key in ("prefix_blocks_shared", "prefix_cow_copies"):
        assert st[key] == ref_st[key] == jst[key], key
    assert st["prefix_cow_copies"] > 0


# ------------------------------------------- eviction / lifecycle races


def test_handoff_racing_eviction_never_corrupts():
    """Two sessions park after their 2nd token, holding every pool block
    but one; a new wave's reservations must then evict through the reclaim
    assist (the worker posts the blocks it needs, the loop evicts to the
    host tier), its handoffs land in the freed blocks, and the parked
    sessions resume. Every stream equals the JAX engine's unconstrained
    stream (a big pool, co-scheduled)."""
    k = _kind("exact")
    new_a = 16
    pages_a = -(-(12 + new_a) // PAGE)
    prompts_a = [_prompt(90 + i, 12) for i in range(2)]
    prompts_b = [_prompt(95 + i, 12) for i in range(2)]
    jeng = k.engine("jax")
    jeng.start()
    try:
        jr = [jeng.submit(p, max_new_tokens=new_a) for p in prompts_a]
        jr += [jeng.submit(p, max_new_tokens=6) for p in prompts_b]
        want = [list(r.stream()) for r in jr]
    finally:
        jeng.stop()
    eng = k.engine("port", DISAGG, kv_pool_blocks=2 * pages_a + 1, kv_swap=2 * pages_a)
    wave_a = [eng.submit(p, max_new_tokens=new_a) for p in prompts_a]
    for r in wave_a:
        _on_token(r, 2, lambda r=r: eng.park(r))
    eng.start()
    try:
        _wait(lambda: eng.stats()["parked_sessions"] == 2, "the parks")
        assert eng.stats()["kv_pool_free"] == 1
        wave_b = [eng.submit(p, max_new_tokens=6) for p in prompts_b]
        streams_b = [list(r.stream()) for r in wave_b]
        for r in wave_a:
            eng.resume(r)
        streams_a = [list(r.stream()) for r in wave_a]
    finally:
        eng.stop()
    st = eng.stats()
    for p, g, w in zip(prompts_a + prompts_b, streams_a + streams_b, want):
        _agree(k, p, g, w)
    assert all(r.status == Status.OK for r in wave_a + wave_b)
    assert st["evicted_blocks"] > 0 and st["swap_faults"] > 0
    assert st["pool_blocked_admissions"] > 0  # the workers' allocator misses
    assert st["handoffs"] == 4 and st["handoff_copies"] == 0
    assert st["kv_pool_free"] == st["kv_pool_blocks"] and st["swap_host_free"] == 2 * pages_a


def _cancel_plan(eng, bg, victims):
    """Cancels at each stage a request passes: victim 0 while queued
    (before start), victim 1 inside its first token's delivery (on the
    worker thread, before the handoff), victim 2 inside its 2nd token's
    (installed, in a slot), victim 3 inside bg's 2nd token's (wherever it
    is then), and bg itself inside its 6th token's."""
    victims[0].cancel()
    _on_token(victims[1], 1, victims[1].cancel)
    _on_token(victims[2], 2, victims[2].cancel)
    _on_token(bg, 2, victims[3].cancel)
    _on_token(bg, 6, bg.cancel)


def test_cancel_mid_prefill_releases_every_block():
    """Whatever stage a cancel lands in, the stream ends with one CANCELLED
    terminal, every reserved block returns to the pool, and nothing is
    copied; the deterministic stages' terminals and token counts equal the
    JAX engine's under the same plan."""
    k = _kind("exact")
    slow = dict(min_prefill_tokens=8, max_prefill_tokens=8, backlog_high=99)
    out = {}
    for side in ("jax", "port"):
        eng = k.engine(side, slow, max_new_tokens=48)
        bg = eng.submit(_prompt(100, 12), max_new_tokens=40)
        victims = [eng.submit(_prompt(101 + i, 24), max_new_tokens=8) for i in range(4)]
        _cancel_plan(eng, bg, victims)
        eng.start()
        try:
            toks = [list(r.stream()) for r in [bg] + victims]
            _wait(lambda: eng.stats()["kv_pool_free"] == eng.stats()["kv_pool_blocks"],
                  "the blocks' release")
        finally:
            eng.stop()
        st = eng.stats()
        assert st["kv_pool_free"] == st["kv_pool_blocks"] and st["handoff_copies"] == 0
        out[side] = ([r.status for r in [bg] + victims], [len(t) for t in toks])
        for r in [bg] + victims:
            assert r.out.empty()  # one terminal, already taken by stream()
    statuses, counts = out["port"]
    assert statuses == [Status.CANCELLED] * 5
    assert statuses == out["jax"][0]
    assert counts[1:4] == [0, 1, 2] == out["jax"][1][1:4]
    assert counts[0] == 6 and counts[4] <= 8


def test_park_while_worker_owns_request_defers_then_settles():
    """A park asked inside the first token's delivery lands while the worker
    still owns the request (before its handoff): the command waits, the
    session parks once it reaches a slot, resumes and finishes its exact
    stream; parks, resumes and streams equal the JAX engine's."""
    k = _kind("exact")
    prompts = [_prompt(110 + i, 12) for i in range(2)]
    pages_per = -(-(12 + 6) // PAGE)
    out = {}
    for side in ("jax", "port"):
        eng = k.engine(side, DISAGG, kv_swap=4 * pages_per)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            _on_token(r, 1, lambda r=r: eng.park(r))
        eng.start()
        try:
            _wait(lambda: eng.stats()["parked_sessions"] == 2, "the deferred parks")
            for r in reqs:
                eng.resume(r)
            streams = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
        st = eng.stats()
        out[side] = (streams, [r.status for r in reqs], st["parks"], st["resumes"])
        assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert out["port"][1:] == out["jax"][1:] == ([Status.OK] * 2, 2, 2)
    for p, g, j in zip(prompts, out["port"][0], out["jax"][0]):
        _agree(k, p, g, j)


# ------------------------------------------------------------ dormant


def test_disagg_none_is_dormant():
    """disagg=None: no runtime, no workers; the seven keys equal the JAX
    engine's (False, zeros and a None share)."""
    k = _kind("exact")
    seven = ("disagg", "handoffs", "handoff_copies", "repartitions", "prefill_backlog",
             "prefill_share_tokens", "worker_restarts")
    got = {}
    for side in ("jax", "port"):
        eng = k.engine(side)
        assert eng._disagg is None
        streams, _, st, _, _ = _serve(eng, [_prompt(120, 12)], 4)
        assert len(streams[0]) == 4
        got[side] = {key: st[key] for key in seven}
    assert got["port"] == got["jax"]
    assert got["port"]["disagg"] is False and got["port"]["prefill_share_tokens"] is None


def test_disagg_requires_paged_chunked_device_sampling():
    """The reference's refusals with its errors: no paged pool, no
    prefill_chunk, a custom sampler, speculation, serial admission, a
    config that is not a DisaggConfig, bad knobs; the SSM (no paged pool);
    an empty prompt without a prefix in both modes."""
    k = _kind("exact")
    d = DisaggConfig(**DISAGG)
    bad = [
        (dict(slots=2, prefill_buckets=(8,), prefill_chunk=8), {}, "paged"),
        (dict(slots=2, prefill_buckets=(8,), kv_page=PAGE), {}, "prefill_chunk"),
        (dict(slots=2, prefill_buckets=(8,), prefill_chunk=8, kv_page=PAGE),
         dict(sample=lambda row: 0), "device sampling"),
        (dict(slots=2, prefill_buckets=(8,), prefill_chunk=8, kv_page=PAGE, spec_tokens=2),
         {}, "device sampling"),
        (dict(slots=2, prefill_buckets=(8,), prefill_chunk=8, kv_page=PAGE,
              async_admission=False), {}, "batched/async admission"),
    ]
    for kw, extra, match in bad:
        with pytest.raises(ValueError, match=match):
            ServingEngine(k.tp, k.cfg, ServingConfig(disagg=d, **kw), device="cpu", **extra)
        with pytest.raises(ValueError, match=match):
            JServingEngine(k.jp, k.jcfg, JServingConfig(disagg=JDisaggConfig(**DISAGG), **kw),
                           **extra)
    with pytest.raises(ValueError, match="must be a DisaggConfig"):
        ServingEngine(k.tp, k.cfg, ServingConfig(disagg=dict(DISAGG), prefill_buckets=(8,),
                                                 prefill_chunk=8, kv_page=PAGE), device="cpu")
    for knobs, match in ((dict(prefill_workers=0), "prefill_workers"),
                         (dict(min_prefill_tokens=9, max_prefill_tokens=8), "min_prefill"),
                         (dict(backlog_high=0), "backlog_high")):
        with pytest.raises(ValueError, match=match):
            DisaggConfig(**knobs).validate()
        with pytest.raises(ValueError, match=match):
            JDisaggConfig(**knobs).validate()
    from vtpu_torch.models import SSMConfig, init_ssm_params

    scfg = SSMConfig(vocab=64, d_model=32, n_layers=1, d_state=4, dtype=torch.float32)
    ssm = SsmSlotModel(init_ssm_params(0, scfg, device="cpu"), scfg, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(serving=ServingConfig(prefill_buckets=(8,), prefill_chunk=8, disagg=d),
                      model=ssm)
    for disagg in (DISAGG, None):
        eng = k.engine("port", disagg)
        try:
            with pytest.raises(ValueError, match="empty prompt"):
                eng.submit([], max_new_tokens=4)
        finally:
            eng.stop()


def test_disagg_refused_under_a_mesh():
    """disagg is served under a tensor-parallel mesh since the broadcast
    protocol's chunk and copy ops (tests/test_torch_tp_ops.py holds the
    reference's tp=2 case on a gloo world): under a hand-built mesh, which
    joined no world, the engine reaches the adapter's own mesh checks (the
    full tree is not one rank's shard) and, with a shard, the protocol's
    first broadcast, which needs a process group; no NotImplementedError
    names the field."""
    k = _kind("exact")
    mesh = TpMesh(rank=0, size=2, device=torch.device("cpu"))
    serving = ServingConfig(slots=2, prefill_buckets=(8,), prefill_chunk=8, kv_page=PAGE,
                            disagg=DisaggConfig(**DISAGG))
    with pytest.raises(ValueError, match="one rank's shard"):
        ServingEngine(k.tp, k.cfg, serving, device="cpu", mesh=mesh)
    with pytest.raises(RuntimeError, match="joined no process group"):
        ServingEngine(shard_params(k.tp, mesh), k.cfg, serving, mesh=mesh)


def test_disagg_chrome_trace_has_prefill_worker_lane():
    """The Chrome dump's prefill-worker lane: a named track with one slice
    per handed-off request, as the JAX engine's; the spans carry the TTFT
    split (queue wait + prefill exec <= ttft)."""
    k = _kind("exact")
    prompts = [_prompt(130 + i, 12) for i in range(2)]
    lanes = {}
    for side in ("jax", "port"):
        eng = k.engine(side, DISAGG)
        streams, _, _, _, rids = _serve(eng, prompts, 4)
        assert all(len(s) == 4 for s in streams)
        chrome, spans = eng.trace.chrome_trace(), eng.trace.spans()
        lane = [e for e in chrome["traceEvents"] if e.get("tid") == PREFILL_LANE_TID]
        assert any(e["ph"] == "M" and e["args"]["name"].startswith("prefill worker")
                   for e in lane)
        slices = [e for e in lane if e["ph"] == "X"]
        assert {e["args"]["rid"] for e in slices} == set(rids)
        for rid in rids:
            s = spans[rid]
            assert s["handoffs"] == 1
            assert s["prefill_start_ns"] is not None and s["pool_install_ns"] is not None
            assert s["queue_wait_ms"] + s["prefill_exec_ms"] <= s["ttft_ms"] + 1.0
        lanes[side] = sorted((e["ph"], e.get("name")) for e in lane)
    assert lanes["port"] == lanes["jax"]


def test_disagg_controller_matches_reference():
    """One backlog sequence through the port's controller and the
    reference's: the level, the share, the repartitions and which
    acquisitions the allowance grants, step for step."""
    cfg = dict(min_prefill_tokens=16, max_prefill_tokens=96, backlog_high=4, burst_ticks=2)
    port, ref = DisaggController(DisaggConfig(**cfg), 32), JDisaggController(
        JDisaggConfig(**cfg), 32)
    backlogs = [0, 1, 2, 3, 5, 9, 4, 3, 1, 0, 0, 6, 2, 1, 7, 0]
    never, stop = (lambda: False), (lambda: False)
    for i, b in enumerate(backlogs):
        port.on_tick(b)
        ref.on_tick(b)
        assert (port.level, port.prefill_share, port.repartitions) == (
            ref.level, ref.prefill_share, ref.repartitions), i
        # take what the allowance grants without blocking: 32 tokens while
        # it lasts (the bucket never blocks here: grant only if available)
        while port._allowance >= 32:
            assert ref._allowance >= 32
            assert port.acquire(32, never, stop) and ref.acquire(32, never, stop)
        assert port._allowance == ref._allowance
    assert port.repartitions == ref.repartitions > 0
    assert port.acquire(1 << 20, lambda: True, stop)  # the idle bypass
    assert not port.acquire(1 << 20, never, lambda: True)  # stop
