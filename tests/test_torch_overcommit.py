"""The port's KV overcommit (``kv_swap``: park/resume, eviction to the host
tier, recompute-on-fault) against vtpu's on the same weights (CPU, f32 and
int8 KV), in the reference's configuration (tests/test_kv_overcommit.py).

Held: a parked-then-resumed stream equals a never-parked run of the JAX
engine after every restore path (pages still resident, swapped to the host
tier and back, dropped and rebuilt through a bucketed or a chunked prefill,
rebuilt under the recompute crossover), on every loop the port serves on
one device (pipelined, synchronous, host sampler, multi-tick, speculating,
fused with a LoopPolicy), with the counters and the pool and host free
lists the reference asserts; a park on the pipelined and multi-tick loops
settles where the entry's length equals the device's; shared prefix blocks
are never evicted; cancels release everything; a park before admission
defers; an entry that can neither spill nor be rebuilt stays resident;
eviction goes by priority, then least recently parked; the staging pair
against the JAX gather and scatter (scale planes included); the lifecycle
spans against the JAX package's restore sequences; ``kv_swap=None`` stays
dormant; ``kv_swap`` without ``kv_page`` and under a mesh raise.

Parks land deterministically: the loop thread asks for each park inside
the delivery of a chosen token (``_park_at``), with budgets that leave the
stream running past it, or the white-box cases step ``_tick_head`` by hand
with no loop thread. The JAX engine is never parked (its park dance is
timing-bound under parallel workers); its never-parked streams are the
reference. No verdict hangs on a wall-clock threshold; a waiting loop only
guards against a hang. One torch thread."""

import queue
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.obs.trace import (
    DROP_RESTORE_SEQUENCE as J_DROP_SEQUENCE, SWAP_RESTORE_SEQUENCE as J_SWAP_SEQUENCE,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import (
    swap_page_gather as j_swap_page_gather, swap_page_scatter as j_swap_page_scatter,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.obs.trace import subsequence
from vtpu_torch.parallel import TpMesh, shard_params
from vtpu_torch.serving import ServingConfig, ServingEngine, Status, Terminal
from vtpu_torch.serving.adapters import swap_page_gather, swap_page_scatter
from vtpu_torch.serving.shed import AdaptiveLoopPolicy

# the reference test's model and serving shape
DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=32, head_dim=16)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
# a budget of 8 keeps every session's reservation at 2 pages (prompt 5-6 +
# 8 <= 16 tokens), so a 2-block pool holds one session and the second
# admission must evict the parked first
STEPS = 8
# every parked sequence is rebuildable: a small bucket and chunked prefill
BASE = dict(slots=2, prefill_buckets=(8,), max_new_tokens=STEPS, kv_page=PAGE, prefill_chunk=8)
# the budget of the cases on every loop: a fused flush may deliver up to
# k * (K + 1) = 12 tokens before a park settles, and 20 leaves the stream
# running past it (4 pages a session)
LONG = 20
LOOPS = {"pipelined": {}, "sync": dict(pipeline_decode=False), "host_sampler": {},
         "device_loop": dict(decode_loop_k=4), "spec": dict(spec_tokens=2),
         "fused_policy": dict(decode_loop_k=4, spec_tokens=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


P1, P2 = _prompt(1, 5), _prompt(2, 6)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, {kv: params_from_numpy(tree, CFGS[kv], device="cpu") for kv in CFGS}


@pytest.fixture(scope="module")
def refs(weights):
    """Never-parked JAX engine streams: {(kv, prompt index, budget): tokens}
    for P1 and P2 at budgets STEPS and LONG."""
    jp, _ = weights
    out = {}
    for kv in ("f32", "int8"):
        eng = JServingEngine(jp, JCFGS[kv], JServingConfig(**BASE))
        eng.start()
        try:
            for budget in (STEPS, LONG):
                for i, p in enumerate((P1, P2)):
                    out[kv, i, budget] = list(eng.submit(p, max_new_tokens=budget).stream())
        finally:
            eng.stop()
    return out


def _engine(weights, kv="f32", sample=None, **kw):
    return ServingEngine(weights[1][kv], CFGS[kv], ServingConfig(**{**BASE, **kw}),
                         device="cpu", sample=sample)


def _argmax(row):
    return int(np.argmax(row))


def _park_at(eng, req, n):
    """Ask for ``req``'s park from the loop thread, right after it puts the
    n-th token on the stream: the command is queued inside that delivery,
    so the park settles at the next tick head where the slot has no token
    in flight, whatever the host's speed."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if not isinstance(item, Terminal):
            seen[0] += 1
            if seen[0] == n:
                eng.park(req)

    req.out.put = hook


def _until(cond, what):
    """Wait for a state the loop thread reaches deterministically; the
    bound only turns a hang into a failure."""
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < 120, f"{what} never happened"
        time.sleep(0.002)


def _park_evict_resume(eng, budget=STEPS, park_at=1, prompts=(P1, P2)):
    """The canonical exercise: park the first prompt's session after its
    ``park_at``-th token, admit the second into a pool too small for both
    (the parked pages must be evicted), stream it, resume the first and
    stream it to its end. Returns (stream 1, stream 2, stats after stop)."""
    r1 = eng.submit(prompts[0], max_new_tokens=budget)
    _park_at(eng, r1, park_at)
    eng.start()
    try:
        _until(lambda: r1 in eng._parked, "the park")
        r2 = eng.submit(prompts[1], max_new_tokens=budget)
        got2 = list(r2.stream())
        eng.resume(r1)
        got1 = list(r1.stream())
    finally:
        eng.stop()
    assert eng.loop_error is None
    assert r1.status == r2.status == Status.OK
    # read after stop: the loop has finished every delivery's bookkeeping
    return got1, got2, eng.stats()


# ----------------------------------------------- park / resume lifecycles


def test_park_resume_resident_token_equal(weights, refs):
    """No pressure: the parked pages stay in the pool and resume remaps the
    table row. The stream equals the never-parked JAX run; no swap."""
    eng = _engine(weights, kv_swap=8)
    r1 = eng.submit(P1, max_new_tokens=STEPS)
    _park_at(eng, r1, 1)
    eng.start()
    try:
        _until(lambda: r1 in eng._parked, "the park")
        eng.resume(r1)
        got = list(r1.stream())
    finally:
        eng.stop()
    st = eng.stats()
    assert got == refs["f32", 0, STEPS]
    assert st["parks"] == 1 and st["resumes"] == 1
    assert st["evicted_blocks"] == 0 and st["swap_faults"] == 0
    assert st["swap_out_bytes"] == 0 and st["swap_in_bytes"] == 0
    assert st["kv_pool_free"] == st["kv_pool_blocks"]


def test_eviction_swap_in_token_equal(weights, refs):
    """A 2-block pool: admitting the second session evicts the parked first
    to the host tier instead of waiting; resume swaps it back. Both streams
    equal the JAX runs, the pool and the host tier end free, and the swap
    adds no fetch to the tick path (one fetch a tick)."""
    eng = _engine(weights, kv_pool_blocks=2, kv_swap=8)
    got1, got2, st = _park_evict_resume(eng)
    assert got1 == refs["f32", 0, STEPS] and got2 == refs["f32", 1, STEPS]
    assert st["parks"] == 1 and st["resumes"] == 1
    assert st["evicted_blocks"] == 2
    bpb = eng._block_bytes
    assert bpb == 2 * DIMS["n_layers"] * PAGE * DIMS["n_heads"] * DIMS["head_dim"] * 4
    assert st["swap_out_bytes"] == st["swap_in_bytes"] == 2 * bpb
    assert st["swap_faults"] == 1 and st["fault_recomputes"] == 0
    assert st["pool_blocked_admissions"] == 0
    assert st["kv_pool_free"] == st["kv_pool_blocks"] == 2
    assert st["kv_pool_used_hwm"] == 2
    assert st["swap_host_free"] == st["swap_host_blocks"] == 8
    assert st["device_gets_per_tick"] == 1.0


@pytest.mark.parametrize("park_at", [1, 5], ids=["bucketed", "chunked"])
def test_recompute_on_fault_equals_swap_in(weights, refs, park_at):
    """kv_swap=0: eviction drops the pages and resume rebuilds them through
    prefill, one [1, 8] dispatch for a sequence the bucket covers, or
    [1, 8] chunks past it (a park after the 5th token leaves 10-11 cached
    tokens): the streams equal the swap-in run's and the JAX runs."""
    swap = _park_evict_resume(_engine(weights, kv_pool_blocks=2, kv_swap=8), park_at=park_at)
    drop = _park_evict_resume(_engine(weights, kv_pool_blocks=2, kv_swap=0), park_at=park_at)
    assert swap[:2] == drop[:2] == (refs["f32", 0, STEPS], refs["f32", 1, STEPS])
    st = drop[2]
    assert st["fault_recomputes"] == 1 and st["swap_faults"] == 1
    assert st["swap_out_bytes"] == 0 and st["swap_in_bytes"] == 0
    assert st["evicted_blocks"] == 2
    assert st["prefill_chunks"] == (0 if park_at == 1 else 2)
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert st["swap_host_blocks"] == st["swap_host_free"] == 0


def test_crossover_prefers_recompute_over_swap_in(weights, refs):
    """kv_swap_recompute_tokens at max_seq: resume rebuilds although the
    host pages exist, and returns them unread."""
    eng = _engine(weights, kv_pool_blocks=2, kv_swap=8,
                  kv_swap_recompute_tokens=DIMS["max_seq"])
    got1, got2, st = _park_evict_resume(eng)
    assert got1 == refs["f32", 0, STEPS] and got2 == refs["f32", 1, STEPS]
    assert st["fault_recomputes"] == 1
    assert st["swap_out_bytes"] == 2 * eng._block_bytes  # the eviction still spilled
    assert st["swap_in_bytes"] == 0
    assert st["swap_host_free"] == st["swap_host_blocks"]
    assert st["kv_pool_free"] == st["kv_pool_blocks"]


@pytest.mark.parametrize("arm", ["swap", "recompute"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_overcommit_on_every_loop(weights, refs, loop, arm):
    """Park, evict and resume on each loop the port serves on one device,
    at a budget of LONG tokens (4 pages a session, a 4-block pool): the
    streams equal the never-parked JAX runs, one park and one resume, the
    four evicted blocks swap out and in (or are rebuilt), the pool and the
    host tier end free."""
    kw = dict(LOOPS[loop], kv_pool_blocks=4, kv_swap=8 if arm == "swap" else 0,
              max_new_tokens=LONG)
    if loop == "fused_policy":
        kw["loop_policy"] = AdaptiveLoopPolicy()
    eng = _engine(weights, sample=_argmax if loop == "host_sampler" else None, **kw)
    got1, got2, st = _park_evict_resume(eng, budget=LONG)
    assert got1 == refs["f32", 0, LONG] and got2 == refs["f32", 1, LONG]
    assert st["parks"] == 1 and st["resumes"] == 1 and st["evicted_blocks"] == 4
    if arm == "swap":
        assert st["swap_out_bytes"] == st["swap_in_bytes"] == 4 * eng._block_bytes
        assert st["fault_recomputes"] == 0
    else:
        assert st["swap_out_bytes"] == st["swap_in_bytes"] == 0
        assert st["fault_recomputes"] == 1
    assert st["swap_faults"] == 1 and st["pool_blocked_admissions"] == 0
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert st["swap_host_free"] == st["swap_host_blocks"]
    if loop == "fused_policy":
        assert st["fused_flushes"] > 0


@pytest.mark.parametrize("loop", ["pipelined", "device_loop", "fused"])
def test_park_settles_at_the_flush_boundary(weights, refs, loop):
    """A park on the pipelined loop (a tick in flight), the multi-tick loop
    (a flush in flight) and the fused loop (a variable advance a flush):
    the slot is left out of the next dispatch, its in-flight tokens land,
    and the park settles where the entry's length equals the device's
    length for the slot, with exactly one delivered token whose KV is not
    yet written. The resumed stream equals the never-parked JAX run."""
    kw = {"pipelined": {}, "device_loop": dict(decode_loop_k=4),
          "fused": dict(decode_loop_k=4, spec_tokens=2)}[loop]
    eng = _engine(weights, kv_swap=16, max_new_tokens=LONG, **kw)
    seen = {}
    do_park = eng._do_park

    def watched(slot):
        seen["host"] = eng._slot_len[slot]
        seen["device"] = int(eng.state["len"][slot])
        seen["history"] = len(eng._history[slot])
        do_park(slot)

    eng._do_park = watched
    r = eng.submit(P1, max_new_tokens=LONG)
    _park_at(eng, r, 2)
    eng.start()
    try:
        _until(lambda: r in eng._parked, "the park")
        entry = eng._parked[r]
        eng.resume(r)
        got = list(r.stream())
    finally:
        eng.stop()
    assert seen["host"] == seen["device"] == entry["seq_len"] == len(entry["tokens"])
    assert seen["history"] == entry["seq_len"] + 1
    assert 2 <= entry["seq_len"] - len(P1) + 1 < LONG  # parked mid-stream
    assert got == refs["f32", 0, LONG]
    st = eng.stats()
    assert st["parks"] == 1 and st["resumes"] == 1


def test_int8_swap_round_trip(weights, refs):
    """int8 KV: the spill and the restore carry the int8 planes and their
    f32 scale planes (a block's bytes count both); the resumed stream is
    the never-parked port run's and the JAX int8 engine's."""
    eng = _engine(weights, kv="int8", kv_pool_blocks=2, kv_swap=8)
    got1, got2, st = _park_evict_resume(eng)
    plain = _engine(weights, kv="int8")
    plain.start()
    try:
        want = [list(plain.submit(p, max_new_tokens=STEPS).stream()) for p in (P1, P2)]
    finally:
        plain.stop()
    assert [got1, got2] == want == [refs["int8", 0, STEPS], refs["int8", 1, STEPS]]
    per = DIMS["n_layers"] * PAGE * DIMS["n_heads"]
    assert eng._block_bytes == 2 * per * DIMS["head_dim"] + 2 * per * 4
    assert set(eng._host_pool) == {"k", "v", "k_scale", "v_scale"}
    assert st["swap_out_bytes"] == st["swap_in_bytes"] == 2 * eng._block_bytes
    assert st["swap_faults"] == 1 and st["evicted_blocks"] == 2
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert st["swap_host_free"] == st["swap_host_blocks"]


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_staging_pair_against_jax(kv):
    """``swap_page_gather`` / ``swap_page_scatter`` against the JAX staging
    pair on one random pool: the gather is the JAX snapshot block-major,
    every plane (scale planes included); the scatter writes in place and
    equals the JAX scatter, padded ids (0) writing zero pages into the
    null block."""
    rs = np.random.RandomState(3)
    L, nb, h, dh = 2, 9, DIMS["n_heads"], DIMS["head_dim"]
    if kv == "int8":
        planes = {"k": rs.randint(-127, 128, (L, nb, PAGE, h, dh)).astype(np.int8),
                  "v": rs.randint(-127, 128, (L, nb, PAGE, h, dh)).astype(np.int8),
                  "k_scale": rs.rand(L, nb, PAGE, h).astype(np.float32),
                  "v_scale": rs.rand(L, nb, PAGE, h).astype(np.float32)}
    else:
        planes = {k: rs.randn(L, nb, PAGE, h, dh).astype(np.float32) for k in ("k", "v")}
    jstate = {k: jnp.asarray(x) for k, x in planes.items()}
    jstate["table"] = jnp.zeros((2, 4), jnp.int32)
    state = {k: torch.from_numpy(x.copy()) for k, x in planes.items()}
    state["table"] = torch.zeros((2, 4), dtype=torch.int32)
    ids = np.array([5, 2, 7, 0], np.int32)  # one padded id
    model = types.SimpleNamespace(mesh=None)
    jsnap = j_swap_page_gather(model)(jstate, jnp.asarray(ids))
    snap = swap_page_gather(state, torch.from_numpy(ids).long())
    assert set(snap) == set(planes)
    for key, x in snap.items():
        assert x.is_contiguous() and x.shape[0] == len(ids)
        np.testing.assert_array_equal(x.numpy(), np.swapaxes(np.asarray(jsnap[key]), 0, 1))
    # scatter the snapshot rolled by one block, the padded column zeroed
    dst = np.array([3, 6, 1, 0], np.int32)
    pages = {k: np.roll(np.asarray(jsnap[k]), 1, axis=1) for k in jsnap}
    for k in pages:
        pages[k][:, 3] = 0
    jout = j_swap_page_scatter(model)(jstate, jnp.asarray(dst), {k: jnp.asarray(x)
                                                                  for k, x in pages.items()})
    ptrs = {k: x.data_ptr() for k, x in state.items()}
    out = swap_page_scatter(state, torch.from_numpy(dst).long(),
                            {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))
                             for k, x in pages.items()})
    assert out is state and {k: x.data_ptr() for k, x in state.items()} == ptrs
    for key in planes:
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(jout[key]))
        assert not state[key][:, 0].numpy().any()  # the null block took the zero pad


# ------------------------------------------------- eviction policy limits


def test_prefix_shared_blocks_never_evicted(weights):
    """White-box: a parked prefixed session keeps its shared prefix blocks
    (refcount 2: the registry and the session) across an eviction of its
    private pages; a cancel while parked releases the shares and the host
    pages."""
    eng = _engine(weights, kv_swap=8, async_admission=False)
    pid = eng.register_prefix(list(range(1, 17)))  # two full pages, no boundary copy
    req = eng.submit([7, 8], max_new_tokens=4, prefix=pid)
    eng._tick_head()  # reserve; the suffix admits in chunks
    while eng._admitting:
        eng._advance_admissions(float("inf"))
    slot = eng._slot_req.index(req)
    shared = list(eng._slot_blocks[slot][:eng._slot_shared[slot]])
    assert len(shared) == 2 and all(eng._alloc.refcount(b) == 2 for b in shared)
    eng.park(req)
    eng._tick_head()
    entry = eng._parked[req]
    assert entry["shared"] == shared and len(entry["priv"]) >= 1
    n_priv = len(entry["priv"])
    eng._reclaim(eng._alloc.n_blocks)
    assert entry["priv"] == [] and entry["host"] is not None
    assert all(eng._alloc.refcount(b) == 2 for b in shared)
    assert eng._stats["evicted_blocks"] == n_priv
    req.cancel()
    eng._tick_head()
    assert req not in eng._parked and req.status == Status.CANCELLED
    assert all(eng._alloc.refcount(b) == 1 for b in shared)  # the registry's hold
    assert len(eng._host_free) == eng._swap_host_blocks
    eng.stop()


def _park_one(eng, seed, **kw):
    """White-box: submit, admit serially (the first token is delivered in
    the tick head), park at the next tick head; returns the entry."""
    req = eng.submit(_prompt(seed, 5), max_new_tokens=STEPS, **kw)
    eng._tick_head()
    eng.park(req)
    eng._tick_head()
    return eng._parked[req]


def _ended_cancelled(req):
    items = []
    while True:
        try:
            items.append(req.out.get_nowait())
        except queue.Empty:
            break
    return (bool(items) and isinstance(items[-1], Terminal)
            and items[-1].status == req.status == Status.CANCELLED)


def test_cancel_mid_swap_and_racing_resume_release_all(weights):
    """White-box cancels: (a) while the eviction's swap-out is still
    pending; (b) between resume() and the restore. Both end the stream
    CANCELLED and return every pool block and host block."""
    eng = _engine(weights, kv_swap=8, async_admission=False)
    usable = eng._n_blocks - 1
    e = _park_one(eng, 50)
    eng._evict_entry(e)
    assert e in eng._swap_pending
    e["req"].cancel()
    eng._tick_head()
    assert e["req"] not in eng._parked and not eng._swap_pending
    assert _ended_cancelled(e["req"])
    assert eng._alloc.free_blocks == usable
    assert len(eng._host_free) == eng._swap_host_blocks
    e = _park_one(eng, 51)
    eng._evict_entry(e)
    eng.resume(e["req"])
    e["req"].cancel()
    eng._tick_head()
    assert e["req"] not in eng._parked and not eng._want_resume
    assert _ended_cancelled(e["req"])
    assert eng._alloc.free_blocks == usable
    assert len(eng._host_free) == eng._swap_host_blocks
    eng.stop()


def test_park_before_admission_defers_and_resumes(weights):
    """Parking a request still in the waiting line defers it with no
    pages; resume puts it back in line and it admits normally."""
    eng = _engine(weights, slots=1, kv_swap=8, async_admission=False)
    eng.submit(_prompt(60, 5), max_new_tokens=4)
    r2 = eng.submit(_prompt(61, 5), max_new_tokens=4)
    eng._tick_head()  # r1 takes the only slot; r2 waits
    eng.park(r2)
    eng._tick_head()
    assert r2 in eng._parked and eng._parked[r2].get("unstarted")
    assert r2 not in eng._waiting
    eng.resume(r2)
    eng._retire(0)  # free the slot for the re-queued r2
    eng._tick_head()
    assert eng._slot_req[0] is r2
    assert eng.stats()["parks"] == eng.stats()["resumes"] == 1
    eng.stop()


def test_unrecomputable_entry_never_dropped_and_resident_resume(weights):
    """White-box: (a) once earlier spills fill the host tier, a later
    parked entry that cannot be rebuilt stays in the pool, never dropped;
    (b) resuming it under a crossover that would choose a rebuild takes the
    resident remap: nothing is reallocated, rebuilt or leaked."""
    eng = ServingEngine(weights[1]["f32"], CFGS["f32"], ServingConfig(
        slots=2, prefill_buckets=(8,), max_new_tokens=8, kv_page=PAGE, kv_swap=2,
        async_admission=False, kv_swap_recompute_tokens=32), device="cpu")
    usable = eng._n_blocks - 1
    e1 = _park_one(eng, 90)
    e2 = _park_one(eng, 91)
    e2["recompute_ok"] = False  # as a park past every bucket without chunking is
    eng._reclaim(usable + 1)
    assert e1["priv"] == [] and e1["host"] is not None and not e1["dropped"]
    assert len(e2["priv"]) == 2 and not e2["dropped"]
    free_before = eng._alloc.free_blocks
    eng.resume(e2["req"])
    eng._tick_head()
    slot = eng._slot_req.index(e2["req"])
    assert eng._slot_blocks[slot] and eng._alloc.free_blocks == free_before
    assert eng._stats["fault_recomputes"] == 0 and eng._stats["resumes"] == 1
    eng.stop()


def test_eviction_order_is_priority_then_lru(weights):
    """White-box QoS: eviction takes the lowest Request.priority first and
    the least recently parked within a priority: a priority-9 session
    outlives priority-0 ones, and the older priority-0 park goes first."""
    eng = _engine(weights, kv_swap=16, async_admission=False)
    hi = _park_one(eng, 95, priority=9)  # parked first, but high QoS
    lo_old = _park_one(eng, 96, priority=0)
    lo_new = _park_one(eng, 97, priority=0)
    assert hi["req"].priority == 9
    eng._reclaim(eng._alloc.free_blocks + 1)
    assert lo_old["priv"] == [] and lo_new["priv"] and hi["priv"]
    eng._reclaim(eng._alloc.free_blocks + 1)
    assert lo_new["priv"] == [] and hi["priv"]
    eng.stop()


# ------------------------------------------------- trace, dormant, mesh


def test_lifecycle_spans_follow_the_reference_sequences(weights):
    """Two sessions parked in turn (the first at its 1st token, the second
    at its 4th, so the park order, the LRU axis, is fixed), a second wave
    evicts them: the first spills into the one-session host tier, the
    second finds it full and drops. Their trace events hold the JAX
    package's swap-in and drop restore sequences (park -> evict ->
    swap_out -> resume -> swap_in; park -> evict -> resume ->
    fault_recompute), never the other path's, and their spans carry the
    park, the parked time and the resume latency."""
    eng = _engine(weights, kv_pool_blocks=4, kv_swap=2)
    wave1 = [eng.submit(p, max_new_tokens=STEPS) for p in (P1, P2)]
    _park_at(eng, wave1[0], 1)
    _park_at(eng, wave1[1], 4)
    eng.start()
    try:
        _until(lambda: all(r in eng._parked for r in wave1), "both parks")
        assert list(eng._parked) == wave1
        wave2 = [eng.submit(p, max_new_tokens=STEPS) for p in (_prompt(910, 5), _prompt(911, 6))]
        for r in wave2:
            list(r.stream())
        for r in wave1:
            eng.resume(r)
            list(r.stream())
    finally:
        eng.stop()
    st = eng.stats()
    assert st["swap_out_bytes"] == st["swap_in_bytes"] == 2 * eng._block_bytes
    assert st["fault_recomputes"] == 1 and st["evicted_blocks"] == 4
    by_rid = {}
    for e in eng.trace.events():
        by_rid.setdefault(e["rid"], []).append(e["event"])
    swapped, dropped = (by_rid[r.rid] for r in wave1)
    assert subsequence(J_SWAP_SEQUENCE, swapped) and subsequence(J_DROP_SEQUENCE, dropped)
    assert "swap_in" not in dropped and "fault_recompute" not in swapped
    spans = eng.trace.spans()
    for r in wave1:
        s = spans[r.rid]
        assert s["parks"] == 1 and s["parked_ms"] > 0
        assert len(s["resume_latency_ms"]) == 1 and s["evicted_blocks"] == 2
        assert s["terminal"] == "OK" and s["tokens"] == STEPS
    assert spans[wave1[0].rid]["swap_out_bytes"] == 2 * eng._block_bytes
    assert spans[wave1[1].rid]["fault_recomputes"] == 1


def test_kv_swap_none_dormant_and_api_refusal(weights):
    """kv_swap=None: the overcommit counters exist and stay zero and
    park/resume refuse; kv_swap without a paged pool is refused."""
    eng = _engine(weights)
    st = eng.stats()
    for key in ("parks", "resumes", "evicted_blocks", "swap_out_bytes", "swap_in_bytes",
                "swap_faults", "fault_recomputes", "pool_blocked_resumes"):
        assert st[key] == 0
    assert st["kv_swap"] is None and st["parked_sessions"] == 0
    assert st["swap_host_blocks"] is None and st["swap_host_free"] is None
    assert eng.signals().parked_sessions == 0
    req = eng.submit(_prompt(70, 4), max_new_tokens=2)
    with pytest.raises(ValueError, match="kv_swap"):
        eng.park(req)
    with pytest.raises(ValueError, match="kv_swap"):
        eng.resume(req)
    eng.stop()
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(weights[1]["f32"], CFGS["f32"],
                      ServingConfig(slots=2, prefill_buckets=(8,), kv_swap=4), device="cpu")


def test_kv_swap_under_a_mesh_raises(weights):
    """Every kv_swap field is served under mesh= since the broadcast
    protocol's swap ops (tests/test_torch_tp_ops.py holds the reference's
    tp=2 eviction round trip on a gloo world): under a hand-built mesh,
    which joined no world, each passes and the engine raises only at the
    adapter's own checks (the full tree is not one rank's shard) or, with
    a shard, at the first broadcast, which needs a process group."""
    mesh = TpMesh(rank=0, size=2, device=torch.device("cpu"))
    for kw in (dict(kv_swap=4), dict(kv_swap_stage_blocks=2),
               dict(kv_swap_recompute_tokens=16)):
        with pytest.raises(ValueError, match="one rank's shard"):
            ServingEngine(weights[1]["f32"], CFGS["f32"], ServingConfig(**BASE, **kw),
                          mesh=mesh)
        with pytest.raises(RuntimeError, match="joined no process group"):
            ServingEngine(shard_params(weights[1]["f32"], mesh), CFGS["f32"],
                          ServingConfig(**BASE, **kw), mesh=mesh)
