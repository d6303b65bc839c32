"""The port's chunked prefill against vtpu's on the same weights (CPU, f32
and int8 KV).

Held, at tests/test_serving.py's tolerances: ``chunked_prefill_into_slot``
leaves the JAX function's cache planes over the prompt (rtol 1e-4, atol
1e-5; int8 codes within one, as tests/test_torch_int8.py states) and its
last logits (1e-4), on a dense cache and through explicit paged
``block_ids`` (a slot's row, and the prefix build's slot sentinel whose
length write is dropped); ``pad_to_chunks``; prompts past the largest
bucket streaming the JAX chunked engine's tokens on both loops with the
neighbour untouched; the "must divide" and "max_context" refusals; chunks
and decode ticks interleaving by call order; ``prefill_budget`` shared by
chunks and bucketed admissions; no chunk reaching a paged kernel (T > 16
raises at the wrapper); and every state tensor kept in place (its
``data_ptr``) across chunked and prefixed admissions. No case holds a
wall-clock threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import (
    init_kv_cache as j_init_kv_cache,
    init_paged_kv_cache as j_init_paged_kv_cache,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.engine import (
    chunked_prefill_into_slot as j_chunked_prefill_into_slot,
    pad_to_chunks as j_pad_to_chunks,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig, init_kv_cache, init_paged_kv_cache
from vtpu_torch.ops import paged_decode_attention, paged_decode_attention_int8kv
from vtpu_torch.parallel import TpMesh, shard_params
from vtpu_torch.serving import ServingConfig, ServingEngine, Status
from vtpu_torch.serving.engine import chunked_prefill_into_slot, pad_to_chunks

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
CHUNK = 8
PAGE = 8
LAYOUTS = {"dense": {}, "paged": {"kv_page": PAGE, "kv_pool_blocks": 10}}
NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The reference's params (one set serves both KV types) and the port's
    copy per KV type."""
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, {kv: params_from_numpy(tree, CFGS[kv], device="cpu") for kv in CFGS}


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).astype(np.int32)


def _assert_planes(got, want, index, kv):
    """Cache planes at ``index``: f32 at rtol 1e-4 / atol 1e-5; int8 codes
    within one (at most 1 in 256 off) and scales within rtol 1e-5, since XLA's
    and PyTorch's matmuls may put a K/V value on either side of a
    quantization boundary."""
    for key in ("k", "v"):
        a, b = np.asarray(got[key])[index], np.asarray(want[key])[index]
        if kv == "f32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
            continue
        off = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert off.max() <= 1 and off.sum() <= max(1, a.size // 256), (key, off.sum())
        np.testing.assert_allclose(np.asarray(got[f"{key}_scale"])[index],
                                   np.asarray(want[f"{key}_scale"])[index], rtol=1e-5)


# ------------------------------------------------------------ functions


@pytest.mark.parametrize("n,c", [(21, 8), (16, 8), (1, 8), (5, 16)])
def test_pad_to_chunks_matches_jax(n, c):
    tokens = _prompt(n, n)
    got = pad_to_chunks(tokens, n, c)
    want = np.asarray(j_pad_to_chunks(jnp.asarray(tokens), n, c))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _bucket(need):
    return next(b for b in (8, 16, 32) if b >= need)


@pytest.mark.parametrize("kv", list(CFGS))
@pytest.mark.parametrize("layout", ["dense", "paged", "paged_sentinel"])
def test_chunked_prefill_into_slot_matches_jax(weights, layout, kv):
    """A 21-token prompt in three chunks of 8 into slot 1 of 3 (each chunk's
    read window the smallest bucket covering it, as the engine picks it):
    the port's cache planes over the prompt, its length and the prompt's
    last logits equal the JAX function's. ``paged`` gathers through the
    slot's block row; ``paged_sentinel`` passes the slot count as the slot,
    as a prefix build does, and no length moves."""
    jp, tps = weights
    n, slots = 21, 3
    padded = pad_to_chunks(_prompt(9, n), n, CHUNK)
    pad = padded.shape[1]
    blocks = [5, 2, 7, 3]  # out of order, so a wrong gather shows
    slot = slots if layout == "paged_sentinel" else 1
    if layout == "dense":
        jcache = j_init_kv_cache(JCFGS[kv], slots)
        cache = init_kv_cache(CFGS[kv], slots, device="cpu")
    else:
        jcache = j_init_paged_kv_cache(JCFGS[kv], slots, PAGE, 9)
        cache = init_paged_kv_cache(CFGS[kv], slots, PAGE, 9, device="cpu")
    before = {key: x.clone() for key, x in cache.items()}
    for off in range(0, pad, CHUNK):
        bucket = _bucket(off + CHUNK)
        ids = None
        if layout != "dense":
            ids = np.zeros((bucket // PAGE,), np.int32)
            m = min(len(blocks), ids.shape[0])
            ids[:m] = blocks[:m]
        new_len = min(off + CHUNK, n)
        jlogits, jcache = j_chunked_prefill_into_slot(
            jp, JCFGS[kv], jcache, jnp.asarray(padded[:, off:off + CHUNK].numpy()),
            jnp.int32(slot), jnp.int32(off), jnp.int32(new_len), kv_bucket=bucket,
            block_ids=None if ids is None else jnp.asarray(ids))
        logits, cache = chunked_prefill_into_slot(
            tps[kv], CFGS[kv], cache, padded[:, off:off + CHUNK], slot, off, new_len,
            kv_bucket=bucket, block_ids=None if ids is None else torch.from_numpy(ids))
    row = (n - 1) - (pad - CHUNK)
    np.testing.assert_allclose(logits[0, row].numpy(), np.asarray(jlogits[0, row]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache["len"].numpy(), np.asarray(jcache["len"]))
    if layout == "dense":
        assert int(cache["len"][1]) == n
        _assert_planes(cache, jcache, (slice(None), 1, slice(0, n)), kv)
    else:
        # the prompt's n positions, page by page through the block row
        for p, blk in enumerate(blocks[:-(-n // PAGE)]):
            rows = slice(0, min(PAGE, n - p * PAGE))
            _assert_planes(cache, jcache, (slice(None), blk, rows), kv)
        if layout == "paged_sentinel":
            assert torch.equal(cache["len"], before["len"])
    # nothing outside the slot's row or blocks (and the null block) moved
    untouched = ({0, 2} if layout == "dense" else
                 set(range(1, 9)) - set(blocks))
    for key in ("k", "v"):
        for i in untouched:
            assert torch.equal(cache[key][:, i], before[key][:, i]), (key, i)


def test_paged_kernel_wrappers_refuse_long_chunks():
    """The paged kernels take T <= 16 queries a row: a longer chunk raises at
    the wrapper on every device, before any plain version or launch."""
    q = torch.zeros((1, 17, 2, 32))
    pool = torch.zeros((1, 3, PAGE, 2, 32))
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.full((1, 17), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="T=17"):
        paged_decode_attention(q, pool, pool, table, lens)
    scales = torch.ones((1, 3, PAGE, 2))
    with pytest.raises(ValueError, match="T=17"):
        paged_decode_attention_int8kv(q, pool.to(torch.int8), scales, pool.to(torch.int8),
                                      scales, table, lens)


# --------------------------------------------------------------- engine


def _serving(layout, cls=ServingConfig, **kw):
    return cls(slots=2, prefill_buckets=(16,), max_new_tokens=NEW, prefill_chunk=CHUNK,
               **{**LAYOUTS[layout], **kw})


def _run(engine, prompts, budgets=None):
    """Submit every prompt before start() (admission follows the ticks, not
    the submitting thread), stream each to its end; (streams, requests,
    stats after stop)."""
    budgets = budgets or [0] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    engine.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        engine.stop()
    assert getattr(engine, "loop_error", None) is None
    return outs, reqs, engine.stats()


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_long_prompts_stream_like_the_jax_chunked_engine(weights, layout, pipeline):
    """Prompts of 29 and 20 tokens (past the 16 bucket: 4 and 3 chunks)
    beside bucketed ones: the port streams the JAX chunked engine's tokens
    on both loops, the short neighbour streams what it streams alone, and
    the pool returns to free."""
    jp, tps = weights
    prompts = [_prompt(11, 29), _prompt(12, 9), _prompt(13, 20), _prompt(14, 5)]
    outs, reqs, st = _run(ServingEngine(tps["f32"], CFGS["f32"],
                                        _serving(layout, pipeline_decode=pipeline),
                                        device="cpu"), prompts)
    jouts, _, jst = _run(JServingEngine(jp, JCFGS["f32"], _serving(layout, JServingConfig)),
                         [p.tolist() for p in prompts])
    solo, _, _ = _run(ServingEngine(tps["f32"], CFGS["f32"], _serving(layout), device="cpu"),
                      [prompts[1]])
    assert outs == jouts and outs[1] == solo[0]
    # the 29-token prompt's budget stops at the context wall
    assert [len(o) for o in outs] == [min(NEW, DIMS["max_seq"] - len(p)) for p in prompts]
    assert [r.status for r in reqs] == [Status.OK] * len(prompts)
    assert st["prefill_chunks"] == jst["prefill_chunks"] == 4 + 3
    assert st["admissions"] == len(prompts) and st["admitting_slots"] == 0
    assert st["device_gets_per_tick"] == 1.0
    if layout == "paged":
        assert st["kv_pool_free"] == st["kv_pool_blocks"]


def test_chunked_config_validation(weights):
    _, tps = weights
    tp, cfg = tps["f32"], CFGS["f32"]
    with pytest.raises(ValueError, match="must divide"):
        ServingEngine(tp, cfg, ServingConfig(prefill_buckets=(16,), prefill_chunk=24),
                      device="cpu")
    with pytest.raises(ValueError, match="prefill chunk 16"):
        ServingEngine(tp, cfg, ServingConfig(prefill_buckets=(8,), prefill_chunk=16,
                                             prefill_budget=8), device="cpu")
    # served under a mesh since the broadcast protocol's chunk op: a
    # hand-built mesh reaches the adapter's own checks (the full tree is not
    # one rank's shard) and, with a shard, the first broadcast, which needs
    # a process group
    mesh = TpMesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="one rank's shard"):
        ServingEngine(tp, cfg, _serving("dense"), device="cpu", mesh=mesh)
    with pytest.raises(RuntimeError, match="joined no process group"):
        ServingEngine(shard_params(tp, mesh), cfg, _serving("dense"), mesh=mesh)
    eng = ServingEngine(tp, cfg, _serving("dense"), device="cpu")
    try:
        with pytest.raises(ValueError, match="max_context"):
            eng.submit(list(range(1, DIMS["max_seq"] + 2)))
        eng.submit(list(range(1, DIMS["max_seq"] + 1)))  # exactly max_context admits
    finally:
        eng.stop()
    # chunking off: past the largest bucket raises, without a chunked cap
    eng = ServingEngine(tp, cfg, ServingConfig(prefill_buckets=(16,)), device="cpu")
    with pytest.raises(ValueError, match="largest usable bucket 16$"):
        eng.submit(list(range(1, 18)))
    eng.stop()


def _record(engine, events: list, budget_of=None):
    """Wrap the engine's chunk and decode dispatches (and batched admission)
    to log their call order."""
    chunk, step, admit = engine._prefill_chunk, engine._step, engine._admit_step

    def rec_chunk(*a, **k):
        events.append(("chunk", a[2].shape[1]))
        return chunk(*a, **k)

    def rec_step(*a, **k):
        events.append(("decode", 0))
        return step(*a, **k)

    def rec_admit(params, state, buf, tokens, *rest):
        events.append(("admit", tokens.shape[0] * tokens.shape[1]))
        return admit(params, state, buf, tokens, *rest)

    engine._prefill_chunk, engine._step, engine._admit_step = rec_chunk, rec_step, rec_admit


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
def test_chunks_interleave_with_decode_by_call_order(weights, pipeline):
    """While a 26-token prompt admits in 4 chunks, the live slot decodes
    between them: no two chunk dispatches are adjacent."""
    _, tps = weights
    eng = ServingEngine(tps["f32"], CFGS["f32"], _serving("paged", pipeline_decode=pipeline),
                        device="cpu")
    events: list = []
    _record(eng, events)
    outs, _, st = _run(eng, [_prompt(31, 5), _prompt(32, 26)], budgets=[20, 4])
    assert [len(o) for o in outs] == [20, 4]
    kinds = [e for e, _ in events]
    assert kinds.count("chunk") == 4 == st["prefill_chunks"]
    first = kinds.index("chunk")
    assert "decode" in kinds[:first]  # the live slot decodes before the long prompt admits
    assert all(not (a == b == "chunk") for a, b in zip(kinds, kinds[1:])), kinds


def test_prefill_budget_is_shared_by_chunks_and_buckets(weights):
    """prefill_budget of 16 prompt tokens a tick while a slot decodes: the
    5- and 12-token prompts admit in one batch before anything decodes; the
    26-token prompt's 4 chunks of 8 and the 9-token prompt's bucket of 16
    then share the budget, so the prompt tokens dispatched between two
    decode ticks never pass 16; the streams equal the JAX engine's under
    the same budget."""
    jp, tps = weights
    prompts = [_prompt(41, 5), _prompt(42, 26), _prompt(43, 12), _prompt(44, 9)]
    budgets = [12, 0, 0, 0]
    eng = ServingEngine(tps["f32"], CFGS["f32"], _serving("dense", prefill_budget=16),
                        device="cpu")
    events: list = []
    _record(eng, events)
    outs, _, st = _run(eng, prompts, budgets)
    jouts, _, _ = _run(JServingEngine(jp, JCFGS["f32"], _serving(
        "dense", JServingConfig, prefill_budget=16)), [p.tolist() for p in prompts], budgets)
    assert outs == jouts
    assert st["prefill_batch_hist"][2] == 1 and st["prefill_chunks"] == 4
    first = events.index(("decode", 0))
    assert events[:first] == [("admit", 2 * 16)]
    spent, between = 0, []
    for kind, tokens in events[first:]:
        if kind == "decode":
            between.append(spent)
            spent = 0
        else:
            spent += tokens
    assert max(between) <= 16 and sum(between) + spent == 4 * CHUNK + 16


@pytest.mark.parametrize("kv", list(CFGS))
def test_no_chunk_reaches_the_paged_kernel(weights, kv):
    """paged_attn="kernel" (on the CPU its plain version) with a 32-token
    chunk, twice the kernels' T limit: the chunk attends over its dense view,
    the decode ticks go through the kernel route, and the stream equals the
    gather route's."""
    _, tps = weights
    prompt = _prompt(51, 25)
    got = {}
    for route in ("kernel", "gather"):
        serving = ServingConfig(slots=2, prefill_buckets=(16,), max_new_tokens=NEW,
                                prefill_chunk=32, kv_page=PAGE, paged_attn=route)
        outs, reqs, st = _run(ServingEngine(tps[kv], CFGS[kv], serving, device="cpu"), [prompt])
        assert reqs[0].status == Status.OK and st["prefill_chunks"] == 1
        assert st[f"paged_attn_{route}_ticks"] == st["decode_ticks"] > 0
        got[route] = outs
    assert got["kernel"] == got["gather"]


def _ptrs(state):
    return {key: (x.data_ptr(), tuple(x.shape)) for key, x in state.items()}


@pytest.mark.parametrize("kv", list(CFGS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_state_tensors_stay_in_place(weights, layout, kv):
    """A chunked admission, a prefix registration (a pool build on the paged
    layout) and prefixed admissions write the state in place: every state
    tensor keeps its address, as the decode graphs on the card need."""
    _, tps = weights
    eng = ServingEngine(tps[kv], CFGS[kv], _serving(layout), device="cpu")
    before = _ptrs(eng.state)
    pid = eng.register_prefix(_prompt(61, 11))
    reqs = [eng.submit(_prompt(62, 22)), eng.submit(_prompt(63, 3), prefix=pid),
            eng.submit([], prefix=pid)]
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert [len(o) for o in outs] == [NEW] * 3
    st = eng.stats()
    assert st["prefill_chunks"] == 3 + 1 and st["prefix_hits"] == 2
    assert _ptrs(eng.state) == before
