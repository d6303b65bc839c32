"""vtpu_torch.serving against vtpu on the same weights (CPU, f32): host
types, the stale-table write drop, the engine's streams against the
reference's greedy decode, the refusal of unported options, the default
device, and the package's import hygiene."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import greedy_generate as j_greedy_generate
from vtpu.serving.engine import (
    batched_decode_step as j_batched_decode_step,
    prefill_into_slot as j_prefill_into_slot,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig, init_params
from vtpu_torch.serving import (
    BlockAllocator, ServingConfig, ServingEngine, Status, WaitQueue,
)
from vtpu_torch.serving.engine import batched_decode_step, prefill_into_slot

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
PROMPT_LENS = (5, 11, 16, 3, 9)
NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    # keeps these tests from crowding the timing-sensitive suites beside them
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_numpy(tree, CFG, device="cpu")


@pytest.fixture(scope="module")
def prompts_and_refs(weights):
    jp, _ = weights
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 64, (n,)).astype(np.int32) for n in PROMPT_LENS]
    refs = [np.asarray(j_greedy_generate(jp, JCFG, jnp.asarray(p[None]), NEW))[0].tolist()
            for p in prompts]
    return prompts, refs


# ------------------------------------------------------------ host types


def test_block_allocator_contract():
    a = BlockAllocator(5)
    assert a.free_blocks == 4
    got = a.alloc(3)
    assert 0 not in got and len(set(got)) == 3  # the null block is never handed out
    assert a.alloc(2) is None and a.free_blocks == 1  # all-or-nothing
    a.share(got[:1])
    a.release(got)
    assert a.refcount(got[0]) == 1 and a.free_blocks == 3  # shared block survives
    a.release(got[:1])
    assert a.free_blocks == 4 and a.used_hwm == 3
    assert a.alloc(1) == [got[0]]  # LIFO: the last freed block comes back first
    with pytest.raises(RuntimeError, match="double free"):
        a.release([got[1]])
    with pytest.raises(RuntimeError, match="dead block"):
        a.share([got[1]])
    with pytest.raises(ValueError):
        BlockAllocator(1)


def test_wait_queue_contract():
    q = WaitQueue()
    reqs = [object() for _ in range(4)]
    for r in reqs:
        q.append(r)
    assert len(q) == 4 and q.head() is reqs[0]
    q.remove(reqs[1])
    assert reqs[1] not in q and list(q) == [reqs[0], reqs[2], reqs[3]]
    assert q.take(reqs[2]) and not q.take(reqs[2])
    q.append(reqs[1])  # remove-then-append leaves a stale copy: iterated once
    assert list(q) == [reqs[0], reqs[1], reqs[3]]
    assert q.popleft() is reqs[0] and q.head() is reqs[1]
    q.clear()
    assert len(q) == 0 and q.head() is None


# -------------------------------------------------- dropped paged writes


def test_stale_table_and_context_wall_writes_are_dropped(weights):
    """Slot 0 retired with a stale table row naming block 3, which the
    allocator has since handed to slot 1; slot 2 sits at the context wall.
    A decode tick must write only slot 1's token: block 3 keeps everything
    else, and the pool equals the reference's (which drops by index)."""
    jp, tp = weights
    rng = np.random.RandomState(1)
    shape = (2, 9, 8, 2, 32)
    k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    table = np.asarray([[3, 0, 0, 0], [3, 4, 0, 0], [5, 6, 7, 8]], np.int32)
    lens = np.asarray([2, 5, 32], np.int32)
    active = np.asarray([False, True, True])
    tokens = np.asarray([7, 9, 11], np.int32)
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(lens),
              "table": jnp.asarray(table)}
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "len": torch.from_numpy(lens), "table": torch.from_numpy(table)}
    jl, jc = j_batched_decode_step(jp, JCFG, jcache, jnp.asarray(tokens), jnp.asarray(active))
    tl, tc = batched_decode_step(tp, CFG, tcache, torch.from_numpy(tokens),
                                 torch.from_numpy(active))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=1e-5)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]), atol=1e-4)
    changed = np.argwhere((tc["k"].numpy() != k).any(axis=(3, 4)))
    # only slot 1's write landed: (layer, block 3, offset 5) in each layer
    assert sorted(map(tuple, changed.tolist())) == [(0, 3, 5), (1, 3, 5)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_into_slot_matches_jax(weights, layout):
    """One right-padded [1, bucket] prompt installed into slot 1: the
    first-token logits and the slot's cache rows (paged: its mapped blocks)
    equal the reference's."""
    jp, tp = weights
    rng = np.random.RandomState(2)
    n, bucket = 11, 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = rng.randint(1, 64, (n,))
    if layout == "dense":
        k = np.zeros((2, 2, 32, 2, 32), np.float32)
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(k), "len": jnp.zeros((2,), jnp.int32)}
        tcache = {"k": torch.zeros(k.shape), "v": torch.zeros(k.shape),
                  "len": torch.zeros((2,), dtype=torch.int32)}
    else:
        k = np.zeros((2, 9, 8, 2, 32), np.float32)
        table = np.asarray([[0, 0, 0, 0], [4, 2, 0, 0]], np.int32)
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(k), "len": jnp.zeros((2,), jnp.int32),
                  "table": jnp.asarray(table)}
        tcache = {"k": torch.zeros(k.shape), "v": torch.zeros(k.shape),
                  "len": torch.zeros((2,), dtype=torch.int32),
                  "table": torch.from_numpy(table)}
    jl, jc = j_prefill_into_slot(jp, JCFG, jcache, jnp.asarray(padded), 1, n)
    tl, tc = prefill_into_slot(tp, CFG, tcache, torch.from_numpy(padded), 1, n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc["len"].numpy(), [0, n])
    rows = (slice(None), [4, 2]) if layout == "paged" else (slice(None), 1)
    np.testing.assert_allclose(tc["k"].numpy()[rows], np.asarray(jc["k"])[rows], atol=1e-5)
    np.testing.assert_allclose(tc["v"].numpy()[rows], np.asarray(jc["v"])[rows], atol=1e-5)


# ---------------------------------------------------------------- engine


def _serve(tp, prompts, **kw):
    eng = ServingEngine(tp, CFG, ServingConfig(
        slots=2, prefill_buckets=(8, 16), max_new_tokens=NEW, **kw), device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(p) for p in prompts]
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert eng.loop_error is None
    return eng, reqs, outs


@pytest.mark.parametrize("layout", ["dense", "dense_budget", "paged", "paged_kernel_route"])
def test_engine_streams_match_jax_greedy(weights, prompts_and_refs, layout):
    """Five prompts over two slots (queueing, batched and single admission,
    slot reuse), streamed and held token-equal to the reference's greedy
    decode on the same weights, with one fetch per tick and, paged, a pool
    fully free after stop(). The forced kernel route runs the paged
    kernel's plain version on the CPU."""
    _, tp = weights
    prompts, refs = prompts_and_refs
    kw = {"kv_page": 8, "kv_pool_blocks": 6} if layout.startswith("paged") else {}
    if layout == "paged_kernel_route":
        kw["paged_attn"] = "kernel"
    if layout == "dense_budget":
        kw["prefill_budget"] = 16  # one bucket of prompt tokens per tick while decoding
    eng, reqs, outs = _serve(tp, prompts, **kw)
    assert outs == refs
    assert [r.status for r in reqs] == [Status.OK] * len(prompts)
    st = eng.stats()
    assert st["device_gets_per_tick"] == 1.0
    assert st["admissions"] == len(prompts)
    assert st["generated_tokens"] == NEW * len(prompts)
    if not layout.startswith("paged"):
        assert st["kv_pool_blocks"] is None
        return
    assert st["kv_pool_free"] == st["kv_pool_blocks"] == 6
    kernel = layout == "paged_kernel_route"
    assert st["paged_attn_kernel_ticks" if kernel else "paged_attn_gather_ticks"] \
        == st["decode_ticks"]
    assert st["paged_attn_gather_ticks" if kernel else "paged_attn_kernel_ticks"] == 0
    assert st["kv_pool_used_hwm"] <= 6


def test_engine_pool_backpressure(weights, prompts_and_refs):
    """Two slots but a pool that holds one request's pages: the second
    request waits for the first to release its blocks (backpressure, never
    an error) and both streams stay exact."""
    _, tp = weights
    prompts, refs = prompts_and_refs
    eng = ServingEngine(tp, CFG, ServingConfig(
        slots=2, prefill_buckets=(8,), max_new_tokens=NEW, kv_page=8, kv_pool_blocks=3),
        device="cpu")
    reqs = [eng.submit(prompts[0]), eng.submit(prompts[3])]  # both need 2 blocks
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert outs == [refs[0], refs[3]]
    st = eng.stats()
    assert st["pool_blocked_admissions"] >= 1
    assert st["kv_pool_used_hwm"] == 2 and st["kv_pool_free"] == 3


def test_engine_sampling_is_seeded_per_slot(weights, prompts_and_refs):
    """temperature/top-k sampling draws from per-slot generators seeded by
    sampling_seed: the same seed gives the same streams, another seed other
    streams, and every token stays inside the vocabulary."""
    _, tp = weights
    prompts, _ = prompts_and_refs

    def run(seed):
        # submitted before start(): both admit in one batch on the first
        # tick, so the per-slot streams (which advance every tick, active
        # or not, as in the reference) see the same draws on every run
        eng = ServingEngine(tp, CFG, ServingConfig(
            slots=2, prefill_buckets=(8, 16), max_new_tokens=NEW, temperature=0.9,
            top_k=8, sampling_seed=seed), device="cpu")
        reqs = [eng.submit(p) for p in (prompts[0], prompts[3])]  # one bucket
        eng.start()
        try:
            outs = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
        assert [r.status for r in reqs] == [Status.OK] * 2
        assert eng.stats()["prefill_batch_hist"][2] == 1
        return outs

    first = run(3)
    assert run(3) == first
    assert run(4) != first
    assert all(0 <= tok < CFG.vocab and len(out) == NEW for out in first for tok in out)


def test_engine_cancel_and_stop_release_everything(weights):
    _, tp = weights
    eng = ServingEngine(tp, CFG, ServingConfig(
        slots=1, prefill_buckets=(8,), max_new_tokens=20, kv_page=8), device="cpu")
    eng.start()
    try:
        first = eng.submit(np.arange(1, 6))
        queued = eng.submit(np.arange(2, 7))
        next(first.stream())
        first.cancel()
        list(first.stream())
        assert first.status == Status.CANCELLED
        assert len(list(queued.stream())) == 20 and queued.status == Status.OK
    finally:
        eng.stop()
    st = eng.stats()
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2])


@pytest.mark.parametrize("field,value", [
    ("spec_tokens", 2), ("prefill_chunk", 8), ("logprobs", True), ("kv_swap", 4),
    ("decode_loop_k", 4), ("shed_queue_depth", 3), ("fetch_watchdog_ms", 5.0),
    ("pipeline_decode", True), ("async_admission", False)])
def test_unported_serving_fields_raise(weights, field, value):
    _, tp = weights
    if field == "pipeline_decode":
        # ported since the pipelined-loop slice: an explicit True is served
        # (tests/test_torch_pipeline.py holds the loop itself)
        eng = ServingEngine(tp, CFG, ServingConfig(prefill_buckets=(8,), **{field: value}),
                            device="cpu")
        assert eng.stats()["pipelined"] is True
        return
    with pytest.raises(NotImplementedError, match=field):
        ServingEngine(tp, CFG, ServingConfig(**{field: value}), device="cpu")


def test_unported_model_options_raise(weights):
    _, tp = weights
    # kv_int8=True is ported; "auto" (the reference's TPU-measured router) is not
    cfg8 = ModelConfig(**DIMS, dtype=torch.float32, kv_int8="auto")
    with pytest.raises(NotImplementedError, match="kv_int8"):
        ServingEngine(tp, cfg8, ServingConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="sample="):
        ServingEngine(tp, CFG, ServingConfig(), device="cpu", sample=lambda row: 0)


def test_default_device_is_cuda_and_never_falls_back(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    _, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tp, CFG, ServingConfig(slots=1, prefill_buckets=(8,)))


def test_package_imports_neither_jax_nor_vtpu():
    code = (
        "import pkgutil, sys, importlib, vtpu_torch\n"
        "for m in pkgutil.walk_packages(vtpu_torch.__path__, 'vtpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'vtpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('vtpu_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12  # every submodule was imported
