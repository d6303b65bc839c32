"""The port's shared prefixes (``register_prefix``, ``submit(prefix=)``,
``unregister_prefix``) against vtpu's on the same weights (CPU, f32 and
int8 KV).

Held: a prefixed stream equals the full prompt's and the JAX engine's, on
a dense cache and a paged pool; an empty suffix takes its first token from
the prefix's stored logits; the refusals; a paged prefix is mapped into
slots with no copy (shared full pages, one copy-on-write boundary page),
with the allocator's refcounts equal to the JAX engine's at every step;
two concurrent suffixes stay isolated; unregister frees blocks only at
refcount zero, and a request whose prefix went away before admission ends
FAULTED while the loop keeps serving; the chunk recipe of a prefix build
matches a monolithic prefill (planes, last logits, teacher-forced decode);
an int8 prefix round-trips. No case holds a wall-clock threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import init_kv_cache as j_init_kv_cache
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.engine import (
    chunked_prefill_into_slot as j_chunked_prefill_into_slot,
    pad_to_chunks as j_pad_to_chunks,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig, decode_step, init_kv_cache, prefill
from vtpu_torch.serving import ServingConfig, ServingEngine, Status
from vtpu_torch.serving.engine import chunked_prefill_into_slot, pad_to_chunks

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
LAYOUTS = {"dense": {}, "paged": {"kv_page": PAGE}}
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
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, {kv: params_from_numpy(tree, CFGS[kv], device="cpu") for kv in CFGS}


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


def _serving(layout, cls=ServingConfig, **kw):
    return cls(**{**dict(slots=2, prefill_buckets=(8,), max_new_tokens=NEW, prefill_chunk=8),
                  **LAYOUTS[layout], **kw})


def _engines(weights, layout, kv="f32", **kw):
    jp, tps = weights
    return (ServingEngine(tps[kv], CFGS[kv], _serving(layout, **kw), device="cpu"),
            JServingEngine(jp, JCFGS[kv], _serving(layout, JServingConfig, **kw)))


def _serve(eng, pre, suffixes, full=None):
    """Start, register ``pre``, stream each suffix (all submitted at once),
    then optionally the ``full`` prompt unprefixed; stop. Returns (prefixed
    streams, full stream, stats before stop, requests)."""
    eng.start()
    try:
        pid = eng.register_prefix(pre)
        reqs = [eng.submit(s, prefix=pid) for s in suffixes]
        outs = [list(r.stream()) for r in reqs]
        got_full = list(eng.submit(full).stream()) if full is not None else None
        st = eng.stats()
    finally:
        eng.stop()
    assert getattr(eng, "loop_error", None) is None
    return outs, got_full, st, reqs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_stream_equals_full_prompt_and_jax(weights, layout):
    """An off-grid 20-token prefix (20 % 8 != 0) and a 6-token suffix, twice
    (the registration is reusable): both streams equal the full prompt's
    through the same engine and the JAX engine's prefixed streams."""
    pre, suf = _prompt(1, 20), _prompt(2, 6)
    port, jeng = _engines(weights, layout)
    outs, full, st, reqs = _serve(port, pre, [suf, suf], full=pre + suf)
    jouts, jfull, jst, _ = _serve(jeng, pre, [suf, suf], full=pre + suf)
    assert outs == jouts == [full, full] and full == jfull
    assert len(full) == NEW and all(r.status == Status.OK for r in reqs)
    for key in ("prefix_hits", "prefix_install_copies", "prefix_blocks_shared",
                "prefix_cow_copies", "prefill_chunks", "registered_prefixes"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] == 2


def test_empty_suffix_and_validation(weights):
    pre = [5, 6, 7, 8] * 4
    port, jeng = _engines(weights, "dense", slots=1, max_new_tokens=4)
    got = {}
    for name, eng in (("port", port), ("jax", jeng)):
        eng.start()
        try:
            pid = eng.register_prefix(pre)
            # empty suffix: the first token comes from the prefix's logits
            got[name] = list(eng.submit([], max_new_tokens=4, prefix=pid).stream())
            with pytest.raises(ValueError, match="unknown prefix"):
                eng.submit([1], prefix=999)
            with pytest.raises(ValueError, match="exceeds"):
                eng.submit(list(range(1, DIMS["max_seq"])), prefix=pid)
            with pytest.raises(ValueError, match="no room"):
                eng.register_prefix(list(range(1, DIMS["max_seq"])))
            with pytest.raises(ValueError, match="empty prompt requires a prefix"):
                eng.submit([])
        finally:
            eng.stop()
    assert got["port"] == got["jax"] and len(got["port"]) == 4
    eng = ServingEngine(weights[1]["f32"], CFGS["f32"], ServingConfig(
        slots=1, prefill_buckets=(8,)), device="cpu")
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        eng.register_prefix([1, 2, 3])
    eng.mesh = object()  # what a tensor-parallel engine holds
    # served under a mesh since the broadcast protocol's chunk op: the same
    # check as on one device, no refusal of its own
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        eng.register_prefix([1, 2, 3])
    eng.mesh = None
    eng.stop()


def _refcounts(eng):
    return [eng._alloc.refcount(b) for b in range(eng._n_blocks)]


def test_shared_blocks_and_cow_refcounts_equal_jax(weights):
    """A 10-token prefix (one full page and a partial one) under a 3-token
    suffix, driven tick head by tick head with no loop thread: after the
    registration, the reservation (the full page shared, the boundary page
    copied into a private block), each chunk, the retire and the
    unregister, every block's refcount equals the JAX engine's; no dense
    install copy; the pool ends fully free."""
    pre, suf = [5, 6, 7, 8, 9, 5, 6, 7, 8, 9], [1, 2, 3]
    engines = _engines(weights, "paged")
    trail = {}
    for eng in engines:
        counts = []
        pid = eng.register_prefix(pre)  # no loop yet: builds inline
        counts.append(_refcounts(eng))
        req = eng.submit(suf, prefix=pid)
        eng._tick_head()  # reserve + park the suffix's one chunk
        counts.append(_refcounts(eng))
        slot = next(s for s in eng._admitting)
        eng._tick_head()  # the chunk, then the first token on the device
        counts.append(_refcounts(eng))
        assert eng._slot_req[slot] is req
        shared = [b for b in eng._slot_blocks[slot] if eng._alloc.refcount(b) == 2]
        eng._retire(slot)
        counts.append(_refcounts(eng))
        eng.unregister_prefix(pid)
        counts.append(_refcounts(eng))
        st = eng.stats()
        eng.stop()
        assert len(shared) == 1 and st["prefix_blocks_shared"] == 1
        assert st["prefix_cow_copies"] == 1 and st["prefix_install_copies"] == 0
        assert st["kv_pool_free"] == st["kv_pool_blocks"]
        trail[type(eng).__module__.split(".")[0]] = counts
    assert trail["vtpu_torch"] == trail["vtpu"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_concurrent_suffixes_stay_isolated(weights, layout):
    """Two suffixes share an unaligned prefix at once: each suffix's writes
    land in its own boundary copy (paged) or slot (dense), so both streams
    equal their solo runs and the JAX engine's."""
    pre = ([3, 9, 4] * 4)[:10]
    sa, sb = [1, 2, 3, 4], [11, 12, 13, 14]
    port, jeng = _engines(weights, layout)
    together, _, st, _ = _serve(port, pre, [sa, sb])
    jtogether, _, _, _ = _serve(jeng, pre, [sa, sb])
    solo = [_serve(_engines(weights, layout)[0], pre, [s])[0][0] for s in (sa, sb)]
    assert together == solo == jtogether
    if layout == "paged":
        assert st["prefix_cow_copies"] == 2


def test_unregister_frees_at_refcount_zero_and_raced_submit_faults(weights):
    """White-box, no loop thread: a live prefixed slot keeps the shared
    blocks across unregister_prefix, which free when the slot retires. Then
    a request submitted while its prefix was registered and admitted after
    unregister ends FAULTED with an empty stream, its reservation released;
    the loop keeps serving a fresh registration."""
    _, tps = weights
    eng = ServingEngine(tps["f32"], CFGS["f32"], _serving("paged", max_new_tokens=4),
                        device="cpu")
    pre = list(range(1, 17))  # 16 tokens: two full pages, no boundary copy
    pid = eng.register_prefix(pre)
    usable = eng._n_blocks - 1
    assert eng._alloc.free_blocks == usable - 2
    req = eng.submit([], max_new_tokens=4, prefix=pid)
    eng._tick_head()  # reserve + admit (empty suffix: no chunk)
    slot = eng._slot_req.index(req)
    shared = [b for b in eng._slot_blocks[slot] if eng._alloc.refcount(b) == 2]
    assert len(shared) == 2 and eng.stats()["prefix_shared_blocks"] == 2
    eng.unregister_prefix(pid)
    assert all(eng._alloc.refcount(b) == 1 for b in shared)
    eng._retire(slot)
    assert all(eng._alloc.refcount(b) == 0 for b in shared)
    assert eng._alloc.free_blocks == usable
    # the raced submit
    pid = eng.register_prefix(pre)
    raced = eng.submit([5, 6], max_new_tokens=4, prefix=pid)
    eng.unregister_prefix(pid)
    assert eng._prefixes == {}
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.unregister_prefix(pid)
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.submit([1], prefix=pid)
    eng.start()
    try:
        assert list(raced.stream()) == [] and raced.status == Status.FAULTED
        pid2 = eng.register_prefix(pre)  # on the loop thread now
        again = eng.submit([5, 6], max_new_tokens=4, prefix=pid2)
        assert len(list(again.stream())) == 4 and again.status == Status.OK
        eng.unregister_prefix(pid2)
    finally:
        eng.stop()
    st = eng.stats()
    assert st["prefix_misses"] == 1 and st["faulted_requests"] == 1
    assert st["kv_pool_free"] == st["kv_pool_blocks"] == usable
    assert eng.loop_error is None


# tests/test_paged_kv.py's model for the recipe check: one layer, so the
# planes compare at quantization scale (a second layer's KV would carry the
# first layer's attention over already-quantized keys: the reference itself
# then differs from its own monolithic prefill by ~3e-2 on these inputs)
RECIPE_DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=32,
                   head_dim=16)


def _chunked_like_register(params, cfg, tokens, c, buckets):
    """The prefix build's chunk recipe as plain functions: pad to the chunk
    grid, [1, C] chunks with the engine's read windows (the smallest bucket
    covering off + C), last logits from the padded tail's true row."""
    n = len(tokens)
    padded = pad_to_chunks(tokens, n, c)
    pad = padded.shape[1]
    cache = init_kv_cache(cfg, 1, device="cpu")
    logits = None
    for off in range(0, pad, c):
        bkt = next((b for b in buckets if b >= off + c), cfg.max_seq)
        logits, cache = chunked_prefill_into_slot(params, cfg, cache, padded[:, off:off + c], 0,
                                                  off, min(off + c, n), kv_bucket=bkt)
    return logits[0, (n - 1) - (pad - c)], cache


def _j_chunked_like_register(params, cfg, tokens, c, buckets):
    n = len(tokens)
    padded = j_pad_to_chunks(jnp.asarray(tokens, jnp.int32), n, c)
    pad = padded.shape[1]
    cache = j_init_kv_cache(cfg, 1)
    for off in range(0, pad, c):
        bkt = next((b for b in buckets if b >= off + c), cfg.max_seq)
        logits, cache = j_chunked_prefill_into_slot(
            params, cfg, cache, padded[:, off:off + c], jnp.int32(0), jnp.int32(off),
            jnp.int32(min(off + c, n)), kv_bucket=bkt)
    return logits[0, (n - 1) - (pad - c)], cache


@pytest.mark.parametrize("kv", list(CFGS))
def test_chunked_prefix_prefill_matches_monolithic(kv):
    """tests/test_paged_kv.py's case on its model and tokens: the chunk
    recipe over an off-grid 13-token prefix equals the JAX recipe (planes
    at atol 1e-5, int8 codes within one; last logits at 1e-4), and matches
    one monolithic prefill at that test's tolerances: the KV planes
    (dequantized for int8), the last logits and a teacher-forced decode
    over both caches (int8: the chunks attend over already-quantized KV,
    the monolithic prefill over exact values)."""
    jcfg = JModelConfig(**RECIPE_DIMS, dtype=jnp.float32, use_pallas=False,
                        kv_int8=kv == "int8")
    cfg = ModelConfig(**RECIPE_DIMS, dtype=torch.float32, kv_int8=kv == "int8")
    jp = j_init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp),
                               cfg, device="cpu")
    tokens = [int(t) for t in jax.random.randint(jax.random.key(77), (13,), 1, 64, jnp.int32)]
    n = len(tokens)
    last, cache = _chunked_like_register(params, cfg, tokens, 8, (8, 16, 32))
    jlast, jcache = _j_chunked_like_register(jp, jcfg, tokens, 8, (8, 16, 32))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-4, atol=1e-4)
    for plane in ("k", "v"):
        a, b = cache[plane][:, 0, :n].numpy(), np.asarray(jcache[plane])[:, 0, :n]
        if kv == "int8":
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, plane
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    ref_logits, ref = prefill(params, cfg, torch.tensor([tokens], dtype=torch.int32))
    for plane in ("k", "v"):
        if kv == "int8":
            got = cache[plane][:, 0, :n].float() * cache[f"{plane}_scale"][:, 0, :n, :, None]
            want = ref[plane][:, 0, :n].float() * ref[f"{plane}_scale"][:, 0, :n, :, None]
            torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
        else:
            torch.testing.assert_close(cache[plane][:, 0, :n], ref[plane][:, 0, :n],
                                       atol=1e-5, rtol=0)
    tol = 5e-2 if kv == "int8" else 1e-3
    torch.testing.assert_close(last, ref_logits[0, n - 1], atol=tol, rtol=0)
    a, b = dict(cache), dict(ref)
    a["len"] = torch.full((1,), n, dtype=torch.int32)
    b["len"] = torch.full((1,), n, dtype=torch.int32)
    for t in jax.random.randint(jax.random.key(78), (4,), 1, 64, jnp.int32).tolist():
        la, a = decode_step(params, cfg, a, torch.tensor([t], dtype=torch.int32))
        lb, b = decode_step(params, cfg, b, torch.tensor([t], dtype=torch.int32))
        torch.testing.assert_close(la, lb, atol=tol, rtol=0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_int8_prefix_round_trip(weights, layout):
    """int8 KV: the quantized planes and scales of a registered prefix serve
    a suffix whose stream equals the full prompt's through the same engine
    and the JAX int8 engine's prefixed stream."""
    pre, suf = [5, 6, 7, 8, 9] * 2, [1, 2, 3]  # off-grid: 10 % 8 != 0
    port, jeng = _engines(weights, layout, kv="int8")
    outs, full, st, _ = _serve(port, pre, [suf], full=pre + suf)
    jouts, _, _, _ = _serve(jeng, pre, [suf])
    assert outs == jouts == [full]
    assert st["prefix_install_copies"] == (1 if layout == "dense" else 0)
