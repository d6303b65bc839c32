"""The port's MoE family (vtpu_torch/models/moe.py, ``MoeSlotModel``) against
vtpu's on the same weights (CPU, f32; int8 KV where named).

Held: ``route`` (dispatch exactly, combine at 1e-6) with ample capacity,
with drops (``capacity_factor=0.5``) and with pads masked out; ``moe_ffn``,
``moe_forward``, ``moe_prefill`` (logits and cache, with and without
``true_len``), ``moe_decode_ffn`` through the decode trunk and the chunk
trunk, each at 1e-4; the port analogues of tests/test_moe.py's gates (drop
semantics, no-drop mass, right padding, the true_len mask, int8 KV); the
router f32 in a bf16 model; and the engine: ``ServingEngine(model=
MoeSlotModel(...))`` streams equal to the JAX engine's on the same
ServingConfig on every loop (synchronous, pipelined, multi-tick,
speculating, fused), dense and paged, int8, chunked with a prefix, and
under KV overcommit against the JAX engine's never-parked streams; the
port analogues of the reference's MoE serving gates (the prefill-path
composition, isolation from retired slots, speculation, k-tick loops,
paged against dense, kernel route against gather); the refusals. One torch
thread, no wall-clock threshold."""

import dataclasses
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models.moe import (
    MoEConfig as JMoEConfig, init_moe_params as j_init_moe_params, moe_decode_ffn as j_moe_decode_ffn,
    moe_ffn as j_moe_ffn, moe_forward as j_moe_forward, moe_prefill as j_moe_prefill, route as j_route,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import MoeSlotModel as JMoeSlotModel
from vtpu.serving.engine import (
    Terminal as JTerminal,
    batched_decode_step as j_batched_decode_step,
    chunked_prefill_into_slot as j_chunked_prefill_into_slot,
)
from vtpu_torch.convert import moe_params_from_numpy
from vtpu_torch.models import (
    MoEConfig, decode_layer_loop, init_kv_cache, init_moe_params, moe_forward, store_kv,
)
from vtpu_torch.models.moe import moe_decode_ffn, moe_ffn, moe_prefill, route
from vtpu_torch.parallel import TpMesh, shard_moe_params
from vtpu_torch.serving import ServingConfig, ServingEngine, Status, Terminal
from vtpu_torch.serving.adapters import MoeSlotModel
from vtpu_torch.serving.engine import batched_decode_step, chunked_prefill_into_slot

DIMS = dict(vocab=96, d_model=64, n_heads=2, n_layers=2, d_ff=64, n_experts=4, top_k=2,
            max_seq=32, head_dim=32)
JCFGS = {kv: JMoEConfig(**DIMS, dtype=jnp.float32, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: MoEConfig(**DIMS, dtype=torch.float32, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
NEW = 6
ATOL = 1e-4
STREAM_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(jp):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def weights():
    """The reference's params as JAX arrays and carried over (one set
    serves both KV types)."""
    jp = j_init_moe_params(jax.random.key(5), JCFGS["f32"])
    return jp, moe_params_from_numpy(_tree(jp), CFGS["f32"], device="cpu")


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


PROMPTS = [_prompt(21, 5), _prompt(22, 9), _prompt(23, 13)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=atol, atol=atol)


# ------------------------------------------------------------------ route


ROUTE_CASES = {
    # capacity = the token count: nothing can drop
    "ample": dict(capacity_factor=2.0, pad=False, cap=32),
    # tests/test_moe.py:27's tight factor: drops happen
    "drop": dict(capacity_factor=0.5, pad=False, cap=None),
    # pads masked out of routing under the tight factor
    "pad_mask": dict(capacity_factor=0.5, pad=True, cap=None),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_reference(case):
    """Dispatch equal exactly, combine and aux at 1e-6, the drop and pad
    semantics of tests/test_moe.py:27 and :42 on both sides."""
    c = ROUTE_CASES[case]
    t, d, e = 32, 16, 4
    jcfg = JMoEConfig(d_model=d, n_experts=e, top_k=2, capacity_factor=c["capacity_factor"])
    cfg = MoEConfig(d_model=d, n_experts=e, top_k=2, capacity_factor=c["capacity_factor"])
    cap = c["cap"] or cfg.capacity(t)
    assert cap == (c["cap"] or jcfg.capacity(t))
    rs = np.random.RandomState(3)
    x = rs.randn(t, d).astype(np.float32)
    w = rs.randn(d, e).astype(np.float32)
    mask = (np.arange(t) % 5 != 3) if c["pad"] else None
    jd, jc, ja = j_route(jnp.asarray(w), jnp.asarray(x), jcfg, cap,
                         pad_mask=None if mask is None else jnp.asarray(mask))
    pd, pc, pa = route(torch.from_numpy(w), torch.from_numpy(x), cfg, cap,
                       pad_mask=None if mask is None else torch.from_numpy(mask))
    assert pd.shape == (t, e, cap)
    np.testing.assert_array_equal(_np(pd), np.asarray(jd))
    _close(pc, jc, 1e-6)
    _close(pa, ja, 1e-6)
    # each (expert, slot) holds at most one token; a token's mass is <= 1
    assert float(pd.sum(dim=0).max()) <= 1.0
    assert float(pc.sum(dim=(1, 2)).max()) <= 1.0 + 1e-6
    kept = float(pd.sum())
    if case == "ample":
        np.testing.assert_allclose(_np(pc.sum(dim=(1, 2))), 1.0, atol=1e-5)
        assert kept == t * cfg.top_k
    else:
        real = t if mask is None else int(mask.sum())
        assert kept < real * cfg.top_k  # the tight capacity dropped choices
    if mask is not None:
        assert float(pd[torch.from_numpy(~mask)].sum()) == 0.0  # pads claim no slot


@pytest.mark.parametrize("mode", ["formula", "override", "pad_mask"])
def test_moe_ffn_matches_reference(weights, mode):
    jp, tp = weights
    rs = np.random.RandomState(4)
    x = rs.randn(2, 12, DIMS["d_model"]).astype(np.float32)
    mask = np.arange(12)[None, :] < np.array([[12], [7]])
    kw = {"formula": {}, "override": {"capacity": 24}}.get(mode, {})
    jlp = {k: v[1] for k, v in jp["layers"].items()}
    tlp = {k: v[1] for k, v in tp["layers"].items()}
    jout, jaux = j_moe_ffn(jlp, jnp.asarray(x), JCFGS["f32"],
                           pad_mask=jnp.asarray(mask) if mode == "pad_mask" else None, **kw)
    out, aux = moe_ffn(tlp, torch.from_numpy(x), CFGS["f32"],
                       pad_mask=torch.from_numpy(mask) if mode == "pad_mask" else None, **kw)
    _close(out, jout)
    _close(aux, jaux)


def test_moe_forward_matches_reference(weights):
    """Logits and aux against moe_forward; finite, aux > 0 (tests/test_moe.py:58)."""
    jp, tp = weights
    tokens = np.random.RandomState(1).randint(0, DIMS["vocab"], (2, 16)).astype(np.int32)
    jl, ja = j_moe_forward(jp, JCFGS["f32"], jnp.asarray(tokens))
    logits, aux = moe_forward(tp, CFGS["f32"], torch.from_numpy(tokens).long())
    assert logits.shape == (2, 16, DIMS["vocab"]) and bool(torch.isfinite(logits).all())
    assert float(aux) > 0.0
    _close(logits, jl)
    _close(aux, ja)


@pytest.mark.parametrize("true_len", [None, "scalar", "rows"])
def test_moe_prefill_matches_reference(weights, true_len):
    """Logits and every cache plane, without true_len (capacity = all
    tokens), with one length and with one a row."""
    jp, tp = weights
    tokens = np.random.RandomState(2).randint(0, DIMS["vocab"], (2, 16)).astype(np.int32)
    tl = {None: None, "scalar": 11, "rows": np.array([16, 9], np.int32)}[true_len]
    jl, jc = j_moe_prefill(jp, JCFGS["f32"], jnp.asarray(tokens),
                           true_len=None if tl is None else jnp.asarray(tl))
    logits, cache = moe_prefill(tp, CFGS["f32"], torch.from_numpy(tokens).long(),
                                true_len=None if tl is None else torch.as_tensor(tl))
    _close(logits, jl)
    for key in ("k", "v"):
        _close(cache[key][:, :, :16], jc[key][:, :, :16])
    np.testing.assert_array_equal(_np(cache["len"]), np.asarray(jc["len"]))
    if tl is not None:  # logits_at gathers the rows the engine reads
        at = torch.as_tensor(np.broadcast_to(np.asarray(tl), (2,)) - 1).long()
        rows, _ = moe_prefill(tp, CFGS["f32"], torch.from_numpy(tokens).long(),
                              true_len=torch.as_tensor(tl), logits_at=at)
        _close(rows, logits[torch.arange(2), at])


def test_moe_prefill_right_padding_and_true_len():
    """tests/test_moe.py:111 and :139 on the port, each against the JAX
    prefill: padding past the prompt changes no real token's logits, with
    capacity = all tokens (cf 0.5) and with pads masked out under the cf
    formula (two bucket sizes, and the exact no-drop forward)."""
    for cf in (0.5, 2.0):
        jcfg = JMoEConfig(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, n_experts=4,
                          top_k=2, capacity_factor=cf, max_seq=64, head_dim=16,
                          dtype=jnp.float32)
        cfg = MoEConfig(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, n_experts=4,
                        top_k=2, capacity_factor=cf, max_seq=64, head_dim=16,
                        dtype=torch.float32)
        jp = j_init_moe_params(jax.random.key(0), jcfg)
        tp = moe_params_from_numpy(_tree(jp), cfg, device="cpu")
        true = np.random.RandomState(0).randint(0, 128, (1, 12)).astype(np.int32)
        pads = {s: np.concatenate([true, np.zeros((1, s - 12), np.int32)], axis=1)
                for s in (32, 48)}
        exact, cache_exact = moe_prefill(tp, cfg, torch.from_numpy(true).long())
        _close(exact, j_moe_prefill(jp, jcfg, jnp.asarray(true))[0])
        if cf == 0.5:
            got, cache = moe_prefill(tp, cfg, torch.from_numpy(pads[32]).long())
            _close(got[:, :12], exact, 2e-5)
            _close(cache["k"][:, :, :12], cache_exact["k"][:, :, :12], 2e-5)
            continue
        for s, padded in pads.items():
            got, _ = moe_prefill(tp, cfg, torch.from_numpy(padded).long(), true_len=12)
            _close(got, j_moe_prefill(jp, jcfg, jnp.asarray(padded), true_len=jnp.int32(12))[0])
            _close(got[:, :12], exact, 2e-5)


def test_moe_decode_ffn_through_the_decode_trunk(weights):
    """batched_decode_step with moe_decode_ffn on a prefilled cache: logits
    and every plane against the JAX step, f32 and int8 KV (int8 at
    tests/test_moe.py:172's 0.05 against the f32 step, both sides)."""
    jp, tp = weights
    tokens = np.random.RandomState(3).randint(0, DIMS["vocab"], (2, 12)).astype(np.int32)
    active = np.array([True, False])
    outs = {}
    for kv in ("f32", "int8"):
        jl, jc = j_moe_prefill(jp, JCFGS[kv], jnp.asarray(tokens))
        logits, cache = moe_prefill(tp, CFGS[kv], torch.from_numpy(tokens).long())
        _close(logits, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jstep, jnew = j_batched_decode_step(jp, JCFGS[kv], jc, jnp.asarray(tok),
                                            jnp.asarray(active), ffn_fn=j_moe_decode_ffn(JCFGS[kv]))
        step, new = batched_decode_step(tp, CFGS[kv], cache, torch.from_numpy(tok),
                                        torch.from_numpy(active), ffn_fn=moe_decode_ffn(CFGS[kv]))
        _close(step, jstep)
        for key in jnew:
            _close(new[key], jnew[key])
        outs[kv] = step
    _close(outs["int8"], outs["f32"], 0.05)


def test_chunked_prefill_with_moe_ffn(weights):
    """chunked_prefill_into_slot with moe_decode_ffn (capacity = the chunk)
    against the JAX chunk, chunk by chunk, into slot 1 of a dense cache."""
    jp, tp = weights
    n, c = 21, 8
    prompt = np.asarray(_prompt(9, n), np.int32)
    pad = -(-n // c) * c
    padded = np.zeros((1, pad), np.int32)
    padded[0, :n] = prompt
    from vtpu.models.transformer import init_kv_cache as j_init_kv_cache

    jc = j_init_kv_cache(JCFGS["f32"], 2)
    cache = init_kv_cache(CFGS["f32"], 2, device="cpu")
    for off in range(0, pad, c):
        chunk = padded[:, off:off + c]
        jl, jc = j_chunked_prefill_into_slot(
            jp, JCFGS["f32"], jc, jnp.asarray(chunk), jnp.int32(1), jnp.int32(off),
            jnp.int32(min(off + c, n)), ffn_fn=j_moe_decode_ffn(JCFGS["f32"]))
        logits, cache = chunked_prefill_into_slot(
            tp, CFGS["f32"], cache, torch.from_numpy(chunk), 1, off, min(off + c, n),
            ffn_fn=moe_decode_ffn(CFGS["f32"]))
        _close(logits, jl)
    for key in ("k", "v"):
        _close(cache[key][:, 1, :n], jc[key][:, 1, :n])
    assert int(cache["len"][1]) == n


def test_router_stays_f32_in_a_bf16_model(weights):
    """The router is f32 in a bf16 model, from the seeded init and through
    the converter (which also checks shapes); every other leaf is bf16."""
    jp, _ = weights
    cfg = dataclasses.replace(CFGS["f32"], dtype=torch.bfloat16)
    for params in (init_moe_params(0, cfg, device="cpu"),
                   moe_params_from_numpy(_tree(jp), cfg, device="cpu")):
        assert params["layers"]["router"].dtype == torch.float32
        others = [v for k, v in params["layers"].items() if k != "router"]
        assert all(v.dtype == torch.bfloat16 for v in others + [params["embed"]])
    bad = _tree(jp)
    bad["layers"]["router"] = bad["layers"]["router"][:, :, :2]
    with pytest.raises(ValueError, match="router"):
        moe_params_from_numpy(bad, CFGS["f32"], device="cpu")


# ------------------------------------------------------------ the engine


def _tokens(req, timeout=STREAM_TIMEOUT_S):
    """``req``'s streamed tokens (a port or a JAX request), each awaited at
    most ``timeout`` s, so a stalled loop fails the test instead of holding
    the tier until its time limit."""
    out = []
    while True:
        try:
            item = req.out.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"request {req.rid}: nothing streamed within {timeout} s") from None
        if item is None or isinstance(item, (Terminal, JTerminal)):
            return out
        out.append(int(item))


def _serve(eng, prompts, new=NEW):
    """Submit every prompt before the loop starts (the admission batches are
    then the same on both engines), stream them all, stop. Returns (streams,
    stats after stop)."""
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.start()
    try:
        out = [_tokens(r) for r in reqs]
    finally:
        eng.stop()
    assert getattr(eng, "loop_error", None) is None
    return out, eng.stats()


def _port(tp, kv="f32", page=None, paged_attn=None, blocks=None, **kw):
    """A port engine on a MoeSlotModel, which owns the pool (its page, block
    count and read route)."""
    return ServingEngine(model=MoeSlotModel(tp, CFGS[kv], kv_page=page, kv_pool_blocks=blocks,
                                            paged_attn=paged_attn, device="cpu"),
                         serving=ServingConfig(**kw))


def _jax(jp, kv="f32", page=None, **kw):
    return JServingEngine(model=JMoeSlotModel(jp, JCFGS[kv], kv_page=page),
                          serving=JServingConfig(**kw))


BASE = dict(slots=2, prefill_buckets=(16, 32), max_new_tokens=NEW)
ARMS = {
    "sync": dict(pipeline_decode=False),
    "pipelined": {},
    "device_loop": dict(decode_loop_k=4),
    "spec": dict(spec_tokens=3),
    "fused": dict(decode_loop_k=4, spec_tokens=3),
    "paged": dict(page=PAGE),
    "paged_fused": dict(page=PAGE, decode_loop_k=4, spec_tokens=3),
    "int8": dict(kv="int8"),
    "int8_paged": dict(kv="int8", page=PAGE),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_streams_match_jax_engine(weights, arm):
    """ServingEngine(model=MoeSlotModel(...)) against the JAX engine on the
    same weights and ServingConfig: every stream token-equal, one fetch a
    tick (1/k a flush), the pool free after a paged run."""
    jp, tp = weights
    kw = dict(ARMS[arm])
    kv, page = kw.pop("kv", "f32"), kw.pop("page", None)
    want, _ = _serve(_jax(jp, kv, page, **BASE, **kw), PROMPTS)
    got, st = _serve(_port(tp, kv, page, **BASE, **kw), PROMPTS)
    assert got == want
    if "spec_tokens" in kw:
        assert st["spec_ticks"] > 0 and st["spec_disabled_reason"] is None
    if "decode_loop_k" in kw:
        assert st["loop_flushes"] > 0
    if page is not None:
        assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert st["tick_fetches"] <= st["decode_ticks"] + st["spec_ticks"]


@pytest.mark.parametrize("page", [None, PAGE], ids=["dense", "paged"])
def test_chunked_and_prefixed_streams_match_jax_engine(weights, page):
    """prefill_chunk=8 with one registered 10-token prefix: two suffixes,
    an empty suffix and a prompt past the largest bucket, against the JAX
    engine's streams; the chunks run moe_decode_ffn (capacity = the
    chunk)."""
    jp, tp = weights
    kw = dict(slots=2, prefill_buckets=(8,), max_new_tokens=NEW, prefill_chunk=8)
    prefix = _prompt(30, 10)
    subs = [(_prompt(31, 3), True), (_prompt(32, 7), True), ([], True), (_prompt(33, 19), False)]
    outs = []
    for eng in (_jax(jp, page=page, **kw), _port(tp, page=page, **kw)):
        pid = eng.register_prefix(prefix)
        reqs = [eng.submit(p, max_new_tokens=NEW, prefix=pid if pre else None)
                for p, pre in subs]
        eng.start()
        try:
            outs.append([_tokens(r) for r in reqs])
        finally:
            eng.stop()
        st = eng.stats()
    assert outs[1] == outs[0]
    assert st["prefill_chunks"] > 0 and st["prefix_hits"] == 3
    if page is not None:
        # the registered prefix holds its blocks; every slot's are back
        assert st["kv_pool_free"] == st["kv_pool_blocks"] - 2


def _park_at(eng, req, n):
    """Ask for ``req``'s park from the loop thread inside the delivery of
    its n-th token."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if not isinstance(item, Terminal):
            seen[0] += 1
            if seen[0] == n:
                eng.park(req)

    req.out.put = hook


def _until(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < 120, f"{what} never happened"
        time.sleep(0.002)


@pytest.mark.parametrize("kv_swap", [8, 0], ids=["host_tier", "recompute"])
def test_overcommit_streams_match_jax_never_parked(weights, kv_swap):
    """kv_swap on a pool of two blocks: the first session parks after one
    token, the second's admission evicts its pages (to the host tier, or
    dropped for a rebuild through moe_prefill), resume restores it. Both
    streams equal the JAX engine's never-parked ones."""
    jp, tp = weights
    kw = dict(slots=2, prefill_buckets=(8,), max_new_tokens=8, prefill_chunk=8)
    p1, p2 = _prompt(1, 5), _prompt(2, 6)
    want, _ = _serve(_jax(jp, page=PAGE, **kw), [p1, p2], new=8)
    eng = _port(tp, page=PAGE, blocks=2, kv_swap=kv_swap, **kw)
    r1 = eng.submit(p1, max_new_tokens=8)
    _park_at(eng, r1, 1)
    eng.start()
    try:
        _until(lambda: r1 in eng._parked, "the park")
        r2 = eng.submit(p2, max_new_tokens=8)
        got2 = _tokens(r2)
        eng.resume(r1)
        got1 = _tokens(r1)
    finally:
        eng.stop()
    assert eng.loop_error is None and r1.status == r2.status == Status.OK
    assert [got1, got2] == want
    st = eng.stats()
    assert st["parks"] == 1 and st["resumes"] == 1 and st["evicted_blocks"] == 2
    assert st["fault_recomputes"] == (1 if kv_swap == 0 else 0)
    assert st["kv_pool_free"] == st["kv_pool_blocks"]


# ------------------------------------------- the reference's serving gates


def test_moe_slot_model_serves_and_matches_prefill_path(weights):
    """tests/test_serving.py::test_moe_slot_model_serves_and_matches_prefill_path
    on the port: two staggered slots equal the single-request composition
    of moe_prefill and the shared decode loop with moe_decode_ffn, and the
    JAX engine's streams."""
    jp, tp = weights
    cfg = CFGS["f32"]

    def reference(prompt, steps, bucket):
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :len(prompt)] = torch.tensor(prompt)
        logits, cache = moe_prefill(tp, cfg, padded)
        cache["len"] = torch.tensor([len(prompt)], dtype=torch.int32)
        row = logits[0, len(prompt) - 1]
        out = []
        for _ in range(steps):
            tok = int(torch.argmax(row))
            out.append(tok)
            pos = int(cache["len"][0])

            def write_kv(l, kv, k, v, pos=pos):
                store_kv(kv, l, (slice(None), pos), k[:, 0], v[:, 0])
                return kv

            lg, new_kv = decode_layer_loop(tp, cfg, cache, torch.tensor([tok], dtype=torch.int32),
                                           0, write_kv, ffn_fn=moe_decode_ffn(cfg))
            cache = {**new_kv, "len": cache["len"] + 1}
            row = lg[0]
        return out

    kw = dict(slots=2, prefill_buckets=(8, 16), max_new_tokens=5)
    p1, p2 = _prompt(21, 5), _prompt(22, 9)
    got, _ = _serve(_port(tp, **kw), [p1, p2], new=5)
    want, _ = _serve(_jax(jp, **kw), [p1, p2], new=5)
    assert got == want
    assert got == [reference(p1, 5, 8), reference(p2, 5, 16)]


def test_moe_decode_isolated_from_retired_slots():
    """tests/test_serving.py::test_moe_decode_isolated_from_retired_slots on
    the port: two experts, capacity factor 1.0, four slots; a probe's
    stream after every slot was used and retired equals its stream on a
    fresh engine and the JAX engine's."""
    dims = dict(DIMS, n_experts=2, capacity_factor=1.0)
    jcfg = JMoEConfig(**dims, dtype=jnp.float32)
    cfg = MoEConfig(**dims, dtype=torch.float32)
    jp = j_init_moe_params(jax.random.key(6), jcfg)
    tp = moe_params_from_numpy(_tree(jp), cfg, device="cpu")
    serving = ServingConfig(slots=4, prefill_buckets=(8,), max_new_tokens=6)
    probe = _prompt(31, 6)

    def run(dirty):
        eng = ServingEngine(model=MoeSlotModel(tp, cfg, device="cpu"), serving=serving)
        eng.start()
        try:
            if dirty:  # occupy and retire every slot, leaving stale tokens
                warm = [eng.submit([(i * 7 + 1) % cfg.vocab] * 5, max_new_tokens=3)
                        for i in range(4)]
                for w in warm:
                    _tokens(w)
            return _tokens(eng.submit(probe, max_new_tokens=6))
        finally:
            eng.stop()

    jeng = JServingEngine(model=JMoeSlotModel(jp, jcfg), serving=JServingConfig(
        slots=4, prefill_buckets=(8,), max_new_tokens=6))
    want, _ = _serve(jeng, [probe])
    assert run(dirty=True) == run(dirty=False) == want[0]


def test_spec_decode_moe_family(weights):
    """tests/test_serving.py::test_spec_decode_moe_family on the port: the
    speculating engine's stream equals the plain one's (a periodic prompt,
    so drafts are accepted)."""
    _, tp = weights
    prompt = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
    runs = {}
    for spec in (4, 0):
        runs[spec] = _serve(_port(tp, slots=2, prefill_buckets=(16, 32), max_new_tokens=12,
                                  spec_tokens=spec), [prompt], new=12)
    assert runs[4][0] == runs[0][0]
    assert runs[4][1]["spec_ticks"] > 0 and runs[4][1]["spec_emitted"] > 0


def test_streams_token_equal_across_k_moe(weights):
    """tests/test_device_loop.py::test_streams_token_equal_across_k_moe on
    the port: decode_loop_k=4 streams what the per-tick loop streams."""
    _, tp = weights
    prompts = [_prompt(21, 5), _prompt(22, 7)]
    kw = dict(slots=2, prefill_buckets=(16,), max_new_tokens=6)
    base, _ = _serve(_port(tp, **kw), prompts)
    got, st = _serve(_port(tp, decode_loop_k=4, **kw), prompts)
    assert got == base and st["loop_flushes"] > 0


def test_moe_paged_streams_match_moe_dense(weights):
    """tests/test_paged_kv.py::test_moe_paged_streams_match_moe_dense on the
    port: paged MoE streams equal dense MoE streams; the pool ends free."""
    _, tp = weights
    prompts = [_prompt(21, 5), _prompt(22, 7)]
    kw = dict(slots=2, prefill_buckets=(8,), max_new_tokens=5)
    dense, _ = _serve(_port(tp, **kw), prompts, new=5)
    paged, st = _serve(_port(tp, page=PAGE, **kw), prompts, new=5)
    assert dense == paged
    assert st["paged"] and st["kv_pool_free"] == st["kv_pool_blocks"]


def test_engine_moe_streams_kernel_equals_gather(weights):
    """tests/test_paged_attn_kernel.py::test_engine_moe_streams_kernel_equals_gather
    on the port: the paged read route swaps under the routed experts and
    the streams never change. On the CPU the kernel route runs the kernel's
    plain version (its card half is in tests/test_torch_kernels.py)."""
    _, tp = weights
    prompts = [_prompt(21, 5), _prompt(22, 7)]
    kw = dict(slots=2, prefill_buckets=(16,), max_new_tokens=4)
    gather, _ = _serve(_port(tp, page=PAGE, paged_attn="gather", **kw), prompts, new=4)
    kernel, st = _serve(_port(tp, page=PAGE, paged_attn="kernel", **kw), prompts, new=4)
    assert kernel == gather
    assert st["paged_attn_kernel_ticks"] > 0
    assert st["kv_pool_free"] == st["kv_pool_blocks"]


# ------------------------------------------------------------- refusals


def test_refusals(weights):
    """MoeSlotModel(mesh=) builds on one rank's shard (its expert axis
    split over 'tp', tests/test_torch_tp_ops.py serves it on a gloo world)
    and refuses the full tree, naming the counts; an engine given another
    mesh than its adapter's raises; a ServingConfig that disagrees with the
    adapter on kv_page or paged_attn raises with the reference's wording;
    kv_int8="auto" is not refused: a model= adapter reads it as int8, as the
    reference's does (the engine resolves "auto" only for params + cfg)."""
    _, tp = weights
    mesh = TpMesh(rank=1, size=2, device=torch.device("cpu"))
    sharded = MoeSlotModel(shard_moe_params(tp, mesh), CFGS["f32"], mesh=mesh)
    assert sharded.mesh is mesh and sharded.family == "MoE"
    assert sharded.params["layers"]["w_gate"].shape[1] == DIMS["n_experts"] // 2
    with pytest.raises(ValueError, match="one rank's shard"):
        MoeSlotModel(tp, CFGS["f32"], device="cpu", mesh=mesh)
    model = MoeSlotModel(tp, CFGS["f32"], device="cpu")
    with pytest.raises(ValueError, match="not the adapter's mesh"):
        ServingEngine(model=model, serving=ServingConfig(**BASE), mesh=mesh)
    with pytest.raises(ValueError, match="ServingConfig.kv_page=8 but the provided model "
                                         "adapter was built with kv_page=None"):
        ServingEngine(model=model, serving=ServingConfig(**BASE, kv_page=PAGE))
    with pytest.raises(ValueError, match="ServingConfig.paged_attn='gather' but the provided"):
        ServingEngine(model=MoeSlotModel(tp, CFGS["f32"], kv_page=PAGE, device="cpu"),
                      serving=ServingConfig(**BASE, paged_attn="gather"))
    auto = dataclasses.replace(CFGS["f32"], kv_int8="auto")
    eng = ServingEngine(model=MoeSlotModel(tp, auto, device="cpu"), serving=ServingConfig(**BASE))
    assert eng.cfg.kv_int8 == "auto" and eng.state["k"].dtype == torch.int8
    assert eng.state["k_scale"].dtype == torch.float32


@pytest.mark.parametrize("page", [None, PAGE])
def test_kv_int8_auto_adapter_serves_int8_like_jax(weights, page):
    """ServingEngine(model=MoeSlotModel(cfg with kv_int8="auto")): neither
    package resolves "auto" on the model= path, and both adapters read it as
    int8 (kv_quantized). The port's streams equal the JAX MoE engine's given
    the same "auto" config, and equal the port's own kv_int8=True engine's."""
    jp, tp = weights
    auto = dataclasses.replace(CFGS["f32"], kv_int8="auto")
    jauto = dataclasses.replace(JCFGS["f32"], kv_int8="auto")
    prompts = [_prompt(31, 5), _prompt(32, 9), _prompt(33, 14)]
    port = ServingEngine(model=MoeSlotModel(tp, auto, kv_page=page, device="cpu"),
                         serving=ServingConfig(**BASE))
    assert port.state["k"].dtype == torch.int8
    got, st = _serve(port, prompts)
    want, _ = _serve(JServingEngine(model=JMoeSlotModel(jp, jauto, kv_page=page),
                                    serving=JServingConfig(**BASE)), prompts)
    int8, _ = _serve(_port(tp, "int8", page=page, **BASE), prompts)
    assert got == want == int8
    assert st["generated_tokens"] == NEW * len(prompts)
