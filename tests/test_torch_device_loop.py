"""The port's multi-tick device loop (``decode_loop_k``) against the
reference's (vtpu/serving: ``multi_tick_decode``, ``multi_tick_decode_step``,
``_loop_device``) on the same weights (CPU, f32 and int8 KV).

Held: one k-tick flush equals the JAX flush on the same state (tokens,
counts, carry, logprobs, every cache plane at 1e-4), frozen lanes padded
with LOOP_PAD_TOKEN; under temperature, a flush equals k eager ticks of the
port on the same generators (threefry and Philox cannot match, so sampled
streams are held port against port); engine streams at k in {1, 2, 4, 8}
equal each other and the JAX engine's, dense and paged, f32 and int8 (int8
under the argmax-margin guard of tests/test_torch_int8.py); k = 1 serves
the classic loop; the fetch contract and an exact-budget early exit;
retire and admit in the middle of a flush; host and device lengths and
table rows reconciled at every flush boundary; the stats keys against the
JAX engine's; the guards; logprobs through a flush against the JAX
engine's. One torch thread, no wall-clock threshold, no spawned world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import decode_step as j_decode_step, prefill as j_prefill
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import (
    TransformerSlotModel as JSlotModel, multi_tick_decode_step as j_multi_tick_decode_step,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import LOOP_PAD_TOKEN, ModelConfig
from vtpu_torch.serving import ServingConfig, ServingEngine, Status, TransformerSlotModel
from vtpu_torch.serving.adapters import multi_tick_decode_step, sampled_decode_step

# one layer and max_seq equal to the one prefill bucket: the JAX engines
# warm one read window each
DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_seq=32, head_dim=8)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
LAYOUTS = {"dense": {}, "paged": {"kv_page": PAGE}}
MARGIN = 1e-4
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The reference's params (one set serves both KV types) as JAX arrays
    and carried over per KV type."""
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, {kv: params_from_numpy(tree, CFGS[kv], device="cpu") for kv in CFGS}


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, DIMS["vocab"], (n,)).astype(np.int32) for n in lens]


def _serving(k, cls=ServingConfig, **kw):
    return cls(**{**dict(slots=2, prefill_buckets=(32,), max_new_tokens=10), **kw},
               decode_loop_k=k)


def _run(engine, prompts, budgets=None):
    """Submit every prompt before start() (the admissions then follow the
    ticks, not the submitting thread), stream each to its end; returns
    (requests, streams, stats)."""
    budgets = budgets or [0] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    engine.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        engine.stop()
    assert getattr(engine, "loop_error", None) is None
    return reqs, outs, engine.stats()


def _port(weights, kv, serving):
    return ServingEngine(weights[1][kv], CFGS[kv], serving, device="cpu")


def _jax(weights, kv, serving, prompts, budgets=None):
    return _run(JServingEngine(weights[0], JCFGS[kv], serving), [p.tolist() for p in prompts],
                budgets)


def _ref_stream(jp, kv, prompt, steps):
    """The reference's greedy stream, teacher-forced through prefill and
    decode_step, with each step's top-1/top-2 logit margin."""
    logits, cache = j_prefill(jp, JCFGS[kv], jnp.asarray(prompt[None]))
    row = np.asarray(logits)[0, -1]
    out, margins = [], []
    for _ in range(steps):
        top2 = np.sort(row)[-2:]
        margins.append(float(top2[1] - top2[0]))
        out.append(int(np.argmax(row)))
        logits, cache = j_decode_step(jp, JCFGS[kv], cache, jnp.asarray([out[-1]], jnp.int32))
        row = np.asarray(logits)[0]
    return out, margins


def _agree(got, ref):
    """``got`` equals the reference stream up to its first step whose
    top-1/top-2 margin is below MARGIN; returns the tokens compared."""
    want, margins = ref
    n = 0
    for a, b, m in zip(got, want, margins):
        if m < MARGIN:
            break
        assert a == b, (got, want)
        n += 1
    return n


# ------------------------------------------------------- one flush, both packages


def _twin_states(weights, kv, page, lens):
    """The same prompts prefilled into both packages' slot models (table
    rows of four private pages per slot on a pool); returns (JAX model and
    state, port model and state)."""
    jm = JSlotModel(weights[0], JCFGS[kv], kv_page=page)
    tm = TransformerSlotModel(weights[1][kv], CFGS[kv], kv_page=page, device="cpu")
    js, ts = jm.init_state(len(lens)), tm.init_state(len(lens))
    for slot, prompt in enumerate(_prompts(30, lens)):
        if page is not None:
            row = list(range(1 + 4 * slot, 5 + 4 * slot)) + [0] * (DIMS["max_seq"] // page - 4)
            js = {**js, "table": js["table"].at[slot].set(jnp.asarray(row, jnp.int32))}
            ts["table"][slot] = torch.tensor(row, dtype=torch.int32)
        padded = np.zeros((1, 8), np.int32)
        padded[0, :len(prompt)] = prompt
        _, js = jm.prefill_into_slot(jm.params, js, jnp.asarray(padded), jnp.int32(slot),
                                     jnp.int32(len(prompt)))
        _, ts = tm.prefill_into_slot(tm.params, ts, torch.from_numpy(padded), slot, len(prompt))
    return jm, js, tm, ts


def _planes_close(js, ts, lens_after):
    """Every KV plane of both states equal at ATOL, whole (int8: values
    within one code), lengths and tables exactly."""
    assert np.asarray(js["len"]).tolist() == ts["len"].tolist() == lens_after
    if "table" in ts:
        assert np.array_equal(np.asarray(js["table"]), ts["table"].numpy())
    for key in [k for k in ("k", "v", "k_scale", "v_scale") if k in ts]:
        a, b = np.asarray(js[key]), ts[key].numpy()
        if key in ("k", "v") and a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("logprobs", [False, True], ids=["tokens", "logprobs"])
def test_multi_tick_decode_equals_jax_flush(weights, layout, logprobs):
    """One greedy 4-tick flush over slots at lengths 4 and 5 with caps 2 and
    4: the same tokens, counts, carry and logprobs (1e-4) as the JAX flush,
    the frozen lane's columns LOOP_PAD_TOKEN, and every cache plane within
    1e-4 with the frozen lane's length stopped at its cap."""
    page = LAYOUTS[layout].get("kv_page")
    jm, js, tm, ts = _twin_states(weights, "f32", page, (4, 5))
    jstep = jax.jit(j_multi_tick_decode_step(jm, 0.0, 0, 1.0, logprobs, 4, -1),
                    static_argnames=("kv_bucket", "unroll"))
    jout, jcnt, jcarry, jlps, js, _ = jstep(
        jm.params, js, jnp.asarray([7, 9], jnp.int32), jnp.asarray([True, True]),
        jax.random.split(jax.random.key(0), 2), jnp.asarray([2, 4], jnp.int32), 0, unroll=True)
    step = multi_tick_decode_step(tm, 0.0, 0, 1.0, logprobs, 4, -1)
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    (out, cnt, carry, lps), ts = step(tm.params, ts, torch.tensor([7, 9], dtype=torch.int32),
                                      torch.tensor([True, True]),
                                      torch.tensor([2, 4], dtype=torch.int32), gens, 0)
    assert out.tolist() == np.asarray(jout).tolist()
    assert cnt.tolist() == np.asarray(jcnt).tolist() == [2, 4]
    assert carry.tolist() == np.asarray(jcarry).tolist()
    assert (out[0, 2:] == LOOP_PAD_TOKEN).all() and (out[:, :2] != LOOP_PAD_TOKEN).all()
    assert carry[0] == out[0, 1] and carry[1] == out[1, 3]
    if logprobs:
        np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=ATOL)
        assert (lps[0, 2:] == 0).all()
    else:
        assert lps is None and jlps is None
    _planes_close(js, ts, [4 + 2, 5 + 4])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_flush_under_temperature_equals_k_eager_ticks(weights, layout):
    """A sampled 4-tick flush draws from each slot's generator once an
    inner tick: its tokens, counts, logprobs and caches equal four eager
    sampled ticks of the port on generators with the same seeds (the eager
    side feeds each tick's tokens back and drops a lane past its cap)."""
    page = LAYOUTS[layout].get("kv_page")
    _, _, tm, ts_flush = _twin_states(weights, "f32", page, (4, 5))
    ts_eager = {k: x.clone() for k, x in ts_flush.items()}
    kw = dict(temperature=0.9, top_k=16, top_p=0.95)
    step = multi_tick_decode_step(tm, kw["temperature"], kw["top_k"], kw["top_p"], True, 4, -1)
    gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    tok0 = torch.tensor([7, 9], dtype=torch.int32)
    (out, cnt, carry, lps), ts_flush = step(tm.params, ts_flush, tok0, torch.tensor([True, True]),
                                            torch.tensor([2, 4], dtype=torch.int32), gens, 0)
    tick = sampled_decode_step(tm, kw["temperature"], kw["top_k"], kw["top_p"], True)
    gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    tok, caps = tok0, [2, 4]
    want, want_lps = [[], []], [[], []]
    for i in range(4):
        active = torch.tensor([i < c for c in caps])
        (nxt, lp), ts_eager = tick(tm.params, ts_eager, tok, active, gens, 0)
        for b in range(2):
            if active[b]:
                want[b].append(int(nxt[b]))
                want_lps[b].append(float(lp[b]))
        tok = torch.where(active, nxt, tok)
    assert cnt.tolist() == [2, 4] and carry.tolist() == [want[0][-1], want[1][-1]]
    for b in range(2):
        assert out[b, :cnt[b]].tolist() == want[b]
        assert lps[b, :cnt[b]].tolist() == want_lps[b]
    for key in ts_flush:
        assert torch.equal(ts_flush[key], ts_eager[key]), key


# ------------------------------------------------------------- engine streams


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kv", list(CFGS))
def test_streams_equal_across_k_and_jax(weights, kv, layout):
    """Four prompts over two slots, budgets 5, 7, 3 and 10 (walls inside
    flushes): the port's streams at k = 1, 2, 4 and 8 are equal, and equal
    the JAX engine's k = 4 streams with the same counters (f32); under
    int8 both agree with the reference's greedy stream up to a small
    margin."""
    prompts = _prompts(1, (5, 7, 4, 6))
    budgets = [5, 7, 3, 10]
    runs = {k: _run(_port(weights, kv, _serving(k, **LAYOUTS[layout])), prompts, budgets)
            for k in (1, 2, 4, 8)}
    base = runs[1][1]
    assert all(len(o) == n for o, n in zip(base, budgets))
    for k, (_, outs, st) in runs.items():
        assert outs == base, k
        assert st["decode_loop_k"] == k and (st["loop_flushes"] > 0) == (k > 1)
    _, jouts, jst = _jax(weights, kv, _serving(4, JServingConfig, **LAYOUTS[layout]), prompts,
                         budgets)
    st = runs[4][2]
    if kv == "f32":
        assert jouts == base
        for key in ("decode_ticks", "loop_flushes", "loop_early_exits", "tick_fetches",
                    "pipelined_ticks", "generated_tokens", "kv_bucket_hist"):
            assert st[key] == jst[key], key
    else:
        refs = [_ref_stream(weights[0], kv, p, n) for p, n in zip(prompts, budgets)]
        assert sum(_agree(o, r) for o, r in zip(base, refs)) >= len(prompts)
        for o, r in zip(jouts, refs):
            _agree(o, r)
    if layout == "paged":
        assert st["paged_attn_kernel_ticks"] + st["paged_attn_gather_ticks"] == st["decode_ticks"]
        assert st["kv_pool_free"] == st["kv_pool_blocks"]


def test_k1_bit_identical_to_none(weights):
    """decode_loop_k=1 resolves to the classic pipelined loop: no flush
    step, no loop counters, the same stream and counters as None, while
    stats() reports k = 1."""
    prompts = _prompts(9, (5,))
    eng = _port(weights, "f32", _serving(1))
    assert eng._loop_k is None and eng._decode_loop is None and eng._flush is None
    _, got, st = _run(eng, prompts, [6])
    _, base, bst = _run(_port(weights, "f32", _serving(None)), prompts, [6])
    assert got == base
    assert st["decode_loop_k"] == bst["decode_loop_k"] == 1
    assert st["loop_flushes"] == 0 and st["decode_ticks"] == bst["decode_ticks"]
    assert st["device_gets_per_tick"] == st["device_gets_per_token"] == 1.0
    assert st["pipelined"]


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
def test_fetch_contract_and_exact_budget_early_exit(weights, pipeline):
    """One [B, 4] fetch a flush (device_gets_per_tick == 1/4 exactly,
    decode_ticks counting 4 inner ticks a flush); budgets 5 and 7, neither
    a multiple of 4, stop every stream at exactly its budget (the device
    froze the slot mid-flush, counted as an early exit), equal to the
    classic loop's streams; the bytes of each fetch are the [B, 4] tokens
    and [B] counts."""
    prompts = _prompts(12, (5, 6))
    budgets = [5, 7]
    _, outs, st = _run(_port(weights, "f32", _serving(4, pipeline_decode=pipeline)), prompts,
                       budgets)
    assert [len(o) for o in outs] == budgets
    assert st["tick_fetches"] * 4 == st["decode_ticks"] == st["loop_flushes"] * 4
    assert st["device_gets_per_tick"] == st["device_gets_per_token"] == 0.25
    assert st["host_ms_per_token"] == pytest.approx(st["host_ms_per_tick"] / 4, abs=1e-3)
    assert st["loop_early_exits"] > 0
    admission = sum(n * count * 4 for n, count in enumerate(st["prefill_batch_hist"]))
    assert st["bytes_fetched"] == st["loop_flushes"] * 2 * (4 + 1) * 4 + admission
    assert (st["pipelined_ticks"] > 0) == (pipeline is None)
    _, base, _ = _run(_port(weights, "f32", _serving(None)), prompts, budgets)
    assert outs == base


def test_retire_and_admit_mid_flush(weights):
    """Eight prompts with staggered budgets over two slots: retires and
    admissions land while flushes are in flight; every stream equals the
    classic loop's and the JAX engine's at k = 4 (a recycled slot's
    in-flight column is dropped, never delivered to its new request)."""
    prompts = _prompts(40, [4 + (i % 3) for i in range(8)])
    budgets = [3, 9, 5, 11, 4, 7, 6, 10]
    serving = dict(max_new_tokens=12)
    reqs, got, st = _run(_port(weights, "f32", _serving(4, **serving)), prompts, budgets)
    _, base, _ = _run(_port(weights, "f32", _serving(None, **serving)), prompts, budgets)
    _, jgot, _ = _jax(weights, "f32", _serving(4, JServingConfig, **serving), prompts, budgets)
    assert got == base == jgot
    assert [len(o) for o in got] == budgets and st["admissions"] == 8
    assert all(r.status == Status.OK for r in reqs)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_host_and_device_agree_at_every_flush_boundary(weights, layout):
    """On the synchronous flush loop, after every flush delivery: each live
    slot's host length mirror equals its device length and, on a pool, its
    device table row starts with the blocks the host mapped. At the end
    every consumed token landed: the device length is prompt + budget - 1
    (the last token is never fed back)."""
    eng = _port(weights, "f32", ServingConfig(slots=1, prefill_buckets=(8,), max_new_tokens=20,
                                              decode_loop_k=4, pipeline_decode=False,
                                              **LAYOUTS[layout]))
    checks = []
    deliver = eng._deliver_flush

    def checked(flush, *a, **kw):
        deliver(flush, *a, **kw)
        for slot, req in enumerate(eng._slot_req):
            if req is None:
                continue
            assert eng._slot_len[slot] == int(eng.state["len"][slot])
            if eng._paged:
                blocks = eng._slot_blocks[slot]
                assert eng.state["table"][slot, :len(blocks)].tolist() == blocks
            checks.append(slot)

    eng._deliver_flush = checked
    (prompt,) = _prompts(60, (5,))
    _, (out,), _ = _run(eng, [prompt], [20])
    assert len(out) == 20 and len(checks) >= 3
    assert int(eng.state["len"][0]) == 5 + 20 - 1


def test_stats_keys_match_the_reference(weights):
    """The multi-tick keys the reference's stats() carries are all there,
    with its values on the same run."""
    prompts = _prompts(14, (5, 6))
    _, _, st = _run(_port(weights, "f32", _serving(4)), prompts)
    _, _, jst = _jax(weights, "f32", _serving(4, JServingConfig), prompts)
    for key in ("decode_loop_k", "loop_flushes", "loop_early_exits", "decode_ticks",
                "device_gets_per_tick", "device_gets_per_token", "pipelined_ticks"):
        assert key in jst and st[key] == jst[key], key
    assert st["host_ms_per_token"] is not None and "host_ms_per_token" in jst


@pytest.mark.parametrize("case", ["custom_sampler", "nonpositive_k", "fuses_with_spec",
                                  "inert_spec_composes"])
def test_guards(weights, case):
    tp = weights[1]["f32"]
    if case == "custom_sampler":
        with pytest.raises(ValueError, match="requires device sampling"):
            ServingEngine(tp, CFGS["f32"], _serving(4), device="cpu",
                          sample=lambda row: int(np.argmax(row)))
    elif case == "nonpositive_k":
        with pytest.raises(ValueError, match="decode_loop_k must be >= 1"):
            ServingEngine(tp, CFGS["f32"], _serving(0), device="cpu")
    elif case == "fuses_with_spec":
        # active speculation fuses into the loop (tests/test_torch_spec.py)
        eng = ServingEngine(tp, CFGS["f32"], _serving(4, spec_tokens=3), device="cpu")
        assert eng._fused_spec and eng._decode_fused is not None
        assert eng._decode_loop is not None  # the cooloff flush
    else:
        # speculation a temperature sampler disables does not conflict
        eng = ServingEngine(tp, CFGS["f32"], _serving(4, spec_tokens=3, temperature=0.7),
                            device="cpu")
        assert eng._loop_k == 4 and eng._spec_tokens == 0 and not eng._fused_spec


def test_logprobs_through_a_flush_equal_jax(weights):
    """A paged logprobs engine at k = 4: every decoded token carries its
    logprob (the first, sampled at admission, has none), paired in order,
    equal to the JAX engine's at 1e-4 and to the classic loop's."""
    prompts = _prompts(3, (5, 6))
    kw = dict(kv_page=PAGE, logprobs=True)
    reqs, got, _ = _run(_port(weights, "f32", _serving(4, **kw)), prompts)
    breqs, base, _ = _run(_port(weights, "f32", _serving(None, **kw)), prompts)
    jreqs, jgot, _ = _jax(weights, "f32", _serving(4, JServingConfig, **kw), prompts)
    assert got == base == jgot
    for r, b, j, o in zip(reqs, breqs, jreqs, got):
        assert len(r.logprobs) == len(o) - 1
        np.testing.assert_allclose(r.logprobs, b.logprobs, atol=ATOL)
        np.testing.assert_allclose(r.logprobs, j.logprobs, atol=ATOL)
