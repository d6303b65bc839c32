"""The port's speculation against the reference's (vtpu/serving:
``batched_spec_step``, ``lookup_draft``, the synchronous loop's spec tick,
and the fused loop: ``ngram_draft``, ``multi_tick_spec_decode``,
``_loop_fused``, ``LoopPolicy``) on the same weights (CPU, f32 and int8
KV).

Held: one verify tick equals the JAX one (pred, count, lengths, every KV
plane at 1e-4; int8 values within one code), dense and paged, also at the
context wall, where a kept write must not be lost to a dropped one; the
host and device drafts equal the reference's; a fused flush pads and
counts as the JAX flush does; unfused and fused streams equal plain greedy
decode and the JAX engine's (with its counters), dense, paged and int8
(int8 under the argmax-margin guard); staggered budgets truncate exactly;
why speculation was dropped, in all four cases; the cooloff inside the
fused loop; the LoopPolicy program shape, a pinned k schedule and a
raising policy; ``signals().spec_mean_accepted``; the stats keys;
composition with chunked prefill and with prefixes; fewer dispatches on a
repetitive prompt, counted by call; a verify chunk wider than 16 on the
gather route under auto and refused when the kernel is forced; the six
fields refused under a mesh. One torch thread, no wall-clock threshold,
no spawned world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import (
    decode_step as j_decode_step, ngram_draft as j_ngram_draft, prefill as j_prefill,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import (
    TransformerSlotModel as JSlotModel, fused_spec_decode_step as j_fused_spec_decode_step,
)
from vtpu.serving.engine import (
    batched_spec_step as j_batched_spec_step, lookup_draft as j_lookup_draft,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import LOOP_PAD_TOKEN, ModelConfig, ngram_draft
from vtpu_torch.ops.decode_attn import paged_attn_route
from vtpu_torch.parallel import TpMesh, shard_params
from vtpu_torch.serving import ServingConfig, ServingEngine, TransformerSlotModel
from vtpu_torch.serving.adapters import fused_spec_decode_step
from vtpu_torch.serving.engine import batched_spec_step, lookup_draft
from vtpu_torch.serving.shed import (
    AdaptiveLoopPolicy, EngineSignals, FixedLoopPolicy, LoopPolicy, load_loop_policy,
)

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_seq=64, head_dim=8)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
LAYOUTS = {"dense": {}, "paged": {"kv_page": PAGE}}
MARGIN = 1e-4
ATOL = 1e-4
SPEC_STATS = ("spec_ticks", "spec_slot_ticks", "spec_emitted", "spec_emitted_hist",
              "decode_ticks", "loop_flushes", "fused_flushes", "fused_k_hist",
              "loop_early_exits", "tick_fetches", "generated_tokens", "admission_syncs")


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


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, DIMS["vocab"], (n,)).astype(np.int32) for n in lens]


def _serving(cls=ServingConfig, **kw):
    return cls(**{**dict(slots=2, prefill_buckets=(16,), max_new_tokens=12), **kw})


def _run(engine, prompts, budgets=None):
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
    """The reference's greedy stream, teacher-forced, with each step's
    top-1/top-2 logit margin."""
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
    want, margins = ref
    n = 0
    for a, b, m in zip(got, want, margins):
        if m < MARGIN:
            break
        assert a == b, (got, want)
        n += 1
    return n


def _twin_states(weights, kv, page, prompts):
    """The prompts prefilled into both packages' slot models, each slot's
    table row mapping its first pages (the rest null-padded, as a
    reservation leaves them)."""
    jm = JSlotModel(weights[0], JCFGS[kv], kv_page=page)
    tm = TransformerSlotModel(weights[1][kv], CFGS[kv], kv_page=page, device="cpu")
    js, ts = jm.init_state(len(prompts)), tm.init_state(len(prompts))
    wp = DIMS["max_seq"] // PAGE
    for slot, prompt in enumerate(prompts):
        n = len(prompt)
        if page is not None:
            mapped = min(-(-(n + 4) // page), wp)
            row = list(range(1 + wp * slot, 1 + wp * slot + mapped)) + [0] * (wp - mapped)
            js = {**js, "table": js["table"].at[slot].set(jnp.asarray(row, jnp.int32))}
            ts["table"][slot] = torch.tensor(row, dtype=torch.int32)
        bucket = -(-n // 16) * 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prompt
        _, js = jm.prefill_into_slot(jm.params, js, jnp.asarray(padded), jnp.int32(slot),
                                     jnp.int32(n))
        _, ts = tm.prefill_into_slot(tm.params, ts, torch.from_numpy(padded), slot, n)
    return jm, js, tm, ts


def _planes_close(js, ts):
    assert np.asarray(js["len"]).tolist() == ts["len"].tolist()
    for key in [k for k in ("k", "v", "k_scale", "v_scale") if k in ts]:
        a, b = np.asarray(js[key]), ts[key].numpy()
        if key in ("k", "v") and a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=1e-4, err_msg=key)


# ------------------------------------------------------------- one verify tick


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kv", list(CFGS))
def test_batched_spec_step_equals_jax(weights, kv, layout):
    """Three slots, one inactive: a draft whose first continuation token is
    the model's own argmax (so it is accepted), caps 5, 2 and 5. pred,
    count and the lengths equal the JAX step's; every KV plane within
    1e-4 (int8 values within one code, as tests/test_torch_int8.py
    states); the inactive slot's length and KV unchanged."""
    page = LAYOUTS[layout].get("kv_page")
    prompts = _prompts(5, (6, 9, 4))
    jm, js, tm, ts = _twin_states(weights, kv, page, prompts)
    first = [int(np.argmax(np.asarray(j_prefill(weights[0], JCFGS[kv],
                                                jnp.asarray(p[None]))[0])[0, -1]))
             for p in prompts]
    # column 0 is the pending token; guess 7 for its continuation, so the
    # accepted prefix depends on the model
    draft = np.asarray([[f, 7, 8, 9, 10] for f in first], np.int32)
    active = np.asarray([True, True, False])
    cap = np.asarray([5, 2, 5], np.int32)
    jpred, jcount, js = j_batched_spec_step(weights[0], JCFGS[kv], js, jnp.asarray(draft),
                                            jnp.asarray(active), jnp.asarray(cap))
    pred, count, ts = batched_spec_step(weights[1][kv], CFGS[kv], ts, torch.from_numpy(draft),
                                        torch.from_numpy(active), torch.from_numpy(cap))
    assert pred.dtype == count.dtype == torch.int32
    assert count.tolist() == np.asarray(jcount).tolist()
    assert count[2] == 0 and 1 <= count[0] <= 5 and 1 <= count[1] <= 2
    if kv == "f32":
        assert pred[:2].tolist() == np.asarray(jpred)[:2].tolist()
    else:
        for b in range(2):  # the accepted run at least
            assert pred[b, :count[b]].tolist() == np.asarray(jpred)[b, :count[b]].tolist()
    assert ts["len"].tolist() == [6 + int(count[0]), 9 + int(count[1]), 4]
    _planes_close(js, ts)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kept_write_at_the_context_wall_survives(weights, layout):
    """A slot at max_seq - 2 verifies a 4-token chunk: two positions are
    kept (max_seq - 2 and max_seq - 1), two dropped. A dropped write must
    not share its target with a kept one (an index_put_ with repeated
    indices has no defined winner on CUDA, and on the CPU the later one
    wins): the kept K/V at max_seq - 1 equals the JAX step's (which drops
    out of range), the dropped rows leave every plane as it was, the
    length stops at max_seq."""
    page = LAYOUTS[layout].get("kv_page")
    ctx = DIMS["max_seq"]
    (prompt,) = _prompts(8, (ctx - 2,))
    jm, js, tm, ts = _twin_states(weights, "f32", page, [prompt])
    before = {k: x.clone() for k, x in ts.items()}
    draft = np.asarray([[3, 4, 5, 6]], np.int32)
    active, cap = np.asarray([True]), np.asarray([8], np.int32)
    _, jcount, js = j_batched_spec_step(weights[0], JCFGS["f32"], js, jnp.asarray(draft),
                                        jnp.asarray(active), jnp.asarray(cap))
    _, count, ts = batched_spec_step(weights[1]["f32"], CFGS["f32"], ts,
                                     torch.from_numpy(draft), torch.from_numpy(active),
                                     torch.from_numpy(cap))
    assert ts["len"].tolist() == [min(ctx - 2 + int(count[0]), ctx)]
    _planes_close(js, ts)
    for key in ("k", "v"):
        plane, old = ts[key], before[key]
        if page is None:
            wrote, kept = plane[0, 0, ctx - 2:], old[0, 0, ctx - 2:]
            assert torch.equal(plane[0, 0, :ctx - 2], old[0, 0, :ctx - 2])
        else:
            blk = int(ts["table"][0, (ctx - 1) // page])
            wrote, kept = plane[0, blk, page - 2:], old[0, blk, page - 2:]
            assert torch.equal(plane[0, 0], old[0, 0])  # the null block
        # both kept positions were rewritten (the prefill left its pads'
        # junk there), with what the JAX step wrote (_planes_close above)
        assert ((wrote - kept).abs().sum(dim=(-1, -2)) > 0).all()


# --------------------------------------------------------------------- drafts


def test_lookup_draft_equals_the_reference():
    """A seeded sweep of short histories over a 4-token alphabet (so
    n-grams repeat): every draft equals the reference's, the full-
    continuation preference and the zero padding included."""
    rng = np.random.RandomState(0)
    assert lookup_draft([1, 2, 3, 9, 1, 2, 3, 4, 1, 2, 3], 3, 3) == [4, 1, 2]
    assert lookup_draft([1, 2, 3], 4, 3) is None and lookup_draft([], 4, 3) is None
    for _ in range(300):
        hist = rng.randint(0, 4, rng.randint(0, 24)).tolist()
        k, n = int(rng.randint(1, 6)), int(rng.randint(1, 5))
        assert lookup_draft(hist, k, n) == j_lookup_draft(hist, k, n), (hist, k, n)


def test_ngram_draft_equals_lookup_and_jax():
    """The device draft on right-aligned windows: equal to the host's
    lookup_draft (zeros where it finds nothing) and to the JAX ngram_draft,
    on the reference's cases and a seeded sweep; a match that would need
    tokens left of hist_len (an earlier occupant's) does not fire."""
    cases = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2], [9, 9, 9, 9], [1, 2, 3, 4, 5, 6]]
    rng = np.random.RandomState(1)
    cases += [rng.randint(0, 3, rng.randint(1, 16)).tolist() for _ in range(60)]
    k, ngram, w = 3, 3, 16
    hist = np.zeros((len(cases), w), np.int32)
    hlen = np.zeros((len(cases),), np.int32)
    for i, h in enumerate(cases):
        hist[i, w - len(h):] = h
        hlen[i] = len(h)
    got = ngram_draft(torch.from_numpy(hist), torch.from_numpy(hlen), k, ngram)
    want = np.asarray(j_ngram_draft(jnp.asarray(hist), jnp.asarray(hlen), k, ngram))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    for i, h in enumerate(cases):
        assert got[i].tolist() == (lookup_draft(h, k, ngram) or [0] * k), h
    stale = torch.tensor([[7, 7, 7, 7, 7, 1, 2, 3]], dtype=torch.int32)
    assert ngram_draft(stale, torch.tensor([3]), 2, 3).tolist() == [[0, 0]]


def test_fused_flush_pads_and_counts_as_jax(weights):
    """One fused flush of 4 inner ticks at spec_tokens 3 with budgets 3 and
    16: the same token cube, counts, carry and lengths as the JAX flush;
    columns past a tick's count hold LOOP_PAD_TOKEN, the budget-3 lane
    stops at exactly 3 and counts 0 once frozen, the other emits 1..4 a
    tick; the port's k_dyn = 2 runs two ticks and pads the rest."""
    prompts = _prompts(30, (4, 5))
    jm, js, tm, ts = _twin_states(weights, "f32", None, prompts)
    ts2 = {k: x.clone() for k, x in ts.items()}
    args = (np.zeros((2,), np.int32), np.asarray([True, True]), np.asarray([3, 16], np.int32),
            np.zeros((2, 32), np.int32), np.zeros((2,), np.int32))
    jstep = jax.jit(j_fused_spec_decode_step(jm, 4, 3, -1, 3),
                    static_argnames=("kv_bucket", "unroll"))
    jout, jcnt, jcarry, js = jstep(jm.params, js, *map(jnp.asarray, args), jnp.int32(4), 0,
                                   unroll=True)
    step = fused_spec_decode_step(tm, 4, 3, -1, 3)
    (out, cnt, carry), ts = step(tm.params, ts, *map(torch.from_numpy, args), None, 0)
    assert out.tolist() == np.asarray(jout).tolist()
    assert cnt.tolist() == np.asarray(jcnt).tolist() and carry.tolist() == np.asarray(jcarry).tolist()
    sums = cnt.sum(dim=1).tolist()
    assert sums[0] == 3 and 4 <= sums[1] <= 16 and int(cnt[0, -1]) == 0
    assert (cnt[1] >= 1).all()
    for b in range(2):
        for i in range(4):
            c = int(cnt[b, i])
            assert (out[b, i, c:] == LOOP_PAD_TOKEN).all() and (out[b, i, :c] != LOOP_PAD_TOKEN).all()
    _planes_close(js, ts)
    assert ts["len"].tolist() == [4 + sums[0], 5 + sums[1]]
    (out2, cnt2, _), ts2 = step(tm.params, ts2, *map(torch.from_numpy, args), None, 0, k_dyn=2)
    assert out2.shape == (2, 4, 4) and torch.equal(out2[:, :2], out[:, :2])
    assert (out2[:, 2:] == LOOP_PAD_TOKEN).all() and (cnt2[:, 2:] == 0).all()


# ------------------------------------------------------------- engine streams


def _arms(weights, kv, prompts, budgets=None, **kw):
    """The port's plain loop, unfused and fused speculation."""
    return {name: _run(_port(weights, kv, _serving(**kw, **extra)), prompts, budgets)
            for name, extra in (("plain", {}), ("spec", dict(spec_tokens=3)),
                                ("fused", dict(spec_tokens=3, decode_loop_k=4)))}


@pytest.mark.parametrize("case", ["dense-f32", "paged-f32", "paged-int8"])
def test_streams_equal_plain_greedy_and_jax(weights, case):
    """Two prompts, one periodic (drafts find matches): the port's unfused
    and fused streams equal its plain greedy stream, and (f32) the JAX
    engine's unfused and fused streams with the same speculation counters;
    int8 streams agree with the reference's greedy stream up to a small
    margin."""
    layout, kv = case.split("-")
    prompts = _prompts(1, (5,)) + [np.asarray([5, 6, 7, 8] * 2 + [5, 6], np.int32)]
    arms = _arms(weights, kv, prompts, **LAYOUTS[layout])
    plain = arms["plain"][1]
    assert arms["spec"][1] == arms["fused"][1] == plain
    st, fst = arms["spec"][2], arms["fused"][2]
    assert st["spec_ticks"] > 0 and st["admission_syncs"] == 2 and not st["pipelined"]
    assert fst["fused_spec"] and fst["fused_flushes"] > 0 and fst["decode_ticks"] == 0
    assert st["mean_emitted_per_spec_tick"] > 1.0
    if kv == "int8":
        refs = [_ref_stream(weights[0], kv, p, 12) for p in prompts]
        assert sum(_agree(o, r) for o, r in zip(plain, refs)) >= len(prompts)
        return
    for name, extra in (("spec", dict(spec_tokens=3)),
                        ("fused", dict(spec_tokens=3, decode_loop_k=4))):
        _, jouts, jst = _jax(weights, kv, _serving(JServingConfig, **LAYOUTS[layout], **extra),
                             prompts)
        assert jouts == plain, name
        port = arms[name][2]
        for key in SPEC_STATS:
            assert port[key] == jst[key], (name, key)
    if layout == "paged":
        assert fst["paged_attn_kernel_ticks"] + fst["paged_attn_gather_ticks"] > 0
        assert fst["kv_pool_free"] == fst["kv_pool_blocks"]


def test_staggered_budgets_truncate_exactly(weights):
    """Budgets 3 and 11 on the fused loop: every stream stops at exactly
    its budget (the device counts each verify tick against the remaining
    budget), the freezes count as early exits, one fetch a flush, and the
    fetches per delivered token fall below the plain flush's 1/k."""
    prompts = _prompts(10, (5, 6))
    budgets = [3, 11]
    _, outs, st = _run(_port(weights, "f32", _serving(decode_loop_k=4, spec_tokens=3)),
                       prompts, budgets)
    assert [len(o) for o in outs] == budgets
    assert st["loop_early_exits"] > 0 and st["tick_fetches"] == st["loop_flushes"]
    assert st["device_gets_per_token"] == pytest.approx(st["tick_fetches"] / st["spec_ticks"],
                                                        abs=1e-4)
    assert st["mean_emitted_per_spec_tick"] > 1.0
    assert st["tick_fetches"] / st["spec_emitted"] < 1 / 4
    _, base, _ = _run(_port(weights, "f32", _serving()), prompts, budgets)
    assert outs == base


@pytest.mark.parametrize("case", ["sampler", "temperature", "logprobs", "no_spec_step"])
def test_spec_disabled_reason(weights, case, monkeypatch):
    """Speculation that was asked for and dropped says why, in the
    reference's words, in stats() and one ``spec_disabled`` trace event
    (val: the requested K); an engine that speculates reports None."""
    tp = weights[1]["f32"]
    kw, sample, word = {}, None, case
    if case == "sampler":
        sample, word = (lambda row: int(np.argmax(row))), "sample"
    elif case == "temperature":
        kw = dict(temperature=0.7)
    elif case == "logprobs":
        kw = dict(logprobs=True)
    else:
        monkeypatch.delattr(TransformerSlotModel, "spec_step")
        word = "has no spec_step"
    eng = ServingEngine(tp, CFGS["f32"], _serving(spec_tokens=3, **kw), device="cpu",
                        sample=sample)
    st = eng.stats()
    assert word in st["spec_disabled_reason"] and eng._spec_tokens == 0 and eng._spec is None
    events = [e for e in eng.trace.snapshot() if e[2] == "spec_disabled"]
    assert len(events) == 1 and events[0][5] == 3
    if case == "sampler":
        ok = ServingEngine(tp, CFGS["f32"], _serving(spec_tokens=3), device="cpu")
        assert ok.stats()["spec_disabled_reason"] is None
        assert not [e for e in ok.trace.snapshot() if e[2] == "spec_disabled"]


def test_cooloff_inside_the_fused_loop(weights):
    """spec_min_mean above any reachable acceptance: the first fused flush
    sinks the EMA below it, the next flushes run the plain k-tick flush
    (decode_ticks grows), a re-probe follows after spec_cooloff_ticks
    flushes, and the stream never moves."""
    prompts = _prompts(70, (5, 6))
    budgets = [40, 40]
    kw = dict(max_new_tokens=48)
    _, base, _ = _run(_port(weights, "f32", _serving(**kw)), prompts, budgets)
    _, got, st = _run(_port(weights, "f32", _serving(decode_loop_k=4, spec_tokens=3,
                                                     spec_min_mean=20.0, spec_cooloff_ticks=2,
                                                     **kw)), prompts, budgets)
    assert got == base
    assert st["fused_flushes"] >= 2 and st["decode_ticks"] > 0
    assert st["loop_flushes"] > st["fused_flushes"] and st["spec_ticks"] > 0


# ----------------------------------------------------------------- LoopPolicy


class ScheduledPolicy(LoopPolicy):
    """A deterministic k schedule (module-level, so "module:attr" loads it)."""

    SCHEDULE = (1, 2, 4, 3)

    def __init__(self):
        self.calls = 0
        self.seen = []

    def pick_k(self, k_max, signals=None):
        self.seen.append(signals)
        k = self.SCHEDULE[self.calls % len(self.SCHEDULE)]
        self.calls += 1
        return k


def test_load_loop_policy_shapes():
    assert isinstance(load_loop_policy(None), FixedLoopPolicy)
    assert isinstance(load_loop_policy(AdaptiveLoopPolicy), AdaptiveLoopPolicy)
    inst = ScheduledPolicy()
    assert load_loop_policy(inst) is inst
    loaded = load_loop_policy(f"{__name__}:ScheduledPolicy")
    assert type(loaded).__name__ == "ScheduledPolicy" and callable(loaded.pick_k)
    with pytest.raises(ValueError, match="module:attr"):
        load_loop_policy("nonsense")
    with pytest.raises(ValueError, match="pick_k"):
        load_loop_policy(object())
    pol = AdaptiveLoopPolicy()
    assert pol.pick_k(8) == 8 and pol.pick_k(8, EngineSignals(queue_depth=1)) == 8
    assert pol.pick_k(8, EngineSignals()) == 4
    assert pol.pick_k(8, EngineSignals(spec_mean_accepted=1.0)) == 2


@pytest.mark.parametrize("extra", [dict(decode_loop_k=4), dict(spec_tokens=3)],
                         ids=["loop_only", "spec_only"])
def test_loop_policy_requires_the_fused_loop(weights, extra):
    with pytest.raises(ValueError, match="loop_policy requires"):
        _port(weights, "f32", _serving(loop_policy=FixedLoopPolicy, **extra))


def test_pinned_k_schedule(weights):
    """The policy's picks set each flush's depth (fused_k_hist pins the
    schedule), every pick saw an EngineSignals with the acceptance EMA,
    and the stream equals the static-k run's."""
    prompts = _prompts(60, (5, 6))
    budgets = [20, 20]
    kw = dict(decode_loop_k=4, spec_tokens=3, max_new_tokens=24)
    _, base, _ = _run(_port(weights, "f32", _serving(**kw)), prompts, budgets)
    pol = ScheduledPolicy()
    eng = _port(weights, "f32", _serving(loop_policy=pol, **kw))
    assert sorted(eng._fused) == [1, 2, 3, 4]
    _, got, st = _run(eng, prompts, budgets)
    assert got == base and st["loop_policy"] == "ScheduledPolicy"
    assert pol.calls == st["fused_flushes"] > 1
    expect = [0] * 5
    for i in range(pol.calls):
        expect[ScheduledPolicy.SCHEDULE[i % 4]] += 1
    assert st["fused_k_hist"] == expect
    assert all(isinstance(s, EngineSignals) and s.spec_mean_accepted is not None
               for s in pol.seen)


def test_raising_policy_takes_the_ceiling(weights):
    class Boom(LoopPolicy):
        def pick_k(self, k_max, signals=None):
            raise RuntimeError("policy unavailable")

    prompts = _prompts(62, (5,))
    kw = dict(decode_loop_k=4, spec_tokens=3)
    _, base, _ = _run(_port(weights, "f32", _serving(**kw)), prompts)
    _, got, st = _run(_port(weights, "f32", _serving(loop_policy=Boom, **kw)), prompts)
    assert got == base and st["fused_k_hist"][4] == st["fused_flushes"] > 0


def test_signals_carry_the_acceptance_ema(weights):
    """signals().spec_mean_accepted is the cooloff EMA on a speculating
    engine (the probe value before serving) and None without speculation;
    the snapshot's other fields read the engine's gauges, those of
    features not ported yet their defaults; a dict round trip keeps it."""
    eng = _port(weights, "f32", _serving(slots=1, spec_tokens=3, kv_page=PAGE))
    sig = eng.signals()
    assert sig.spec_mean_accepted == pytest.approx(eng._spec_ema, abs=1e-3)
    assert sig.pool_free == sig.pool_blocks == eng.stats()["kv_pool_blocks"]
    assert sig.parked_sessions == 0 and sig.duty is None and not sig.draining
    eng.submit(_prompts(96, (5,))[0], max_new_tokens=8)
    eng.submit(_prompts(97, (5,))[0], max_new_tokens=2)
    eng._tick_head()
    sig = eng.signals()
    assert sig.active_slots == 1 and sig.queue_depth == 1
    eng.stop()
    assert _port(weights, "f32", _serving()).signals().spec_mean_accepted is None
    sig = EngineSignals(spec_mean_accepted=1.75)
    assert EngineSignals.from_dict({**sig.to_dict(), "newer": 1}).spec_mean_accepted == 1.75


def test_stats_keys_match_the_reference(weights):
    """The speculation and fused-loop keys of the reference's stats() are
    all there, with its values on the same fused run."""
    prompts = _prompts(3, (5, 6))
    kw = dict(decode_loop_k=4, spec_tokens=3)
    _, _, st = _run(_port(weights, "f32", _serving(**kw)), prompts)
    _, _, jst = _jax(weights, "f32", _serving(JServingConfig, **kw), prompts)
    for key in ("spec_ticks", "spec_slot_ticks", "spec_emitted", "spec_emitted_hist",
                "mean_emitted_per_spec_tick", "spec_ema", "spec_cooling_off",
                "spec_disabled_reason", "fused_spec", "fused_flushes", "fused_k_hist",
                "loop_policy", "decode_loop_k", "device_gets_per_tick", "device_gets_per_token"):
        assert key in jst and st[key] == jst[key], key
    assert st["graphs_captured"] == 0  # no graph on the CPU


# --------------------------------------------------------------- composition


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_speculation_composes_with_chunked_prefill(weights, layout):
    """A 44-token periodic prompt past the 16 bucket admits in 16-token
    chunks and then speculates: unfused and fused streams equal the plain
    chunked engine's and the JAX spec engine's."""
    long_p = [np.asarray(([5, 6, 7, 8] * 12)[:44], np.int32)]
    kw = dict(max_new_tokens=10, prefill_chunk=16, **LAYOUTS[layout])
    arms = _arms(weights, "f32", long_p, **kw)
    _, jouts, _ = _jax(weights, "f32", _serving(JServingConfig, spec_tokens=4, **kw), long_p)
    assert arms["spec"][1] == arms["fused"][1] == arms["plain"][1] == jouts
    assert arms["spec"][2]["prefill_chunks"] == 3 and arms["spec"][2]["spec_ticks"] > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_speculation_composes_with_prefixes(weights, layout):
    """A registered periodic prefix under a periodic suffix: the draft
    history holds the prefix's tokens, and the unfused and fused streams
    equal the plain prefix engine's and the JAX spec engine's."""
    pre = ([5, 6, 7, 8] * 5)[:18]
    suf = [5, 6, 7, 8]

    def run(engine):
        engine.start()
        try:
            pid = engine.register_prefix(pre)
            req = engine.submit(suf, max_new_tokens=10, prefix=pid)
            return list(req.stream()), engine.stats()
        finally:
            engine.stop()

    kw = dict(max_new_tokens=10, prefill_chunk=16, **LAYOUTS[layout])
    got = {name: run(_port(weights, "f32", _serving(**kw, **extra)))
           for name, extra in (("plain", {}), ("spec", dict(spec_tokens=4)),
                               ("fused", dict(spec_tokens=4, decode_loop_k=4)))}
    jgot, _ = run(JServingEngine(weights[0], JCFGS["f32"], _serving(JServingConfig,
                                                                    spec_tokens=4, **kw)))
    assert got["spec"][0] == got["fused"][0] == got["plain"][0] == jgot
    assert got["spec"][1]["prefix_hits"] == 1 and got["spec"][1]["spec_ticks"] > 0
    assert got["spec"][1]["mean_emitted_per_spec_tick"] > 1.0


def test_repetitive_prompt_takes_fewer_dispatches(weights):
    """A periodic prompt: the spec engine emits the plain stream in fewer
    verify + decode dispatches than plain decode's steps - 1 ticks (the
    first token comes from admission), counted by call."""
    prompt = np.asarray([5, 6, 7, 8, 5, 6, 7, 8, 5, 6], np.int32)
    steps = 24
    eng = _port(weights, "f32", _serving(spec_tokens=4, max_new_tokens=steps))
    calls = {"spec": 0, "decode": 0}
    spec_fn, step_fn = eng._spec, eng._step

    def counting_spec(*a):
        calls["spec"] += 1
        return spec_fn(*a)

    def counting_step(*a):
        calls["decode"] += 1
        return step_fn(*a)

    eng._spec, eng._step = counting_spec, counting_step
    _, (got,), _ = _run(eng, [prompt])
    _, (base,), _ = _run(_port(weights, "f32", _serving(max_new_tokens=steps)), [prompt])
    assert got == base and len(got) == steps
    assert calls["spec"] > 0 and calls["spec"] + calls["decode"] < steps - 1, calls


def test_wide_verify_chunk_routes_to_gather(weights):
    """The paged kernels take at most 16 queries a row: under auto a
    verify chunk of 17 (spec_tokens 16) resolves to the gather route even
    on CUDA, 16 to the kernel; a forced kernel refuses 17 at construction
    and serves 16 (the plain version on the CPU). The wide engine's stream
    equals plain greedy."""
    assert paged_attn_route(None, 1024, "cuda", 17) == "gather"
    assert paged_attn_route(None, 1024, "cuda", 16) == "kernel"
    assert paged_attn_route("gather", 1024, "cuda", 17) == "gather"
    with pytest.raises(ValueError, match="T=17"):
        _port(weights, "f32", _serving(spec_tokens=16, kv_page=PAGE, paged_attn="kernel"))
    prompts = [np.asarray([5, 6, 7, 8] * 3, np.int32)]
    _, base, _ = _run(_port(weights, "f32", _serving(kv_page=PAGE)), prompts)
    for k, route in ((15, "kernel"), (16, None)):
        _, got, st = _run(_port(weights, "f32", _serving(spec_tokens=k, kv_page=PAGE,
                                                         paged_attn=route)), prompts)
        assert got == base and st["spec_ticks"] > 0


@pytest.mark.parametrize("field,value", [
    ("spec_tokens", 2), ("spec_ngram", 4), ("spec_min_mean", 0.0), ("spec_cooloff_ticks", 8),
    ("decode_loop_k", 4), ("loop_policy", FixedLoopPolicy)])
def test_refused_under_a_mesh(weights, field, value):
    """Each of the six fields is served under a tensor-parallel mesh since
    the broadcast protocol's verify op (tests/test_torch_tp_ops.py serves
    them on a gloo world): under a hand-built mesh, which joined no world,
    the engine passes the field and reaches the adapter's own mesh checks
    (the full tree is refused as not one rank's shard) and, with a shard,
    the protocol's first broadcast, which needs a process group. Nothing
    raises NotImplementedError naming the field."""
    mesh = TpMesh(rank=0, size=2, device=torch.device("cpu"))
    serving = _serving(**{field: value})
    with pytest.raises(ValueError, match="one rank's shard"):
        ServingEngine(weights[1]["f32"], CFGS["f32"], serving, device="cpu", mesh=mesh)
    with pytest.raises(RuntimeError, match="joined no process group"):
        ServingEngine(shard_params(weights[1]["f32"], mesh), CFGS["f32"], serving, mesh=mesh)
    assert _port(weights, "f32", _serving(**{field: value}
                                          if field != "loop_policy" else {})).stats() is not None
