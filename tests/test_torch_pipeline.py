"""The port's pipelined decode loop against its synchronous loop and the
reference engine's pipelined loop, on the same weights (CPU, f32 and int8
KV).

Held: greedy streams token-equal across the port's two loops and the JAX
engine's pipelined loop, for f32 and int8 KV, dense and paged (int8 under
the argmax-margin guard of tests/test_torch_int8.py, since XLA's and
PyTorch's matmuls may put a K/V value on either side of a quantization
boundary); the transfer contract of tests/test_serving_fast.py's
``test_one_device_get_per_tick_contract`` on both loops; the lifecycle
edges of the one-tick lookahead (the budget wall and the context wall
predicted at dispatch, an eos mid-stream, cancel and slot recycling,
``prefill_budget`` with live decode, stop with a tick in flight);
``pipeline_decode`` resolved as the reference resolves it; and one tp=2
gloo world serving both loops, joined within its timeout. No case holds a
wall-clock threshold."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import decode_step as j_decode_step, prefill as j_prefill
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel.launch import launch_tp, serve_requests
from vtpu_torch.serving import ServingConfig, ServingEngine, Status

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PROMPT_LENS = (5, 11, 16, 3, 9)
NEW = 6
PAGE = 8
MARGIN = 1e-4
LAYOUTS = {"dense": {}, "paged": {"kv_page": PAGE, "kv_pool_blocks": 6}}
WORLD_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The reference's params (one set serves both KV types) as JAX arrays,
    as a float32 numpy tree, and carried over per KV type."""
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, tree, {kv: params_from_numpy(tree, CFGS[kv], device="cpu") for kv in CFGS}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 64, (n,)).astype(np.int32) for n in PROMPT_LENS]


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


@pytest.fixture(scope="module")
def refs(weights, prompts):
    jp, _, _ = weights
    return {kv: [_ref_stream(jp, kv, p, NEW) for p in prompts] for kv in CFGS}


def _agree(got, ref):
    """``got`` equals the reference stream up to its first step whose
    top-1/top-2 margin is below MARGIN. Returns the tokens compared."""
    want, margins = ref
    n = 0
    for a, b, m in zip(got, want, margins):
        if m < MARGIN:
            break
        assert a == b, (got, want)
        n += 1
    return n


def _serving(layout, cls=ServingConfig, **kw):
    return cls(slots=2, prefill_buckets=(8, 16), max_new_tokens=NEW,
               **{**LAYOUTS[layout], **kw})


def _run(engine, prompts, budgets=None):
    """Submit every prompt (with its own token budget if given) before
    start(), so the admissions follow the ticks and not the submitting
    thread's timing, then stream each to its end; returns (requests,
    streams, stats after stop)."""
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
    return ServingEngine(weights[2][kv], CFGS[kv], serving, device="cpu")


# ------------------------------------------------------------- streams


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kv", list(CFGS))
def test_greedy_streams_equal_across_loops_and_jax(weights, prompts, refs, kv, layout):
    """Five prompts over two slots (queueing, batched and single admission,
    slot reuse): the port's pipelined and synchronous loops stream the same
    tokens, and both stream the reference's greedy decode, as does the JAX
    engine's own pipelined loop."""
    jp = weights[0]
    _, pipe, pst = _run(_port(weights, kv, _serving(layout)), prompts)
    _, sync, sst = _run(_port(weights, kv, _serving(layout, pipeline_decode=False)), prompts)
    jeng = JServingEngine(jp, JCFGS[kv], _serving(layout, JServingConfig))
    _, jpipe, jst = _run(jeng, [p.tolist() for p in prompts])
    assert pipe == sync
    assert all(len(o) == NEW for o in pipe)
    compared = sum(_agree(o, r) for o, r in zip(pipe, refs[kv]))
    assert compared >= (len(prompts) * NEW if kv == "f32" else len(prompts))
    for o, r in zip(jpipe, refs[kv]):
        _agree(o, r)
    if kv == "f32":
        assert pipe == jpipe == [r[0] for r in refs[kv]]
    assert pst["pipelined"] and jst["pipelined"] and not sst["pipelined"]
    assert pst["pipelined_ticks"] > 0 and sst["pipelined_ticks"] == 0
    assert pst["device_gets_per_tick"] == sst["device_gets_per_tick"] == 1.0
    assert pst["generated_tokens"] == sst["generated_tokens"] == len(prompts) * NEW
    if layout == "paged":
        assert pst["kv_pool_free"] == pst["kv_pool_blocks"] == 6


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
def test_one_device_get_per_tick_contract(weights, prompts, pipeline):
    """A decode tick performs exactly one device->host read of B*4 token
    bytes; admission first tokens ride it or, on an idle engine, one
    standalone batched admission fetch; no blocking per-admission sync.
    Streams are drained before stop(), so the ratios are exact."""
    serving = ServingConfig(slots=2, prefill_buckets=(8,), max_new_tokens=6,
                            pipeline_decode=pipeline)
    _, _, st = _run(_port(weights, "f32", serving), prompts[:1] + prompts[3:4])
    assert st["decode_ticks"] > 0
    assert st["tick_fetches"] == st["decode_ticks"]
    assert st["device_gets"] == st["tick_fetches"] + st["admission_fetches"]
    assert st["device_gets_per_tick"] == 1.0
    assert st["admission_syncs"] == 0
    admission_bytes = sum(n * count * 4 for n, count in enumerate(st["prefill_batch_hist"]))
    assert st["bytes_fetched"] == st["decode_ticks"] * serving.slots * 4 + admission_bytes
    assert st["host_ms_per_tick"] is not None and st["admission_stall_ms"] is not None
    assert (st["pipelined_ticks"] > 0) == (pipeline is None)


# ------------------------------------------------------ lifecycle edges


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_budget_and_context_walls_are_predicted(weights, prompts, layout):
    """A request whose budget runs into the context wall (a 28-token prompt
    at max_seq 32 gets 4 tokens) beside one that spends a budget of 3: the
    pipelined loop leaves a slot out of the tick its in-flight token
    exhausts, so it dispatches exactly the synchronous loop's ticks, and
    both stream what the JAX engine's pipelined loop streams."""
    long_prompt = np.random.RandomState(3).randint(1, 64, 28).astype(np.int32)
    kw = dict(slots=2, prefill_buckets=(8, 32), max_new_tokens=3, **LAYOUTS[layout])
    got = {}
    for name, engine in (
            ("pipelined", _port(weights, "f32", ServingConfig(**kw))),
            ("sync", _port(weights, "f32", ServingConfig(pipeline_decode=False, **kw))),
            ("jax", JServingEngine(weights[0], JCFGS["f32"], JServingConfig(**kw)))):
        _, outs, st = _run(engine, [long_prompt, prompts[0]], budgets=[10, 0])
        got[name] = outs, st["decode_ticks"]
    assert got["pipelined"] == got["sync"] == got["jax"]
    assert [len(o) for o in got["jax"][0]] == [4, 3] and got["jax"][1] == 3


def _streams(engine, prompts, **kw):
    reqs, outs, st = _run(engine, prompts, **kw)
    return outs, [r.status for r in reqs], st


def test_eos_mid_stream_drops_the_orphaned_token(weights, prompts, refs):
    """eos set to the third token of the first prompt's greedy stream: each
    stream ends at its first eos, the pipelined loop's tick past it is
    dropped by the identity check, the slot recycles cleanly for the
    queued prompts, and both loops and the JAX engine agree."""
    want0 = refs["f32"][0][0]
    eos = want0[2]
    got = {}
    for name, pipeline in (("pipelined", None), ("sync", False)):
        got[name] = _streams(_port(weights, "f32", _serving(
            "paged", eos_token=eos, pipeline_decode=pipeline)), prompts)
    jouts, _, _ = _streams(JServingEngine(weights[0], JCFGS["f32"], _serving(
        "paged", JServingConfig, eos_token=eos)), [p.tolist() for p in prompts])
    (pouts, pstatus, pst), (souts, _, sst) = got["pipelined"], got["sync"]
    assert pouts == souts == jouts
    assert len(pouts[0]) == want0.index(eos) + 1 < NEW
    for out, (want, _) in zip(pouts, refs["f32"]):
        assert out == want[:want.index(eos) + 1 if eos in want else NEW]
    assert pstatus == [Status.OK] * len(prompts)
    assert pst["generated_tokens"] == sst["generated_tokens"] == sum(map(len, pouts))
    assert pst["kv_pool_free"] == pst["kv_pool_blocks"]
    assert pst["tick_fetches"] == pst["decode_ticks"]


def _at_dispatch(engine, n, action):
    """Run ``action()`` right after the engine's n-th decode dispatch (so it
    lands between that tick's dispatch and its delivery, at no timing)."""
    step, calls = engine._step, []

    def wrapped(*args):
        out = step(*args)
        calls.append(1)
        if len(calls) == n:
            action()
        return out

    engine._step = wrapped


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
def test_cancel_frees_the_slot_for_the_queued_request(weights, prompts, refs, pipeline):
    """One slot: the first request is cancelled at the second decode
    dispatch; it ends CANCELLED with a prefix of its greedy stream, and the
    request queued behind it gets the recycled slot and its full greedy
    stream."""
    eng = _port(weights, "f32", ServingConfig(
        slots=1, prefill_buckets=(8, 16), max_new_tokens=NEW, kv_page=PAGE,
        pipeline_decode=pipeline))
    first = eng.submit(prompts[0], max_new_tokens=20)
    queued = eng.submit(prompts[1])
    _at_dispatch(eng, 2, first.cancel)
    eng.start()
    try:
        got = list(first.stream())
        second = list(queued.stream())
    finally:
        eng.stop()
    assert first.status == Status.CANCELLED and queued.status == Status.OK
    assert 1 <= len(got) < 20
    assert got == _ref_stream(weights[0], "f32", prompts[0], len(got))[0]
    assert second == refs["f32"][1][0]
    st = eng.stats()
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert st["tick_fetches"] == st["decode_ticks"]


def test_prefill_budget_with_live_decode(weights, prompts, refs):
    """prefill_budget of one bucket: while a slot decodes, admissions come
    one bucket a tick; the pipelined loop's streams stay exact."""
    outs, statuses, st = _streams(_port(weights, "f32", _serving(
        "dense", prefill_budget=16)), prompts)
    assert outs == [r[0] for r in refs["f32"]]
    assert statuses == [Status.OK] * len(prompts)
    assert st["pipelined_ticks"] > 0 and st["device_gets_per_tick"] == 1.0


def test_stop_delivers_the_tick_in_flight(weights, prompts):
    """stop() landing right after the third decode dispatch, while a long
    request streams: the pipelined loop delivers that tick before it ends
    the stream (CANCELLED), so every dispatched tick was fetched: the
    client gets the first token and three decode tokens, a prefix of the
    greedy stream."""
    eng = _port(weights, "f32", ServingConfig(slots=2, prefill_buckets=(8, 16),
                                              max_new_tokens=NEW))
    req = eng.submit(prompts[0], max_new_tokens=25)
    _at_dispatch(eng, 3, eng._stop.set)  # what stop() sets first
    eng.start()
    got = list(req.stream())
    eng.stop()
    assert req.status == Status.CANCELLED
    st = eng.stats()
    assert st["decode_ticks"] == st["tick_fetches"] == 3 and st["pipelined_ticks"] == 2
    assert len(got) == 4 and st["generated_tokens"] == 4
    assert got == _ref_stream(weights[0], "f32", prompts[0], 4)[0]


@pytest.mark.parametrize("value", [None, True, False])
def test_pipeline_decode_resolution_matches_reference(weights, value):
    kw = dict(slots=2, prefill_buckets=(8,), pipeline_decode=value)
    port = _port(weights, "f32", ServingConfig(**kw))
    ref = JServingEngine(weights[0], JCFGS["f32"], JServingConfig(**kw))
    assert port.stats()["pipelined"] is ref.stats()["pipelined"] is (value is not False)
    assert port.decode_graphs is None  # graphs are built on CUDA only


# ------------------------------------------------------------------ tp=2


def test_tp2_world_serves_both_loops(weights, prompts, refs, tmp_path):
    """One tp=2 gloo world (the spawn-and-join pattern of
    tests/test_torch_tp.py) serves the paged wave on the pipelined loop
    (eager under a mesh) and on the synchronous loop: both stream the
    single-device greedy streams, f32 and int8 KV."""
    _, tree, _ = weights
    kinds = [(kv, pipeline) for kv in CFGS for pipeline in (None, False)]
    runs = [(CFGS[kv], _serving("paged", pipeline_decode=pipeline)) for kv, pipeline in kinds]
    box: dict = {}

    def world():
        try:
            box["ranks"] = launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"],
                                     f"file://{tmp_path}/store",
                                     args=(tree, runs, prompts[:3], NEW),
                                     timeout=WORLD_TIMEOUT_S)
        except Exception as exc:  # handed to the assertion below
            box["error"] = exc

    th = threading.Thread(target=world, daemon=True)
    th.start()
    th.join(timeout=WORLD_TIMEOUT_S + 30)
    assert not th.is_alive(), "the tp=2 world outlived its timeout"
    assert "error" not in box, box.get("error")
    lead = box["ranks"][0]
    for (kv, pipeline), res in zip(kinds, lead):
        st = res["stats"]
        assert res["statuses"] == [Status.OK] * 3
        for out, ref in zip(res["streams"], refs[kv][:3]):
            assert len(out) == NEW
            _agree(out, ref)
        if kv == "f32":
            assert res["streams"] == [r[0] for r in refs[kv][:3]]
        assert st["tp"] == 2 and st["device_gets_per_tick"] == 1.0
        assert st["pipelined"] is (pipeline is None)
        assert (st["pipelined_ticks"] > 0) == (pipeline is None)
    assert lead[0]["streams"] == lead[1]["streams"] and lead[2]["streams"] == lead[3]["streams"]
