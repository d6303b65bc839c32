"""The port's selective-SSM family (vtpu_torch/models/ssm.py,
``SsmSlotModel``) against vtpu's on the same weights (CPU, f32).

Held: the log-depth ``_scan_states`` against ``jax.lax.associative_scan``
and against the recurrence itself; ``ssm_layer`` with and without
``state_at`` (one position, and one a row), ``ssm_forward``,
``ssm_prefill``'s logits and state and ``ssm_decode_step`` against the JAX
functions; the port analogues of tests/test_ssm.py's gates (shapes,
causality, recurrent decode against the scan) and of
tests/test_serving.py's (the prefill state against stepped decode at its
tolerances, the slot model against the recurrent composition, chunking
off for the SSM); ``a_log`` and ``dt_bias`` f32 in a bf16 model; and the
engine: ``ServingEngine(model=SsmSlotModel(...))`` streams equal to the JAX
engine's on the synchronous, pipelined and multi-tick loops, the state
written in place, speculation dropped with the reference's reason, and the
refusals (a mesh, a paged pool, overcommit). Tolerances are the reference
tests': rtol 1e-3 / atol 1e-4 where the scan's rounding order differs, 2e-4
for the recurrent decode. One torch thread, no wall-clock threshold."""

import dataclasses
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models.ssm import (
    SSMConfig as JSSMConfig, _scan_states as j_scan_states, init_ssm_params as j_init_ssm_params,
    init_ssm_state as j_init_ssm_state, ssm_decode_step as j_ssm_decode_step,
    ssm_forward as j_ssm_forward, ssm_layer as j_ssm_layer, ssm_prefill as j_ssm_prefill,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import SsmSlotModel as JSsmSlotModel
from vtpu.serving.engine import Terminal as JTerminal
from vtpu_torch.convert import ssm_params_from_numpy
from vtpu_torch.models import (
    SSMConfig, init_ssm_params, init_ssm_state, ssm_decode_step, ssm_forward,
)
from vtpu_torch.models.ssm import _scan_states, ssm_layer, ssm_prefill
from vtpu_torch.serving import ServingConfig, ServingEngine, Terminal
from vtpu_torch.serving.adapters import SsmSlotModel

DIMS = dict(vocab=96, d_model=32, n_layers=2, d_state=8)
JCFG = JSSMConfig(**DIMS, dtype=jnp.float32)
CFG = SSMConfig(**DIMS, dtype=torch.float32)
# the reference tests' tolerances (tests/test_serving.py:185-214)
RTOL, ATOL = 1e-3, 1e-4
NEW = 6
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
    jp = j_init_ssm_params(jax.random.key(3), JCFG)
    return jp, ssm_params_from_numpy(_tree(jp), CFG, device="cpu")


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _layer(params, l):
    return {k: v[l] for k, v in params["layers"].items()}


# ------------------------------------------------------------- the scan


@pytest.mark.parametrize("s", [1, 7, 16, 33])
def test_scan_states_matches_reference(s):
    """The log-depth scan against associative_scan and against the
    recurrence h_t = a_t h_{t-1} + b_t stepped in order, at any length
    (a power of two, one past it, one)."""
    rs = np.random.RandomState(s)
    a = rs.uniform(0.5, 1.0, (2, s, 3, 4)).astype(np.float32)
    b = rs.randn(2, s, 3, 4).astype(np.float32)
    got = _scan_states(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, j_scan_states(jnp.asarray(a), jnp.asarray(b)))
    h, want = np.zeros((2, 3, 4), np.float32), np.zeros_like(b)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    _close(got, want)
    assert torch.equal(torch.from_numpy(a), torch.from_numpy(a.copy()))  # inputs untouched


@pytest.mark.parametrize("state_at", [None, "scalar", "rows"])
def test_ssm_layer_matches_reference(weights, state_at):
    """One layer's output and, with state_at, its decode state (conv window
    and h): one position against the JAX layer, one a row against the JAX
    layer row by row."""
    jp, tp = weights
    x = np.random.RandomState(5).randn(2, 12, DIMS["d_model"]).astype(np.float32)
    jlp, tlp = _layer(jp, 1), _layer(tp, 1)
    if state_at is None:
        _close(ssm_layer(CFG, tlp, torch.from_numpy(x)), j_ssm_layer(JCFG, jlp, jnp.asarray(x)))
        return
    at = [9, 9] if state_at == "scalar" else [12, 4]
    out, (win, h) = ssm_layer(CFG, tlp, torch.from_numpy(x),
                              state_at=9 if state_at == "scalar" else torch.tensor(at))
    for row, pos in enumerate(at):
        jout, (jwin, jh) = j_ssm_layer(JCFG, jlp, jnp.asarray(x[row:row + 1]),
                                       state_at=jnp.int32(pos))
        _close(out[row:row + 1], jout)
        _close(win[row:row + 1], jwin)
        _close(h[row:row + 1], jh)


def test_ssm_forward_shapes_causality_and_reference(weights):
    """tests/test_ssm.py:33 and :40 on the port (finite [B, S, V] logits; a
    future token never moves a past logit), and the logits against
    ssm_forward."""
    jp, tp = weights
    tokens = np.random.RandomState(1).randint(0, DIMS["vocab"], (2, 12)).astype(np.int32)
    base = ssm_forward(tp, CFG, torch.from_numpy(tokens).long())
    assert base.shape == (2, 12, DIMS["vocab"]) and bool(torch.isfinite(base).all())
    _close(base, j_ssm_forward(jp, JCFG, jnp.asarray(tokens)))
    pert = tokens.copy()
    pert[:, 8] = (pert[:, 8] + 1) % DIMS["vocab"]
    got = ssm_forward(tp, CFG, torch.from_numpy(pert).long())
    _close(got[:, :8], base[:, :8], 1e-5, 1e-5)
    assert not np.allclose(_np(got[:, 8:]), _np(base[:, 8:]))


def test_recurrent_decode_matches_parallel_scan(weights):
    """tests/test_ssm.py:51 on the port: feeding tokens one at a time
    through ssm_decode_step reproduces the forward at every position (2e-4),
    and each step equals the JAX step (logits and state)."""
    jp, tp = weights
    tokens = np.random.RandomState(2).randint(0, DIMS["vocab"], (2, 10)).astype(np.int32)
    want = ssm_forward(tp, CFG, torch.from_numpy(tokens).long())
    state = init_ssm_state(CFG, 2, device="cpu")
    jstate = j_init_ssm_state(JCFG, 2)
    for pos in range(tokens.shape[1]):
        logits, state = ssm_decode_step(tp, CFG, state, torch.from_numpy(tokens[:, pos]).long())
        jlogits, jstate = j_ssm_decode_step(jp, JCFG, jstate, jnp.asarray(tokens[:, pos]))
        _close(logits, want[:, pos], 2e-4, 2e-4)
        _close(logits, jlogits)
        for key in ("conv", "h"):
            _close(state[key], jstate[key])


@pytest.mark.parametrize("rows", [False, True], ids=["one_row", "rows"])
def test_ssm_prefill_matches_reference(weights, rows):
    """ssm_prefill's logits and state against the JAX prefill: one padded
    row at its true length, or two rows at theirs (the JAX prefill row by
    row, as the reference adapter's vmap runs it); logits_at gathers the
    rows the engine reads."""
    jp, tp = weights
    tokens = np.random.RandomState(6).randint(0, DIMS["vocab"], (2, 16)).astype(np.int32)
    lens = [16, 7] if rows else [11]
    tokens = tokens[:len(lens)]
    logits, state = ssm_prefill(tp, CFG, torch.from_numpy(tokens).long(), torch.tensor(lens))
    last, _ = ssm_prefill(tp, CFG, torch.from_numpy(tokens).long(), torch.tensor(lens),
                          logits_at=torch.tensor(lens) - 1)
    for i, n in enumerate(lens):
        jlogits, jstate = j_ssm_prefill(jp, JCFG, jnp.asarray(tokens[i:i + 1]), jnp.int32(n))
        _close(logits[i:i + 1], jlogits)
        _close(last[i], jlogits[0, n - 1])
        for key in ("conv", "h"):
            _close(state[key][:, i:i + 1], jstate[key])


def test_ssm_prefill_state_matches_stepped_decode():
    """tests/test_serving.py::test_ssm_prefill_state_matches_stepped_decode
    on the port, at its tolerances: the scan-derived state at the prompt's
    length equals stepping the recurrent decode over the prompt."""
    cfg = SSMConfig(vocab=96, d_model=32, n_layers=2, d_state=8, dtype=torch.float32)
    params = init_ssm_params(3, cfg, device="cpu")
    prompt = _prompt(7, 9)
    state = init_ssm_state(cfg, 1, device="cpu")
    for t in prompt:
        logits_ref, state = ssm_decode_step(params, cfg, state, torch.tensor([t]))
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    logits_seq, state_pf = ssm_prefill(params, cfg, padded, len(prompt))
    _close(state_pf["h"], state["h"], 1e-3, 1e-4)
    _close(state_pf["conv"], state["conv"], 1e-3, 1e-5)
    _close(logits_seq[0, len(prompt) - 1], logits_ref[0], 1e-3, 1e-3)


def test_a_log_and_dt_bias_stay_f32_in_a_bf16_model(weights):
    """a_log and dt_bias are f32 in a bf16 model, from the seeded init and
    through the converter (which also checks shapes); every other leaf is
    bf16; the decode state's h is f32, its conv windows bf16."""
    jp, _ = weights
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    for params in (init_ssm_params(0, cfg, device="cpu"),
                   ssm_params_from_numpy(_tree(jp), cfg, device="cpu")):
        f32 = {k for k, v in params["layers"].items() if v.dtype == torch.float32}
        assert f32 == {"a_log", "dt_bias"}
        others = [v for k, v in params["layers"].items() if k not in f32]
        assert all(v.dtype == torch.bfloat16 for v in others + [params["embed"]])
    state = init_ssm_state(cfg, 2, device="cpu")
    assert state["h"].dtype == torch.float32 and state["conv"].dtype == torch.bfloat16
    bad = _tree(jp)
    bad["layers"]["a_log"] = bad["layers"]["a_log"][:, :, :2]
    with pytest.raises(ValueError, match="a_log"):
        ssm_params_from_numpy(bad, CFG, device="cpu")


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
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.start()
    try:
        out = [_tokens(r) for r in reqs]
    finally:
        eng.stop()
    assert getattr(eng, "loop_error", None) is None
    return out, eng.stats()


def _port(tp, **kw):
    return ServingEngine(model=SsmSlotModel(tp, CFG, device="cpu"), serving=ServingConfig(**kw))


PROMPTS = [_prompt(11, 5), _prompt(12, 9), _prompt(13, 14)]
BASE = dict(slots=2, prefill_buckets=(8, 16), max_new_tokens=NEW)
LOOPS = {"sync": dict(pipeline_decode=False), "pipelined": {},
         "device_loop": dict(decode_loop_k=4),
         "device_loop_sync": dict(decode_loop_k=4, pipeline_decode=False)}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_engine_streams_match_jax_engine(weights, loop):
    """ServingEngine(model=SsmSlotModel(...)) against the JAX engine on the
    same weights and ServingConfig: every stream token-equal; no read
    window (one kv bucket, 0); the state tensors written in place."""
    jp, tp = weights
    jeng = JServingEngine(model=JSsmSlotModel(jp, JCFG),
                          serving=JServingConfig(**BASE, **LOOPS[loop]))
    want, _ = _serve(jeng, PROMPTS)
    eng = _port(tp, **BASE, **LOOPS[loop])
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    got, st = _serve(eng, PROMPTS)
    assert got == want
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
    assert set(st["kv_bucket_hist"]) == {0}
    assert st["kv_hbm_bytes"] == {"dense": None, "paged": None}
    assert st["paged_attn_launches"] == 0 and st["flash_launches"] == 0
    if "decode_loop_k" in LOOPS[loop]:
        assert st["loop_flushes"] > 0


def test_ssm_slot_model_matches_recurrent_reference(weights):
    """tests/test_serving.py::test_ssm_slot_model_matches_recurrent_reference
    on the port: two staggered slots each equal the single-request
    composition of ssm_prefill and ssm_decode_step, and the JAX engine's
    streams."""
    jp, tp = weights

    def reference(prompt, steps, bucket):
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :len(prompt)] = torch.tensor(prompt)
        logits, state = ssm_prefill(tp, CFG, padded, len(prompt))
        row = logits[0, len(prompt) - 1]
        out = []
        for _ in range(steps):
            tok = int(torch.argmax(row))
            out.append(tok)
            logits, state = ssm_decode_step(tp, CFG, state, torch.tensor([tok]))
            row = logits[0]
        return out

    p1, p2 = _prompt(11, 5), _prompt(12, 9)
    kw = dict(slots=2, prefill_buckets=(8, 16), max_new_tokens=6)
    got, _ = _serve(_port(tp, **kw), [p1, p2])
    want, _ = _serve(JServingEngine(model=JSsmSlotModel(jp, JCFG), serving=JServingConfig(**kw)),
                     [p1, p2])
    assert got == want == [reference(p1, 6, 8), reference(p2, 6, 16)]


def test_chunking_and_speculation_stay_off(weights):
    """The SSM branch of tests/test_serving.py::test_chunked_prefill_config_validation
    (prefill_chunk stays off: no chunkable trunk), and speculation dropped
    with the reference's reason (no spec_step); the streams are the plain
    engine's."""
    _, tp = weights
    eng = _port(tp, slots=1, prefill_buckets=(16,), prefill_chunk=8)
    assert eng._prefill_chunk is None and eng._chunk is None
    with pytest.raises(ValueError, match="prefill_chunk"):
        eng.register_prefix([1, 2, 3])
    base, _ = _serve(_port(tp, **BASE), PROMPTS[:2])
    got, st = _serve(_port(tp, **BASE, spec_tokens=3), PROMPTS[:2])
    assert st["spec_disabled_reason"] == "model adapter SsmSlotModel has no spec_step"
    assert got == base and st["spec_ticks"] == 0


def test_refusals(weights):
    """The SSM under a mesh names the family; a paged pool, a paged route
    and overcommit raise as the reference does (the adapter has no pool)."""
    _, tp = weights
    with pytest.raises(NotImplementedError, match="selective SSM"):
        ServingEngine(model=SsmSlotModel(tp, CFG, device="cpu"), serving=ServingConfig(**BASE),
                      mesh=object())
    with pytest.raises(ValueError, match="ServingConfig.kv_page=8 but the provided model "
                                         "adapter was built with kv_page=None"):
        _port(tp, **BASE, kv_page=8)
    with pytest.raises(ValueError, match="ServingConfig.paged_attn='kernel' but the provided"):
        _port(tp, **BASE, paged_attn="kernel")
    with pytest.raises(ValueError, match="kv_swap requires the paged pool"):
        _port(tp, **BASE, kv_swap=4)
    with pytest.raises(ValueError, match="params live on"):
        SsmSlotModel(tp, CFG, device="meta")
