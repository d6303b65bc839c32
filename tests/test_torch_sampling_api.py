"""The sampling API's options in the port against vtpu on the same weights
(CPU, f32): ``logprobs``, a custom ``sample=`` callable, the serial
``async_admission=False`` path and ``decode_unroll``.

Held: ``sample_tokens(return_logprobs=True)`` gives the JAX function's
greedy logprobs at 1e-5, and under temperature/top-k/top-p the logprob of
each drawn token equals the JAX sampler's logprob of the same token (the
two draw from different generators, so the draws are not compared: over
512 draws from an 8-token vocabulary both samplers draw every kept token);
an engine's logprobs pair one to one with its decoded tokens and equal the
JAX engine's at 1e-4, on both loops, with their fetch staged beside the
tokens (one fetch a tick); a custom sampler's streams, fetches and
admission syncs equal the JAX engine's on its host path, and an exception
in it faults that request alone; the serial admission path's streams and
``admission_syncs`` equal the JAX engine's; every ``decode_unroll`` value
gives the same streams; the contradictory configurations raise as the
reference's do. No case holds a wall-clock threshold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import sample_tokens as j_sample_tokens
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig, sample_tokens
from vtpu_torch.serving import ServingConfig, ServingEngine, Status

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
PROMPT_LENS = (5, 11, 16, 3, 21)
NEW = 6
LAYOUTS = {"dense": {}, "paged": {"kv_page": 8, "kv_pool_blocks": 8}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
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
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 64, (n,)).astype(np.int32) for n in PROMPT_LENS]


def argmax_sampler(row):
    """A custom host sampler: the greedy token of a fetched numpy row."""
    return int(np.argmax(row))


# ----------------------------------------------------------- sample_tokens


def test_sample_tokens_greedy_logprobs_match_jax():
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(5, 32)).astype(np.float32)
    want_tok, want_lp, _ = j_sample_tokens(jnp.asarray(logits),
                                           jax.random.split(jax.random.key(0), 5),
                                           return_logprobs=True)
    tok, lp = sample_tokens(torch.from_numpy(logits), [None] * 5, return_logprobs=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    assert lp.dtype == torch.float32 and lp.shape == (5,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=0)
    assert torch.equal(sample_tokens(torch.from_numpy(logits), [None] * 5), tok)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 3, 1.0), (1.0, 0, 0.6), (0.8, 4, 0.7)])
def test_sample_tokens_filtered_logprobs_match_jax(temperature, top_k, top_p):
    """Equal logits, 512 draws each: both samplers draw every token the
    filter keeps, and the port's logprob of each token it drew equals the
    JAX sampler's logprob of that token, log_softmax of the filtered,
    temperature-scaled row (1e-5)."""
    logits = np.asarray([1.0, 0.8, 0.6, 0.4, 0.2, 0.0, -0.2, -0.4], np.float32)[::-1].copy()
    n = 512
    rows = np.broadcast_to(logits, (n, 8)).copy()
    jt, jlp, _ = j_sample_tokens(jnp.asarray(rows), jax.random.split(jax.random.key(1), n),
                                 temperature=temperature, top_k=top_k, top_p=top_p,
                                 return_logprobs=True)
    want = {}
    for t, v in zip(np.asarray(jt).tolist(), np.asarray(jlp).tolist()):
        want.setdefault(t, v)
    gens = [torch.Generator().manual_seed(i) for i in range(n)]
    tok, lp = sample_tokens(torch.from_numpy(rows), gens, temperature, top_k, top_p,
                            return_logprobs=True)
    assert set(tok.tolist()) == set(want)
    for t, v in zip(tok.tolist(), lp.tolist()):
        assert v <= 0.0 and abs(v - want[t]) <= 1e-5, (t, v, want[t])


# ---------------------------------------------------------------- engine


def _serving(layout="paged", cls=ServingConfig, **kw):
    return cls(**{**dict(slots=2, prefill_buckets=(8, 16), max_new_tokens=NEW, prefill_chunk=8),
                  **LAYOUTS[layout], **kw})


def _run(engine, prompts):
    """Submit every prompt before start() (admissions follow the ticks, not
    the submitting thread), stream each to its end; (streams, requests,
    stats after stop)."""
    reqs = [engine.submit(p) for p in prompts]
    engine.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        engine.stop()
    assert getattr(engine, "loop_error", None) is None
    return outs, reqs, engine.stats()


def _both(weights, prompts, serving_kw, sample=None, layout="paged"):
    jp, tp = weights
    port = _run(ServingEngine(tp, CFG, _serving(layout, **serving_kw), device="cpu",
                              sample=sample), prompts)
    ref = _run(JServingEngine(jp, JCFG, _serving(layout, JServingConfig, **serving_kw),
                              sample=sample), [p.tolist() for p in prompts])
    return port, ref


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
def test_logprobs_pair_with_tokens_and_equal_jax(weights, prompts, pipeline):
    """logprobs=True over bucketed and chunked admissions: every decoded token
    has one logprob (the first token, sampled at admission, has none), each
    equals the JAX engine's at 1e-4, and a tick's one fetch carries the
    logprobs beside the tokens (8 bytes a slot)."""
    (outs, reqs, st), (jouts, jreqs, jst) = _both(
        weights, prompts, dict(logprobs=True, pipeline_decode=pipeline))
    assert outs == jouts
    for req, jreq, out in zip(reqs, jreqs, outs):
        assert len(req.logprobs) == len(out) - 1 == len(jreq.logprobs)
        assert all(lp <= 0.0 for lp in req.logprobs)
        np.testing.assert_allclose(req.logprobs, jreq.logprobs, atol=1e-4, rtol=0)
    assert st["device_gets_per_tick"] == jst["device_gets_per_tick"] == 1.0
    assert st["bytes_fetched_per_tick"] >= 2 * 4 * 2
    assert st["pipelined"] is (pipeline is None)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_custom_sampler_serves_the_host_path_like_jax(weights, prompts, layout):
    """A custom sampler: the synchronous loop, no graph, one fetch of the
    [B, vocab] f32 logits a tick, the serial admission path (one blocking
    first-token fetch each); streams, ticks and admission syncs equal the
    JAX engine's with the same callable."""
    (outs, reqs, st), (jouts, _, jst) = _both(weights, prompts, {}, argmax_sampler, layout)
    assert outs == jouts and all(len(o) == NEW for o in outs)
    assert [r.status for r in reqs] == [Status.OK] * len(prompts)
    assert st["device_sampling"] is jst["device_sampling"] is False
    assert st["pipelined"] is jst["pipelined"] is False
    assert st["batched_admission"] is jst["batched_admission"] is False
    assert st["admission_syncs"] == jst["admission_syncs"] == len(prompts)
    assert st["decode_ticks"] == jst["decode_ticks"]
    assert st["device_gets_per_tick"] == 1.0
    assert st["bytes_fetched"] == st["decode_ticks"] * 2 * DIMS["vocab"] * 4


def test_a_raising_sampler_faults_its_request_alone(weights, prompts):
    """A sampler that raises on one request's row: that request ends FAULTED
    and its slot frees; the other streams run to their end."""
    _, tp = weights
    calls = {"n": 0}

    def flaky(row):
        calls["n"] += 1
        if calls["n"] == 3:  # the first decode tick's first row
            raise RuntimeError("sampler bug")
        return int(np.argmax(row))

    outs, reqs, st = _run(ServingEngine(tp, CFG, _serving(), device="cpu", sample=flaky),
                          prompts[:3])
    statuses = [r.status for r in reqs]
    assert statuses.count(Status.FAULTED) == 1 and statuses.count(Status.OK) == 2
    assert st["faulted_requests"] == 1 and st["kv_pool_free"] == st["kv_pool_blocks"]
    assert all(len(o) == NEW for o, s in zip(outs, statuses) if s == Status.OK)


@pytest.mark.parametrize("pipeline", [None, False], ids=["pipelined", "sync"])
def test_serial_admission_matches_jax(weights, prompts, pipeline):
    """async_admission=False with device sampling: one [1, bucket] dispatch
    and a blocking first-token fetch per bucketed or chunked admission;
    streams and admission_syncs equal the JAX engine's."""
    (outs, _, st), (jouts, _, jst) = _both(
        weights, prompts, dict(async_admission=False, pipeline_decode=pipeline))
    assert outs == jouts
    assert st["batched_admission"] is jst["batched_admission"] is False
    assert st["admission_syncs"] == jst["admission_syncs"] == len(prompts)
    assert st["prefill_batch_hist"][1] == jst["prefill_batch_hist"][1] == len(prompts) - 1
    assert st["prefill_chunks"] == jst["prefill_chunks"] == 3
    assert st["admission_fetches"] == 0 and st["device_gets_per_tick"] == 1.0


def test_decode_unroll_values_serve_the_same_streams(weights, prompts):
    _, tp = weights
    got = {}
    for value in (None, True, False):
        got[value], _, _ = _run(ServingEngine(tp, CFG, _serving(decode_unroll=value),
                                              device="cpu"), prompts)
    jouts, _, _ = _run(JServingEngine(weights[0], JCFG, _serving(cls=JServingConfig)),
                       [p.tolist() for p in prompts])
    assert got[None] == got[True] == got[False] == jouts


@pytest.mark.parametrize("field,value,match", [
    ("pipeline_decode", True, "pipeline_decode=True requires device sampling"),
    ("async_admission", True, "async_admission=True requires device sampling"),
    ("logprobs", True, "logprobs=True requires the device sampler")])
def test_contradictions_with_a_custom_sampler_raise(weights, field, value, match):
    jp, tp = weights
    serving = dataclasses.replace(_serving(), **{field: value})
    with pytest.raises(ValueError, match=match):
        ServingEngine(tp, CFG, serving, device="cpu", sample=argmax_sampler)
    jserving = dataclasses.replace(_serving(cls=JServingConfig), **{field: value})
    with pytest.raises(ValueError):
        JServingEngine(jp, JCFG, jserving, sample=argmax_sampler)
