"""vtpu_torch.models against vtpu.models on the same weights (CPU, f32).

Weights come from the reference's ``init_params`` with a fixed key and are
carried across as float32 numpy; every other input is made from a seed with
numpy and handed to both packages."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import (
    decode_step as j_decode_step,
    greedy_generate as j_greedy_generate,
    prefill as j_prefill,
    sample_tokens as j_sample_tokens,
    spec_verify_loop as j_spec_verify_loop,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import (
    ModelConfig,
    decode_step,
    filter_logits,
    greedy_generate,
    prefill,
    sample_tokens,
    spec_verify_loop,
)

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
PAGE = 8


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
    return jp, params_from_numpy(tree, CFG, device="cpu"), tree


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_params_from_numpy_is_a_copy(weights):
    _, tp, tree = weights
    _close(tp["embed"], tree["embed"], atol=0)
    _close(tp["final_norm"], tree["final_norm"], atol=0)
    for key, arr in tree["layers"].items():
        _close(tp["layers"][key], arr, atol=0)
    bf16 = {**tree, "embed": tree["embed"].astype(ml_dtypes.bfloat16)}
    with pytest.raises(TypeError, match="float32 copies"):
        params_from_numpy(bf16, CFG, device="cpu")
    short = {**tree, "final_norm": tree["final_norm"][:-1]}
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(short, CFG, device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_logits_match_jax(weights, use_kernels):
    """use_kernels routes prefill to flash_attention (its plain version on
    the CPU); both routes equal the reference trunk."""
    jp, tp, _ = weights
    cfg = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=use_kernels)
    toks = np.random.RandomState(0).randint(0, 64, (2, 20)).astype(np.int32)
    jl, jc = j_prefill(jp, JCFG, jnp.asarray(toks))
    tl, tc = prefill(tp, cfg, torch.from_numpy(toks))
    _close(tl, jl, atol=1e-4)
    _close(tc["k"], jc["k"], atol=1e-5)
    _close(tc["len"], jc["len"], atol=0)
    at = np.asarray([19, 7], np.int32)
    jl, _ = j_prefill(jp, JCFG, jnp.asarray(toks), logits_at=jnp.asarray(at))
    tl, _ = prefill(tp, cfg, torch.from_numpy(toks), logits_at=torch.from_numpy(at))
    _close(tl, jl, atol=1e-4)


def test_decode_step_matches_jax(weights):
    jp, tp, _ = weights
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 64, (2, 9)).astype(np.int32)
    _, jc = j_prefill(jp, JCFG, jnp.asarray(toks))
    _, tc = prefill(tp, CFG, torch.from_numpy(toks))
    for _ in range(3):
        nxt = rng.randint(0, 64, (2,)).astype(np.int32)
        jl, jc = j_decode_step(jp, JCFG, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tp, CFG, tc, torch.from_numpy(nxt))
        _close(tl, jl, atol=1e-4)
    _close(tc["k"], jc["k"], atol=1e-5)
    _close(tc["len"], jc["len"], atol=0)


def _dense_writer(lens, t, xp):
    pos = lens[:, None] + xp.arange(t)[None, :]
    rows = xp.arange(lens.shape[0])[:, None]
    if xp is jnp:
        def write(l, kv, k, v):
            return {**kv, "k": kv["k"].at[l, rows, pos].set(k),
                    "v": kv["v"].at[l, rows, pos].set(v)}
    else:
        def write(l, kv, k, v):
            kv["k"][l, rows, pos] = k
            kv["v"][l, rows, pos] = v
            return kv
    return write


def _paged_writer(table, lens, t, xp):
    pos = lens[:, None] + xp.arange(t)[None, :]
    if xp is jnp:
        blk = jnp.take_along_axis(table, pos // PAGE, axis=1)

        def write(l, kv, k, v):
            return {**kv, "k": kv["k"].at[l, blk, pos % PAGE].set(k),
                    "v": kv["v"].at[l, blk, pos % PAGE].set(v)}
    else:
        blk = torch.take_along_dim(table.long(), (pos // PAGE).long(), dim=1)

        def write(l, kv, k, v):
            kv["k"][l, blk, pos % PAGE] = k
            kv["v"][l, blk, pos % PAGE] = v
            return kv
    return write


@pytest.mark.parametrize("layout,route", [("dense", None), ("paged", None),
                                          ("paged", "kernel")])
def test_spec_verify_loop_matches_jax(weights, layout, route):
    """The one decode trunk on a T=3 chunk at ragged per-row offsets: dense
    cache, paged pool through the gather route (auto on CPU), and paged
    through the kernel route (the kernel's plain version on CPU)."""
    jp, tp, _ = weights
    rng = np.random.RandomState(2)
    t = 3
    lens = np.asarray([5, 13], np.int32)
    draft = rng.randint(0, 64, (2, t)).astype(np.int32)
    shp = (2, 2, 32, 2, 32)
    if layout == "dense":
        k, v = rng.randn(*shp).astype(np.float32), rng.randn(*shp).astype(np.float32)
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(lens)}
        tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
                  "len": torch.from_numpy(lens)}
        jw = _dense_writer(jnp.asarray(lens), t, jnp)
        tw = _dense_writer(torch.from_numpy(lens).long(), t, torch)
    else:
        pshape = (2, 9, PAGE, 2, 32)
        k, v = rng.randn(*pshape).astype(np.float32), rng.randn(*pshape).astype(np.float32)
        table = np.asarray([[3, 1, 0, 0], [2, 5, 7, 0]], np.int32)
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(lens),
                  "table": jnp.asarray(table)}
        tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
                  "len": torch.from_numpy(lens), "table": torch.from_numpy(table)}
        jw = _paged_writer(jnp.asarray(table), jnp.asarray(lens), t, jnp)
        tw = _paged_writer(torch.from_numpy(table), torch.from_numpy(lens).long(), t, torch)
    jl, jkv = j_spec_verify_loop(jp, JCFG, jcache, jnp.asarray(draft), 24, jw,
                                 paged_attn="gather" if layout == "paged" else None)
    tl, tkv = spec_verify_loop(tp, CFG, tcache, torch.from_numpy(draft), 24, tw,
                               paged_attn=route)
    _close(tl, jl, atol=1e-4)
    _close(tkv["k"], jkv["k"], atol=1e-5)
    _close(tkv["v"], jkv["v"], atol=1e-5)


def _margins(jp, prompt, out):
    """Per-step top-1/top-2 margin of the reference's logits along its own
    greedy stream (teacher-forced through one prefill)."""
    full = np.concatenate([prompt, out[:, :-1]], axis=1)
    logits, _ = j_prefill(jp, JCFG, jnp.asarray(full))
    n = prompt.shape[1]
    top2 = np.sort(np.asarray(logits)[:, n - 1:], axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_greedy_generate_matches_jax(weights):
    """Token-equal wherever the reference's argmax margin is >= 1e-4; a
    stream stops being compared at its first near-tie."""
    jp, tp, _ = weights
    prompt = np.random.RandomState(3).randint(0, 64, (2, 12)).astype(np.int32)
    want = np.asarray(j_greedy_generate(jp, JCFG, jnp.asarray(prompt), 10))
    got = greedy_generate(tp, CFG, torch.from_numpy(prompt), 10).numpy()
    margins = _margins(jp, prompt, want)
    compared = 0
    for row in range(2):
        for i in range(10):
            if margins[row, i] < 1e-4:
                break
            assert got[row, i] == want[row, i], (row, i, got, want)
            compared += 1
    assert compared >= 10


def test_sample_tokens_greedy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 32).astype(np.float32)
    logits[2, 7] = logits[2, 19] = logits[2].max() + 1.0  # a tie: first index wins
    want, _, _ = j_sample_tokens(jnp.asarray(logits), jax.random.split(jax.random.key(0), 5))
    got = sample_tokens(torch.from_numpy(logits), [None] * 5)
    _close(got, want, atol=0)
    assert int(got[2]) == 7


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 3, 1.0), (1.0, 0, 0.6), (0.8, 4, 0.7)])
def test_sample_tokens_keep_sets_match_jax(temperature, top_k, top_p):
    """Equal logits give equal keep-sets: every token the filter keeps is
    drawn by both samplers over many draws, and nothing else is."""
    logits = np.asarray([1.0, 0.8, 0.6, 0.4, 0.2, 0.0, -0.2, -0.4], np.float32)[::-1].copy()
    n = 512
    rows = np.broadcast_to(logits, (n, 8)).copy()
    jt, _, _ = j_sample_tokens(jnp.asarray(rows), jax.random.split(jax.random.key(1), n),
                               temperature=temperature, top_k=top_k, top_p=top_p)
    gens = [torch.Generator().manual_seed(i) for i in range(n)]
    tt = sample_tokens(torch.from_numpy(rows), gens, temperature, top_k, top_p)
    keep = set(np.flatnonzero(np.isfinite(
        filter_logits(torch.from_numpy(logits[None]), temperature, top_k, top_p).numpy()[0])))
    assert set(np.asarray(jt).tolist()) == keep
    assert set(tt.tolist()) == keep
