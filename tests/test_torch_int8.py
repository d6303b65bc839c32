"""The port's int8-KV path and dense-cache decode study against vtpu on the
same numpy inputs (CPU, f32).

Held at the reference's own tolerances: atol 2e-5 for attention in f32;
quantize_kv's codes equal with scales within rtol 1e-6 (cache planes the
trunk filled as ``_assert_planes`` states); logits within 1e-5; greedy
streams token-equal wherever the reference's top-1/top-2 margin is >= 1e-4. Where the JAX side reaches Pallas it runs in interpret mode; the
port's kernel wrappers take their plain versions on CPU tensors
(tests/test_torch_kernels.py runs the kernels themselves on a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import (
    decode_step as j_decode_step,
    greedy_generate as j_greedy_generate,
    init_kv_cache as j_init_kv_cache,
    init_paged_kv_cache as j_init_paged_kv_cache,
    prefill as j_prefill,
    quantize_kv as j_quantize_kv,
    spec_verify_loop as j_spec_verify_loop,
)
from vtpu.ops.attention import (
    causal_attention as j_causal_attention,
    causal_attention_int8kv as j_causal_attention_int8kv,
    paged_causal_attention_int8kv as j_paged_causal_attention_int8kv,
)
from vtpu.ops.decode_attn import (
    decode_attention as j_decode_attention,
    paged_decode_attention_int8kv as j_paged_decode_attention_int8kv,
)
from vtpu.serving.engine import (
    batched_decode_step as j_batched_decode_step,
    prefill_into_slot as j_prefill_into_slot,
)
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import (
    ModelConfig,
    decode_step,
    greedy_generate,
    init_kv_cache,
    init_paged_kv_cache,
    prefill,
    quantize_kv,
    spec_verify_loop,
)
from vtpu_torch.ops import (
    _build,
    causal_attention_int8kv,
    decode_attention,
    decode_attention_ref,
    paged_causal_attention_int8kv,
    paged_decode_attention_int8kv,
    paged_decode_attention_int8kv_ref,
)
from vtpu_torch.serving import ServingConfig, ServingEngine, Status
from vtpu_torch.serving.engine import batched_decode_step, prefill_into_slot

DIMS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=True)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=True)
PAGE = 8
TABLE = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], np.int32)
MARGIN = 1e-4
KEYS = ("k", "v", "k_scale", "v_scale")


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


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _scales(rng, *shape):
    # the study's range: [1e-3, 2.1e-2]
    return (rng.rand(*shape) * 0.02 + 1e-3).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _assert_planes(got: dict, want: dict, index=()):
    """KV planes the trunk wrote, at ``index``. The K/V behind them come from
    XLA's and PyTorch's matmuls, which agree to ~1e-6 relative (the bf16/f32
    caches are held at atol 1e-5), so a value at a rounding boundary may
    take the neighbouring int8 code and a scale may move by ~1e-6 relative.
    Measured: 1 code of 2048 off by one in a prefilled slot, 1 scale of 256
    off by 1.05e-6 relative after four decode steps. Held: codes within +-1
    with at most 1 in 256 off, scales within rtol 1e-5. (quantize_kv itself
    matches exactly: test_quantize_kv_matches_jax.)"""
    for key in ("k", "v"):
        a = np.asarray(got[key])[index].astype(np.int32)
        b = np.asarray(want[key])[index].astype(np.int32)
        off = np.abs(a - b)
        assert off.max() <= 1 and off.sum() <= max(1, a.size // 256), (key, off.sum(), a.size)
        _close(np.asarray(got[f"{key}_scale"])[index], np.asarray(want[f"{key}_scale"])[index],
               rtol=1e-5)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("case", ["random", "half_way", "zero_rows"])
def test_quantize_kv_matches_jax(case):
    """Codes equal and scales within rtol 1e-6: random rows, rows whose
    quotients sit exactly half way between codes (absmax 127 gives scale 1,
    and round-half-to-even decides), and all-zero rows (the 1e-6 clamp)."""
    rng = np.random.RandomState(0)
    x = _np(rng, 3, 5, 2, 16) * 3
    if case == "half_way":
        x[..., 0] = 127.0
        x[..., 1:9] = [2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 4.5]
    elif case == "zero_rows":
        x[:, 1] = 0.0
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = j_quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js, rtol=1e-6)
    if case == "half_way":
        assert q[0, 0, 0, 1:9].tolist() == [2, -4, 0, 0, 2, 126, -126, 4]


@pytest.mark.parametrize("form", ["causal", "flat", "ragged"])
def test_causal_attention_int8kv_matches_jax(form):
    rng = np.random.RandomState(1)
    q = _np(rng, 2, 3, 2, 16)
    kq, vq = _int8(rng, 2, 8, 2, 16), _int8(rng, 2, 8, 2, 16)
    ks, vs = _scales(rng, 2, 8, 2), _scales(rng, 2, 8, 2)
    if form == "causal":
        q, kv_len = _np(rng, 2, 8, 2, 16), None
    elif form == "flat":
        kv_len = np.asarray([5, 8], np.int32)
    else:
        kv_len = np.asarray([[4, 5, 6], [6, 7, 8]], np.int32)
    got = causal_attention_int8kv(*_t(q, kq, ks, vq, vs, kv_len))
    want = j_causal_attention_int8kv(*_j(q, kq, ks, vq, vs, kv_len))
    _close(got, want, atol=2e-5)


def test_paged_causal_attention_int8kv_matches_jax():
    rng = np.random.RandomState(2)
    kq, vq = _int8(rng, 9, PAGE, 2, 16), _int8(rng, 9, PAGE, 2, 16)
    ks, vs = _scales(rng, 9, PAGE, 2), _scales(rng, 9, PAGE, 2)
    q = _np(rng, 3, 2, 2, 16)
    lens = np.asarray([[9, 10], [20, 21], [31, 32]], np.int32)
    got = paged_causal_attention_int8kv(*_t(q, kq, ks, vq, vs, TABLE, lens))
    want = j_paged_causal_attention_int8kv(*_j(q, kq, ks, vq, vs, TABLE), kv_len=jnp.asarray(lens))
    _close(got, want, atol=2e-5)


def _paged_int8_case(name):
    rng = np.random.RandomState(3)
    kq, vq = _int8(rng, 2, 9, PAGE, 2, 16), _int8(rng, 2, 9, PAGE, 2, 16)
    ks, vs = _scales(rng, 2, 9, PAGE, 2), _scales(rng, 2, 9, PAGE, 2)
    if name == "flat_t1":
        q, table, lens = _np(rng, 3, 1, 2, 16), TABLE, np.asarray([5, 17, 32], np.int32)
    elif name == "ragged_t3":
        q, table = _np(rng, 3, 3, 2, 16), TABLE
        lens = np.asarray([[9, 10, 11], [19, 20, 21], [30, 31, 32]], np.int32)
    else:  # the null block's values AND scales poisoned: never observable
        kq[:, 0], vq[:, 0], ks[:, 0], vs[:, 0] = 127, -127, 1e3, 1e3
        q = _np(rng, 2, 1, 2, 16)
        table, lens = np.asarray([[2, 0, 0, 0], [7, 3, 0, 0]], np.int32), np.asarray([3, 11], np.int32)
    return q, kq, ks, vq, vs, table, lens


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("case", ["flat_t1", "ragged_t3", "poisoned_null"])
def test_paged_int8_ref_matches_jax_paged_kernel(case, layer):
    """The plain version (what the wrapper runs on CPU tensors, with no
    launch) against the reference's int8 paged kernel in interpret mode,
    at the first and the last layer plane."""
    arrays = _paged_int8_case(case)
    want = j_paged_decode_attention_int8kv(*_j(*arrays), layer=layer, interpret=True)
    t = _t(*arrays)
    _close(paged_decode_attention_int8kv_ref(*t, layer=layer), want, atol=2e-5)
    before = _build.launches()["paged_decode_attention_int8kv"]
    _close(paged_decode_attention_int8kv(*t, layer=layer), want, atol=2e-5)
    assert _build.launches()["paged_decode_attention_int8kv"] == before
    q, kq, ks, vq, vs, table, lens = t
    _close(paged_causal_attention_int8kv(q, kq[layer], ks[layer], vq[layer], vs[layer], table,
                                         lens), want, atol=2e-5)


def _dense_case(name, rng):
    """The reference's four decode_attention cases (tests/test_ops.py)."""
    b, h, dh = 2, 2, 128
    bucket = 0
    if name == "ragged":
        t, s = 4, 256
        lens = np.asarray([[5, 6, 7, 8], [200, 201, 202, 203]], np.int32)
    elif name == "flat_t1":
        t, s, lens = 1, 256, np.asarray([5, 200], np.int32)
    elif name == "multi_tile":
        t, s, lens = 1, 1024, np.asarray([[700], [1024]], np.int32)
    else:  # bucket bounds the reads over a longer cache
        t, s, bucket = 1, 1024, 256
        lens = np.asarray([[100], [256]], np.int32)
    return _np(rng, b, t, h, dh), s, lens, bucket


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("case", ["ragged", "flat_t1", "multi_tile", "bucket"])
def test_decode_attention_matches_jax_kernel(case, kv):
    """The dense-cache study: the port's decode_attention (its plain version
    on CPU tensors, with no launch) against the reference's decode_attention
    in interpret mode, in f32 and in int8 with scale planes."""
    rng = np.random.RandomState(4)
    q, s, lens, bucket = _dense_case(case, rng)
    b, _, h, dh = q.shape
    if kv == "int8":
        k, v = _int8(rng, b, s, h, dh), _int8(rng, b, s, h, dh)
        ks, vs = _scales(rng, b, s, h), _scales(rng, b, s, h)
    else:
        k, v, ks, vs = _np(rng, b, s, h, dh), _np(rng, b, s, h, dh), None, None
    want = j_decode_attention(*_j(q, k, v, lens, ks, vs), bucket=bucket, interpret=True)
    name = "decode_attention_int8kv" if kv == "int8" else "decode_attention"
    before = _build.launches()[name]
    got = decode_attention(*_t(q, k, v, lens, ks, vs), bucket=bucket)
    assert _build.launches()[name] == before
    _close(got, want, atol=2e-5)
    _close(decode_attention_ref(*_t(q, k, v, lens, ks, vs), bucket=bucket), want, atol=2e-5)
    # and the plain attention over the bounded window agrees
    w = bucket or s
    if kv == "int8":
        plain = j_causal_attention_int8kv(*_j(q, k[:, :w], ks[:, :w], v[:, :w], vs[:, :w]),
                                          kv_len=jnp.asarray(lens))
    else:
        plain = j_causal_attention(*_j(q, k[:, :w], v[:, :w]), kv_len=jnp.asarray(lens))
    _close(got, plain, atol=2e-5)


def test_decode_attention_contract_errors():
    q, k = torch.zeros((1, 2, 1, 128)), torch.zeros((1, 8, 1, 128))
    with pytest.raises(ValueError, match="ragged"):
        decode_attention(q, k, k, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds cache length"):
        decode_attention(q[:, :1], k, k, torch.tensor([4], dtype=torch.int32), bucket=16)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        decode_attention(q[:, :1], k, k, torch.tensor([4], dtype=torch.int32),
                         k_scale=torch.ones((1, 8, 1)))


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_cache_layouts(layout):
    """int8 planes plus f32 scale planes [..., H], zero-filled."""
    if layout == "dense":
        cache, jcache = init_kv_cache(CFG, 3, device="cpu"), j_init_kv_cache(JCFG, 3)
    else:
        cache = init_paged_kv_cache(CFG, 3, PAGE, 9, device="cpu")
        jcache = j_init_paged_kv_cache(JCFG, 3, PAGE, 9)
    assert sorted(cache) == sorted(jcache)
    for key, arr in jcache.items():
        assert tuple(cache[key].shape) == arr.shape, key
        assert str(cache[key].dtype).split(".")[-1] == str(arr.dtype), key
        assert not cache[key].any()


def test_prefill_int8_matches_jax(weights):
    """Prefill attends over the unquantized K/V (logits within 1e-5) and
    stores them quantized, as the reference's cache does (``_assert_planes``)."""
    jp, tp = weights
    toks = np.random.RandomState(5).randint(0, 64, (2, 20)).astype(np.int32)
    jl, jc = j_prefill(jp, JCFG, jnp.asarray(toks))
    tl, tc = prefill(tp, CFG, torch.from_numpy(toks))
    _close(tl, jl, atol=1e-5)
    assert tc["k"].dtype == tc["v"].dtype == torch.int8
    _assert_planes(tc, jc)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_decode_step_int8_matches_jax(weights):
    """Teacher-forced decode over the int8 dense cache: logits within 1e-5
    at every step and the cache planes as the reference's."""
    jp, tp = weights
    rng = np.random.RandomState(6)
    toks = rng.randint(0, 64, (2, 9)).astype(np.int32)
    _, jc = j_prefill(jp, JCFG, jnp.asarray(toks))
    _, tc = prefill(tp, CFG, torch.from_numpy(toks))
    for _ in range(4):
        nxt = rng.randint(0, 64, (2,)).astype(np.int32)
        jl, jc = j_decode_step(jp, JCFG, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tp, CFG, tc, torch.from_numpy(nxt))
        _close(tl, jl, atol=1e-5)
    _assert_planes(tc, jc)


def _writer(lens, t, xp, table=None):
    """A chunk writer for an int8 cache, quantizing as the trunk's callers do."""
    pos = lens[:, None] + xp.arange(t)[None, :]
    if table is None:
        idx = (xp.arange(lens.shape[0])[:, None], pos)
    elif xp is jnp:
        idx = (jnp.take_along_axis(table, pos // PAGE, axis=1), pos % PAGE)
    else:
        idx = (torch.take_along_dim(table.long(), (pos // PAGE).long(), dim=1), pos % PAGE)
    if xp is jnp:
        def write(l, kv, k, v):
            out = dict(kv)
            for key, x in (("k", k), ("v", v)):
                xq, sc = j_quantize_kv(x)
                out[key] = kv[key].at[(l, *idx)].set(xq)
                out[f"{key}_scale"] = kv[f"{key}_scale"].at[(l, *idx)].set(sc)
            return out
    else:
        def write(l, kv, k, v):
            for key, x in (("k", k), ("v", v)):
                xq, sc = quantize_kv(x)
                kv[key][(l, *idx)] = xq
                kv[f"{key}_scale"][(l, *idx)] = sc
            return kv
    return write


@pytest.mark.parametrize("layout,route", [("dense", None), ("paged", None),
                                          ("paged", "kernel")])
def test_spec_verify_loop_int8_matches_jax(weights, layout, route):
    """The decode trunk on a T=3 chunk at ragged offsets over int8 KV: dense
    (causal_attention_int8kv over [:, :bucket]), paged through the gather
    route (auto on CPU) and paged through the kernel route (the int8 paged
    kernel's plain version on CPU)."""
    jp, tp = weights
    rng = np.random.RandomState(7)
    t = 3
    lens = np.asarray([5, 13], np.int32)
    draft = rng.randint(0, 64, (2, t)).astype(np.int32)
    vshape = (2, 2, 32, 2, 32) if layout == "dense" else (2, 9, PAGE, 2, 32)
    planes = {"k": _int8(rng, *vshape), "v": _int8(rng, *vshape),
              "k_scale": _scales(rng, *vshape[:-1]), "v_scale": _scales(rng, *vshape[:-1])}
    jcache = {key: jnp.asarray(a) for key, a in planes.items()}
    tcache = {key: torch.from_numpy(a.copy()) for key, a in planes.items()}
    jcache["len"], tcache["len"] = jnp.asarray(lens), torch.from_numpy(lens)
    table = None
    if layout == "paged":
        table = np.asarray([[3, 1, 0, 0], [2, 5, 7, 0]], np.int32)
        jcache["table"], tcache["table"] = jnp.asarray(table), torch.from_numpy(table)
    jw = _writer(jnp.asarray(lens), t, jnp, None if table is None else jnp.asarray(table))
    tw = _writer(torch.from_numpy(lens).long(), t, torch,
                 None if table is None else torch.from_numpy(table))
    jl, jkv = j_spec_verify_loop(jp, JCFG, jcache, jnp.asarray(draft), 24, jw,
                                 paged_attn="gather" if layout == "paged" else None)
    tl, tkv = spec_verify_loop(tp, CFG, tcache, torch.from_numpy(draft), 24, tw,
                               paged_attn=route)
    _close(tl, jl, atol=1e-5)
    _assert_planes(tkv, jkv)


def _ref_stream(jp, prompt, steps):
    """The reference's int8 greedy stream, teacher-forced through prefill and
    decode_step, with each step's top-1/top-2 logit margin."""
    logits, cache = j_prefill(jp, JCFG, jnp.asarray(prompt[None]))
    row = np.asarray(logits)[0, -1]
    out, margins = [], []
    for _ in range(steps):
        top2 = np.sort(row)[-2:]
        margins.append(float(top2[1] - top2[0]))
        out.append(int(np.argmax(row)))
        logits, cache = j_decode_step(jp, JCFG, cache, jnp.asarray([out[-1]], jnp.int32))
        row = np.asarray(logits)[0]
    return out, margins


def _assert_stream(got, want, margins, min_compared=1):
    compared = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if margins[i] < MARGIN:
            break
        assert a == b, (i, got, want)
        compared += 1
    assert compared >= min_compared


def test_greedy_generate_int8_matches_jax(weights):
    jp, tp = weights
    prompt = np.random.RandomState(8).randint(0, 64, (2, 12)).astype(np.int32)
    want = np.asarray(j_greedy_generate(jp, JCFG, jnp.asarray(prompt), 10))
    got = greedy_generate(tp, CFG, torch.from_numpy(prompt), 10).numpy()
    for row in range(2):
        ref, margins = _ref_stream(jp, prompt[row], 10)
        assert ref == want[row].tolist()
        _assert_stream(got[row].tolist(), ref, margins, min_compared=5)


# --------------------------------------------------------------- serving


def test_stale_table_writes_are_dropped_for_scale_planes(weights):
    """The int8 form of the stale-table test: slot 0 retired with a stale
    row naming block 3 (now slot 1's), slot 2 at the context wall. Only slot
    1's token lands, in all four planes, and the pool equals the
    reference's."""
    jp, tp = weights
    rng = np.random.RandomState(9)
    shape = (2, 9, PAGE, 2, 32)
    planes = {"k": _int8(rng, *shape), "v": _int8(rng, *shape),
              "k_scale": _scales(rng, *shape[:-1]), "v_scale": _scales(rng, *shape[:-1])}
    table = np.asarray([[3, 0, 0, 0], [3, 4, 0, 0], [5, 6, 7, 8]], np.int32)
    lens = np.asarray([2, 5, 32], np.int32)
    active = np.asarray([False, True, True])
    tokens = np.asarray([7, 9, 11], np.int32)
    jcache = {**{key: jnp.asarray(a) for key, a in planes.items()},
              "len": jnp.asarray(lens), "table": jnp.asarray(table)}
    tcache = {**{key: torch.from_numpy(a.copy()) for key, a in planes.items()},
              "len": torch.from_numpy(lens), "table": torch.from_numpy(table)}
    jl, jc = j_batched_decode_step(jp, JCFG, jcache, jnp.asarray(tokens), jnp.asarray(active))
    tl, tc = batched_decode_step(tp, CFG, tcache, torch.from_numpy(tokens),
                                 torch.from_numpy(active))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    _close(tl[1], jl[1], atol=1e-5)
    _assert_planes(tc, jc)
    for key in KEYS:
        changed = np.argwhere(tc[key].numpy() != planes[key])[:, :3]
        # only slot 1's write landed: (layer, block 3, offset 5) in each layer
        assert sorted({tuple(c) for c in changed.tolist()}) == [(0, 3, 5), (1, 3, 5)], key


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_into_slot_int8_matches_jax(weights, layout):
    """One right-padded prompt installed into slot 1 of an int8 cache: the
    first-token logits, and the slot's values and scales (paged: in its
    mapped blocks), equal the reference's."""
    jp, tp = weights
    rng = np.random.RandomState(10)
    n, bucket = 11, 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = rng.randint(1, 64, (n,))
    if layout == "dense":
        tcache, jcache = init_kv_cache(CFG, 2, device="cpu"), j_init_kv_cache(JCFG, 2)
        rows = (slice(None), 1)
    else:
        tcache = init_paged_kv_cache(CFG, 2, PAGE, 9, device="cpu")
        jcache = j_init_paged_kv_cache(JCFG, 2, PAGE, 9)
        table = np.asarray([[0, 0, 0, 0], [4, 2, 0, 0]], np.int32)
        tcache["table"], jcache["table"] = torch.from_numpy(table), jnp.asarray(table)
        rows = (slice(None), [4, 2])
    jl, jc = j_prefill_into_slot(jp, JCFG, jcache, jnp.asarray(padded), 1, n)
    tl, tc = prefill_into_slot(tp, CFG, tcache, torch.from_numpy(padded), 1, n)
    _close(tl, jl, atol=1e-5)
    np.testing.assert_array_equal(tc["len"].numpy(), [0, n])
    _assert_planes(tc, jc, rows)
    for key in KEYS:
        assert tc[key].numpy()[rows].any(), key


PROMPT_LENS = (5, 11, 16, 3, 9)
NEW = 6


@pytest.fixture(scope="module")
def int8_refs(weights):
    jp, _ = weights
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 64, (n,)).astype(np.int32) for n in PROMPT_LENS]
    refs = [_ref_stream(jp, p, NEW) for p in prompts]
    for p, (ref, _) in zip(prompts, refs):
        assert np.asarray(j_greedy_generate(jp, JCFG, jnp.asarray(p[None]), NEW))[0].tolist() == ref
    return prompts, refs


@pytest.mark.parametrize("layout", ["dense", "paged_gather", "paged_kernel_route"])
def test_engine_int8_streams_match_jax_greedy(weights, int8_refs, layout):
    """ServingEngine(kv_int8=True) on the CPU: five prompts over two slots,
    streamed token-equal to the reference's int8 greedy decode under the
    margin guard, one fetch per tick, int8 state, and (paged) a pool fully
    free after stop(). The kernel route runs the int8 paged kernel's plain
    version on the CPU."""
    _, tp = weights
    prompts, refs = int8_refs
    kw = {}
    if layout != "dense":
        kw = {"kv_page": PAGE, "kv_pool_blocks": 6,
              "paged_attn": "kernel" if layout == "paged_kernel_route" else "gather"}
    eng = ServingEngine(tp, CFG, ServingConfig(
        slots=2, prefill_buckets=(8, 16), max_new_tokens=NEW, **kw), device="cpu")
    assert eng.state["k"].dtype == torch.int8 and eng.state["k_scale"].dtype == torch.float32
    eng.start()
    try:
        reqs = [eng.submit(p) for p in prompts]
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert eng.loop_error is None
    assert [r.status for r in reqs] == [Status.OK] * len(prompts)
    for out, (ref, margins) in zip(outs, refs):
        assert len(out) == NEW
        _assert_stream(out, ref, margins)
    st = eng.stats()
    assert st["device_gets_per_tick"] == 1.0
    assert st["generated_tokens"] == NEW * len(prompts)
    assert st["paged_attn_int8kv_launches"] == st["paged_attn_launches"] == 0  # CPU: no launch
    if layout != "dense":
        assert st["kv_pool_free"] == st["kv_pool_blocks"] == 6
        kernel = layout == "paged_kernel_route"
        assert st["paged_attn_kernel_ticks" if kernel else "paged_attn_gather_ticks"] \
            == st["decode_ticks"]


def test_kv_int8_auto_raises(weights):
    """"auto" is the reference's TPU-measured router: refused, never
    resolved."""
    _, tp = weights
    cfg = ModelConfig(**DIMS, dtype=torch.float32, kv_int8="auto")
    with pytest.raises(NotImplementedError, match="H100 measurement"):
        ServingEngine(tp, cfg, ServingConfig(slots=1, prefill_buckets=(8,)), device="cpu")
