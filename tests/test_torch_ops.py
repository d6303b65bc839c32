"""vtpu_torch.ops against vtpu.ops on the same numpy inputs (CPU, f32).

Held at the reference's own tolerances (tests/test_ops.py,
tests/test_paged_attn_kernel.py): rtol 1e-4 or atol 2e-5 in f32. Where the
JAX side reaches Pallas it runs in interpret mode, as the reference's tests
run it on the CPU; the port's kernel wrappers take their plain versions on
CPU tensors (tests/test_torch_kernels.py runs the kernels themselves on a
card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.ops import (
    apply_rope as j_apply_rope,
    causal_attention as j_causal_attention,
    flash_attention as j_flash_attention,
    gather_kv_pages as j_gather_kv_pages,
    paged_causal_attention as j_paged_causal_attention,
    paged_decode_attention as j_paged_decode_attention,
    rms_norm as j_rms_norm,
    rope_angles as j_rope_angles,
)
from vtpu_torch.ops import (
    apply_rope,
    causal_attention,
    flash_attention,
    flash_attention_ref,
    gather_kv_pages,
    paged_attn_route,
    paged_causal_attention,
    paged_decode_attention,
    paged_decode_attention_ref,
    rms_norm,
    rope_angles,
)
from vtpu_torch.ops import _build

# the reference's paged test tables: null-padded rows, block 1 reused
TABLE = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], np.int32)
LENS = np.asarray([[9, 10], [20, 21], [31, 32]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    # keeps these tests from crowding the timing-sensitive suites beside them
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x, w = _np(rng, 2, 5, 16), _np(rng, 16)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           j_rms_norm(jnp.asarray(x), jnp.asarray(w)), rtol=1e-4)


def test_rope_matches_jax():
    rng = np.random.RandomState(1)
    cos, sin = rope_angles(32, 16)
    jcos, jsin = j_rope_angles(32, 16)
    _close(cos, jcos, atol=1e-6)
    _close(sin, jsin, atol=1e-6)
    x = _np(rng, 2, 7, 2, 16)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    got = apply_rope(torch.from_numpy(x), cos, sin, torch.from_numpy(pos.copy()))
    want = j_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    _close(got, want, rtol=1e-4, atol=1e-6)
    # position 0 is the identity, and the half-split rotation keeps norms
    zero = apply_rope(torch.from_numpy(x), cos, sin, torch.zeros((2, 7), dtype=torch.int32))
    _close(zero, x, atol=1e-6)
    _close(got.norm(dim=-1), np.linalg.norm(x, axis=-1), rtol=1e-5)


@pytest.mark.parametrize("form", ["causal", "flat", "ragged"])
def test_causal_attention_mask_forms_match_jax(form):
    rng = np.random.RandomState(2)
    q, k, v = _np(rng, 2, 3, 2, 16), _np(rng, 2, 8, 2, 16), _np(rng, 2, 8, 2, 16)
    if form == "causal":
        q = _np(rng, 2, 8, 2, 16)
        kv_len = None
    elif form == "flat":
        kv_len = np.asarray([5, 8], np.int32)
    else:
        kv_len = np.asarray([[4, 5, 6], [6, 7, 8]], np.int32)
    got = causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           None if kv_len is None else torch.from_numpy(kv_len))
    want = j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if kv_len is None else jnp.asarray(kv_len))
    _close(got, want, atol=2e-5)


def test_gather_and_paged_causal_attention_match_jax():
    rng = np.random.RandomState(3)
    kp, vp = _np(rng, 9, 8, 2, 16), _np(rng, 9, 8, 2, 16)
    q = _np(rng, 3, 2, 2, 16)
    _close(gather_kv_pages(torch.from_numpy(kp), torch.from_numpy(TABLE)),
           j_gather_kv_pages(jnp.asarray(kp), jnp.asarray(TABLE)), atol=0)
    got = paged_causal_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(TABLE),
                                 torch.from_numpy(LENS))
    want = j_paged_causal_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(TABLE), kv_len=jnp.asarray(LENS))
    _close(got, want, atol=2e-5)


def test_flash_ref_matches_jax_flash_kernel():
    rng = np.random.RandomState(4)
    q, k, v = (_np(rng, 1, 128, 2, 32) for _ in range(3))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    want = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    _close(got, want, atol=2e-5)


def test_flash_ref_ragged_s_matches_causal_attention():
    """S = 200: the last q and key tiles are ragged (the kernel masks them)."""
    rng = np.random.RandomState(5)
    q, k, v = (_np(rng, 2, 200, 3, 16) for _ in range(3))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    _close(got, causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v)), atol=2e-5)
    _close(got, j_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
           atol=2e-5)


def test_flash_wrapper_runs_plain_version_on_cpu_without_launch():
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(_np(rng, 1, 70, 2, 16)) for _ in range(3))
    before = _build.launches()["flash_attention"]
    _close(flash_attention(q, k, v), flash_attention_ref(q, k, v), atol=0)
    assert _build.launches()["flash_attention"] == before


def _paged_case(name):
    rng = np.random.RandomState(7)
    kp, vp = _np(rng, 2, 9, 8, 2, 16), _np(rng, 2, 9, 8, 2, 16)
    layer = 1
    if name == "flat_t1":
        q, table, lens = _np(rng, 3, 1, 2, 16), TABLE, np.asarray([5, 17, 32], np.int32)
    elif name == "ragged_t3":
        q, table = _np(rng, 3, 3, 2, 16), TABLE
        lens = np.asarray([[9, 10, 11], [19, 20, 21], [30, 31, 32]], np.int32)
    elif name == "poisoned_null":
        kp[:, 0], vp[:, 0] = 1e3, -1e3
        q = _np(rng, 2, 1, 2, 16)
        table, lens = np.asarray([[2, 0, 0, 0], [7, 3, 0, 0]], np.int32), np.asarray([3, 11], np.int32)
    else:  # cow: shared prefix blocks, a copied boundary block per row
        q = _np(rng, 2, 1, 2, 16)
        table = np.asarray([[1, 2, 3, 0], [1, 2, 4, 0]], np.int32)
        lens, layer = np.asarray([21, 23], np.int32), 0
    return q, kp, vp, table, lens, layer


@pytest.mark.parametrize("case", ["flat_t1", "ragged_t3", "poisoned_null", "cow"])
def test_paged_ref_matches_jax_paged_kernel(case):
    q, kp, vp, table, lens, layer = _paged_case(case)
    want = j_paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(table), jnp.asarray(lens), layer=layer,
                                    interpret=True)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    _close(paged_decode_attention_ref(*t, layer=layer), want, atol=2e-5)
    # the wrapper on CPU tensors is the plain version, with no launch
    before = _build.launches()["paged_decode_attention"]
    _close(paged_decode_attention(*t, layer=layer), want, atol=2e-5)
    assert _build.launches()["paged_decode_attention"] == before
    # and the gather route reads the same window
    _close(paged_causal_attention(t[0], t[1][layer], t[2][layer], t[3], t[4]), want,
           atol=2e-5)


def test_paged_contract_errors():
    q, kp, vp, table, lens, _ = _paged_case("flat_t1")
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    with pytest.raises(ValueError, match="WHOLE pool"):
        paged_decode_attention(t[0], t[1][0], t[2][0], t[3], t[4])
    with pytest.raises(ValueError, match="ragged"):
        paged_decode_attention(torch.zeros((3, 2, 2, 16)), t[1], t[2], t[3], t[4])


def test_paged_attn_route():
    """Overrides force a route; auto is the kernel on CUDA and the gather
    route elsewhere, at every window (no TPU floor carried over)."""
    for window in (16, 1280, 8192):
        assert paged_attn_route(None, window, "cpu") == "gather"
        assert paged_attn_route(None, window, torch.device("cuda")) == "kernel"
        assert paged_attn_route("gather", window, "cuda") == "gather"
        assert paged_attn_route("kernel", window, "cpu") == "kernel"
    with pytest.raises(ValueError, match="paged_attn must be one of"):
        paged_attn_route("fused", 1024, "cuda")
