"""The split plans of the redesigned kernels against vtpu (CPU, f32).

The dense and paged decode kernels cut each (row, head)'s key range into
splits and combine their partials; their plain versions
(``decode_attention_ref``, ``paged_decode_attention[_int8kv]_ref``) take
the same plans (``dense_split_plan`` / ``paged_split_plan`` /
``split_tiles``), the same tiles (the paged ones sub-page runs that never
cross a page) and the same combine, so these tests hold the combine's
arithmetic against the reference's ``decode_attention`` and
``paged_decode_attention[_int8kv]`` in interpret mode at atol 2e-5, the
reference's own f32 tolerance. The flash kernel's plain version walks FLASH_BLOCK-key tiles
and is held against the reference's ``flash_attention`` (interpret) and
``causal_attention``. The kernels themselves run on a card
(tests/test_torch_kernels.py)."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.ops.attention import causal_attention as j_causal_attention
from vtpu.ops.attention import flash_attention as j_flash_attention
from vtpu.ops.decode_attn import decode_attention as j_decode_attention
from vtpu.ops.decode_attn import paged_decode_attention as j_paged_decode_attention
from vtpu.ops.decode_attn import (
    paged_decode_attention_int8kv as j_paged_decode_attention_int8kv,
)
from vtpu_torch.ops import attention, decode_attn
from vtpu_torch.ops.attention import causal_attention, flash_attention_ref
from vtpu_torch.ops.decode_attn import (
    DENSE_TILE, PAGED_TILE, decode_attention, decode_attention_ref, dense_split_plan,
    paged_decode_attention, paged_decode_attention_int8kv, paged_decode_attention_int8kv_ref,
    paged_decode_attention_ref, paged_split_plan, paged_tile, split_tiles,
)

CSRC = Path(__file__).resolve().parents[1] / "vtpu_torch" / "csrc"


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


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ the split plan


@pytest.mark.parametrize("b", [1, 2, 3, 8, 32, 64])
@pytest.mark.parametrize("h", [1, 2, 4, 8])
def test_split_plan_covers_the_bucket_once_in_whole_tiles(b, h):
    """For every bucket the splits are contiguous, disjoint, cover the
    bucket's tiles exactly once and each walk two tiles or more (one split
    of a one-tile bucket aside) and at most SPLIT_MAX_TILES; the plan asks
    for no more splits than SPLIT_BLOCKS blocks or that cap need, and
    depends on (B, H, bucket) only."""
    for bucket in (1, 63, 64, 65, 127, 128, 129, 300, 1000, 1024, 2048, 4096, 8192):
        n_split = dense_split_plan(b, h, bucket)
        n_tiles = -(-bucket // DENSE_TILE)
        ranges = [split_tiles(n_tiles, n_split, i) for i in range(n_split)]
        walked = [j for r in ranges for j in r]
        assert walked == list(range(n_tiles)), (b, h, bucket)
        assert all(len(r) >= 2 for r in ranges) or (n_split == 1 and n_tiles < 2)
        assert all(len(r) <= decode_attn.SPLIT_MAX_TILES for r in ranges)
        assert 1 <= n_split <= max(1, n_tiles // 2)
        if n_split > 1:  # no more splits than filling the card or capping a walk needs
            assert (b * h * (n_split - 1) < decode_attn.SPLIT_BLOCKS
                    or n_split - 1 < -(-n_tiles // decode_attn.SPLIT_MAX_TILES))
        assert dense_split_plan(b, h, bucket) == n_split  # pure


@pytest.mark.parametrize("b", [1, 4, 32])
@pytest.mark.parametrize("h", [1, 8])
@pytest.mark.parametrize("page", [1, 16, 48, 128])
def test_paged_split_plan_covers_the_window_once_in_whole_tiles(b, h, page):
    """For every window the paged plan's splits cover the window's tiles
    once, contiguously, two tiles or more each (one split of a one-tile
    window aside) and at most SPLIT_MAX_TILES; every tile lies inside one
    page (tiles of gcd(page, PAGED_TILE) keys); no more blocks than
    SPLIT_BLOCKS unless the cap on a walk needs them; and the plan depends
    on (B, H, Wp, page) only."""
    tile = paged_tile(page)
    assert page % tile == 0 and tile <= PAGED_TILE
    for wp in (1, 2, 3, 10, 40, 256):
        n_split = paged_split_plan(b, h, wp, page)
        n_tiles = wp * page // tile
        ranges = [split_tiles(n_tiles, n_split, i) for i in range(n_split)]
        walked = [j for r in ranges for j in r]
        assert walked == list(range(n_tiles)), (b, h, wp, page)
        # a tile's first and last key lie in the same page
        assert all((j * tile) // page == ((j + 1) * tile - 1) // page for j in walked)
        assert all(len(r) >= 2 for r in ranges) or (n_split == 1 and n_tiles < 2)
        assert all(len(r) <= decode_attn.SPLIT_MAX_TILES for r in ranges)
        assert 1 <= n_split <= max(1, n_tiles // 2)
        if n_split > 1:  # no more blocks than a resident wave, or than capping a walk needs
            assert (b * h * n_split <= decode_attn.SPLIT_BLOCKS
                    or n_split <= -(-n_tiles // decode_attn.SPLIT_MAX_TILES))
        assert paged_split_plan(b, h, wp, page) == n_split  # pure


def test_paged_split_plan_at_the_serving_tick():
    """The flagship serving tick (4 slots x 8 heads, a 1280-key window of
    128-key pages) fills one resident wave of 32-key tiles; a tp head shard
    takes the plan of the full head count."""
    assert paged_tile(128) == PAGED_TILE == 32
    assert paged_split_plan(4, 8, 10, 128) == decode_attn.SPLIT_BLOCKS // 32 == 16


def test_split_plan_fills_the_study_cells():
    """The study's cells (batch 8/32 x 8 heads, window 1024/2048) get
    enough splits for several blocks per SM of the H100's 132."""
    for b in (8, 32):
        for s in (1024, 2048):
            n_split = dense_split_plan(b, 8, s)
            assert n_split > 1
            assert b * 8 * n_split >= 2 * 132


def test_kernel_constants_match_the_plain_versions():
    """The plain versions walk the kernels' tiles: FLASH_BLOCK is the flash
    kernel's key tile, DENSE_TILE the dense kernel's and PAGED_TILE the
    paged kernels' (where the page allows)."""
    flash = (CSRC / "flash_attention.cu").read_text()
    dense = (CSRC / "decode_attention.cu").read_text()
    paged = (CSRC / "paged_decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int BK = (\d+);", flash).group(1)) == attention.FLASH_BLOCK
    assert int(re.search(r"constexpr int DENSE_TILE = (\d+);", dense).group(1)) == DENSE_TILE
    assert int(re.search(r"constexpr int PAGED_TILE = (\d+);", paged).group(1)) == PAGED_TILE


# ---------------------------------------- the split walk + combine vs JAX


def _dense_case(case, kv, rng):
    """(q, k, v, lens, k_scale, v_scale, bucket) for one case at B = 2,
    H = 2, Dh = 32 over a 1024-key cache (32 tiles)."""
    b, h, dh, s = 2, 2, 32, 1024
    bucket = 0
    if case == "first_split":  # every later split of every row is empty
        t, lens = 1, np.asarray([[40], [90]], np.int32)
    elif case == "ragged_t4":
        t = 4
        lens = np.asarray([[5, 6, 7, 8], [600, 601, 602, 603]], np.int32)
    else:  # bucket below S, one row's length past it (clipped to the bucket)
        t, bucket = 1, 512
        lens = np.asarray([[300], [700]], np.int32)
    q = _np(rng, b, t, h, dh)
    if kv == "int8":
        k = rng.randint(-127, 128, (b, s, h, dh)).astype(np.int8)
        v = rng.randint(-127, 128, (b, s, h, dh)).astype(np.int8)
        ks = (rng.rand(b, s, h) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(b, s, h) * 0.02 + 1e-3).astype(np.float32)
    else:
        k, v, ks, vs = _np(rng, b, s, h, dh), _np(rng, b, s, h, dh), None, None
    return q, k, v, lens, ks, vs, bucket


@pytest.mark.parametrize("splits", [1, 2, 3, 8, "shipped"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("case", ["first_split", "ragged_t4", "bucket"])
def test_split_ref_matches_jax_decode_kernel(monkeypatch, case, kv, splits):
    """decode_attention_ref under plans of one split, two, an odd count,
    more splits than the rows have non-empty tiles (8 splits of a 1024-key
    cache where every length ends in the first split) and the shipped plan
    (16 splits here), against the reference's decode_attention (interpret
    mode)."""
    rng = np.random.RandomState(11)
    q, k, v, lens, ks, vs, bucket = _dense_case(case, kv, rng)
    n_tiles = -(-(bucket or k.shape[1]) // DENSE_TILE)
    if splits != "shipped":
        monkeypatch.setattr(decode_attn, "SPLIT_BLOCKS", splits * 4)  # B x H = 4
        monkeypatch.setattr(decode_attn, "SPLIT_MAX_TILES", n_tiles)
        assert dense_split_plan(2, 2, bucket or k.shape[1]) == min(splits, n_tiles // 2)
    want = j_decode_attention(*_j(q, k, v, lens, ks, vs), bucket=bucket, interpret=True)
    got = decode_attention_ref(*_t(q, k, v, lens, ks, vs), bucket=bucket)
    _close(got, want, atol=2e-5)
    # the wrapper on CPU tensors runs the same plan
    _close(decode_attention(*_t(q, k, v, lens, ks, vs), bucket=bucket), got, atol=0)


# a window of 16 pages of 16 keys (16 tiles: plans of up to 8 splits) or of
# 8 pages of 40 keys (8-key tiles, five to a page: 40 tiles)
PAGED_SPLIT_CASES = ["flat_t1", "cow_t4", "poisoned_null", "page_40"]


def _paged_split_case(case, kv):
    """(q, pools..., table, lens, layer) at B = 2, H = 2, Dh = 32 over a
    2-plane pool; pools are [k, v] in f32 or [kq, k_scale, vq, v_scale]."""
    rng = np.random.RandomState(21)
    page, wp, nb, layer = (40, 8, 20, 1) if case == "page_40" else (16, 16, 40, 1)
    table = np.zeros((2, wp), np.int32)
    if case == "cow_t4":  # both rows share pages 1-3, row 0 diverges at a copied page 4
        t, layer = 4, 0
        table[0, :4] = [1, 2, 3, 4]
        table[1, :13] = [1, 2, 3] + list(range(5, 15))
        lens = np.asarray([[57, 58, 59, 60], [200, 201, 202, 203]], np.int32)
    elif case == "poisoned_null":  # rows end early, their tables padded with block 0
        t = 1
        table[0, :1], table[1, :3] = [7], [3, 9, 11]
        lens = np.asarray([[3], [37]], np.int32)
    elif case == "page_40":  # every row ends inside an 8-key tile
        t = 1
        table[0, :3], table[1, :8] = [1, 2, 3], list(range(4, 12))
        lens = np.asarray([[101], [317]], np.int32)
    else:
        t = 1
        table[0, :3], table[1, :16] = [1, 2, 3], list(range(4, 20))
        lens = np.asarray([[40], [250]], np.int32)
    q = _np(rng, 2, t, 2, 32)
    shape = (2, nb, page, 2, 32)
    if kv == "int8":
        pools = [rng.randint(-127, 128, shape).astype(np.int8),
                 (rng.rand(*shape[:4]) * 0.02 + 1e-3).astype(np.float32),
                 rng.randint(-127, 128, shape).astype(np.int8),
                 (rng.rand(*shape[:4]) * 0.02 + 1e-3).astype(np.float32)]
        if case == "poisoned_null":
            pools[0][:, 0], pools[1][:, 0], pools[2][:, 0], pools[3][:, 0] = 127, 1e3, -127, 1e3
    else:
        pools = [_np(rng, *shape), _np(rng, *shape)]
        if case == "poisoned_null":
            pools[0][:, 0], pools[1][:, 0] = 1e3, -1e3
    return q, pools, table, lens, layer


@functools.lru_cache(maxsize=None)
def _jax_paged(case, kv):
    """The reference's paged kernel (interpret mode) on a case: one call per
    case, whatever plan the port's plain version takes."""
    q, pools, table, lens, layer = _paged_split_case(case, kv)
    fn = j_paged_decode_attention_int8kv if kv == "int8" else j_paged_decode_attention
    return np.asarray(fn(*_j(q, *pools, table, lens), layer=layer, interpret=True))


@pytest.mark.parametrize("splits", [1, 2, 3, 8, "shipped"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES)
def test_paged_split_ref_matches_jax_paged_kernel(monkeypatch, case, kv, splits):
    """paged_decode_attention[_int8kv]_ref under plans of one split, two, an
    odd count, eight and the shipped plan, against the reference's paged
    kernels (interpret mode): a flat T=1 tick, a ragged T=4 copy-on-write
    chunk whose rows share their prefix pages (most of the short row's
    splits empty), a poisoned null block, and 40-key pages (8-key tiles, no
    multiple of PAGED_TILE)."""
    q, pools, table, lens, layer = _paged_split_case(case, kv)
    page, wp = pools[0].shape[2], table.shape[1]
    n_tiles = wp * page // paged_tile(page)
    if splits != "shipped":
        monkeypatch.setattr(decode_attn, "SPLIT_BLOCKS", splits * 4)  # B x H = 4
        monkeypatch.setattr(decode_attn, "SPLIT_MAX_TILES", n_tiles)
        assert paged_split_plan(2, 2, wp, page) == min(splits, n_tiles // 2)
    ref = paged_decode_attention_int8kv_ref if kv == "int8" else paged_decode_attention_ref
    t = _t(q, *pools, table, lens)
    got = ref(*t, layer)
    _close(got, _jax_paged(case, kv), atol=2e-5)
    # the wrapper on CPU tensors runs the same plan
    wrapper = paged_decode_attention_int8kv if kv == "int8" else paged_decode_attention
    _close(wrapper(*t, layer), got, atol=0)


def test_combine_of_empty_and_live_splits():
    """Rows with no live key give 0 (never NaN) whatever the plan; a row
    live in one split only equals the single-split walk."""
    rng = np.random.RandomState(12)
    q, k, v = _np(rng, 3, 1, 2, 32), _np(rng, 3, 512, 2, 32), _np(rng, 3, 512, 2, 32)
    lens = torch.tensor([[0], [70], [512]], dtype=torch.int32)
    got = decode_attention_ref(*_t(q, k, v), lens)
    assert dense_split_plan(3, 2, 512) > 2
    assert torch.isfinite(got).all() and not got[0].any()
    _close(got[1:], causal_attention(*_t(q, k, v), kv_len=lens[:, 0])[1:], atol=2e-5)


# ------------------------------------------------------------ flash tiles


def test_flash_ref_matches_jax_flash_kernel_at_two_tiles():
    """S = 256: two FLASH_BLOCK q tiles and key tiles, the second q tile
    walking both key tiles (one off-diagonal, one diagonal)."""
    assert attention.FLASH_BLOCK == 128
    rng = np.random.RandomState(13)
    q, k, v = (_np(rng, 2, 256, 2, 32) for _ in range(3))
    got = flash_attention_ref(*_t(q, k, v))
    want = j_flash_attention(*_j(q, k, v), interpret=True)
    _close(got, want, atol=2e-5)


@pytest.mark.parametrize("s", [1, 129, 300])
def test_flash_ref_ragged_s_matches_causal_attention(s):
    """Ragged S: one key, one row past a whole tile, and a last tile of 44
    rows and keys (the kernel masks them)."""
    rng = np.random.RandomState(14)
    q, k, v = (_np(rng, 2, s, 3, 16) for _ in range(3))
    got = flash_attention_ref(*_t(q, k, v))
    _close(got, causal_attention(*_t(q, k, v)), atol=2e-5)
    _close(got, j_causal_attention(*_j(q, k, v)), atol=2e-5)
