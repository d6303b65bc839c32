"""The hand-written CUDA kernels of vtpu_torch against their plain PyTorch
versions, on a card. Every case needs a CUDA device and skips without one.

This file imports neither jax nor vtpu, so it runs on a machine that has
only PyTorch: ``pytest --noconftest -m cuda tests/test_torch_kernels.py``.
Tolerances: f32 atol 2e-5 (summation order only); bf16 atol 2e-2 (both
versions round P and the output to bf16, so a value near a rounding
boundary may land one bf16 ulp apart)."""

import numpy as np
import pytest
import torch

from vtpu_torch.ops import _build, decode_attn
from vtpu_torch.ops.attention import flash_attention, flash_attention_ref
from vtpu_torch.ops.decode_attn import (
    DENSE_TILE, decode_attention, decode_attention_ref, dense_split_plan, paged_decode_attention,
    paged_decode_attention_int8kv, paged_decode_attention_int8kv_ref,
    paged_decode_attention_ref, paged_split_plan, split_tiles,
)
from vtpu_torch.parallel import TpMesh, head_shard

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _tol(dtype) -> float:
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _int8(rng, shape, dev):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)).to(dev)


def _scales(rng, shape, dev):
    # the study's range: [1e-3, 2.1e-2]
    return torch.from_numpy((rng.rand(*shape) * 0.02 + 1e-3).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(2, 1024, 8, 128), (1, 200, 4, 64), (2, 77, 2, 32)])
def test_flash_kernel_matches_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = _build.launches()["flash_attention"]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launches()["flash_attention"] == before + 1
    assert _err(got, flash_attention_ref(q, k, v)) <= 2e-2


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 128, 129, 1000, 1024])
def test_flash_kernel_seq_lens_and_head_dims(dev, s, dh):
    """Ragged and whole 128-key tiles at every head dim. Batch 3 x 8 heads
    takes 64-row q tiles up to S = 129 (fewer 128-row tiles than SMs) and
    128-row tiles at S = 1000 and 1024, so both block shapes run."""
    gen = torch.Generator(device=dev).manual_seed(s * 1000 + dh)
    q, k, v = (torch.randn((3, s, 8, dh), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _err(got, flash_attention_ref(q, k, v)) <= 2e-2


def test_flash_kernel_reads_strided_views(dev):
    """q, k, v as views into one packed [B, S, 3, H, Dh] projection."""
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 300, 3, 4, 128), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    assert _err(got, want) <= 2e-2
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())


PAGED_CASES = ["flat_t1", "ragged_t3", "poisoned_null", "mid_tile", "one_split"]


def _paged_lens(case: str, page: int):
    """(T, kv_len rows) of a paged case over the table [[1, 2, 0, 0], [3, 4,
    5, 0], [6, 7, 8, 1]]: lengths scale with the page, so every page size
    walks the same pages. mid_tile ends every row inside a tile (past the
    first page's tiles at page 48); one_split is flat_t1 under a plan of
    one split."""
    if case in ("flat_t1", "one_split"):
        return 1, [[5], [2 * page + 1], [4 * page]]
    if case == "ragged_t3":
        return 3, [[page + 1, page + 2, page + 3], [2 * page + 6, 2 * page + 7, 2 * page + 8],
                   [4 * page - 2, 4 * page - 1, 4 * page]]
    if case == "mid_tile":
        return 1, [[7], [page + 9], [3 * page + 13]]
    return 1, [[3], [page + 4], [3 * page + 2]]  # poisoned_null


def _paged_plan(monkeypatch, case: str, page: int) -> None:
    if case == "one_split":  # the walk of one block over the whole window
        monkeypatch.setattr(decode_attn, "SPLIT_BLOCKS", 1)
        assert paged_split_plan(3, 4, 4, page) == 1
    else:
        assert paged_split_plan(3, 4, 4, page) > 1


@pytest.mark.parametrize("page", [16, 48])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(dev, monkeypatch, dtype, case, page):
    """Pages of 16 keys (one tile each) and of 48 (three 16-key tiles: no
    tile crosses a page), every row ending in a tile's middle, the null
    block poisoned, and a plan of one split."""
    _paged_plan(monkeypatch, case, page)
    rng = np.random.RandomState(2)
    kp = torch.from_numpy(rng.randn(3, 9, page, 4, 128).astype(np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.randn(3, 9, page, 4, 128).astype(np.float32)).to(dev, dtype)
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], dtype=torch.int32,
                         device=dev)
    if case == "poisoned_null":
        kp[:, 0], vp[:, 0] = 1e3, -1e3
    t, lens = _paged_lens(case, page)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(3, t, 4, 128).astype(np.float32)).to(dev, dtype)
    for layer in (0, 2):
        got = paged_decode_attention(q, kp, vp, table, kv_len, layer)
        torch.cuda.synchronize()
        want = paged_decode_attention_ref(q, kp, vp, table, kv_len, layer)
        assert torch.isfinite(got.float()).all()
        assert _err(got, want) <= (2e-2 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("page", [16, 48])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_int8_kernel_matches_plain(dev, monkeypatch, dtype, case, page):
    _paged_plan(monkeypatch, case, page)
    rng = np.random.RandomState(3)
    shape = (3, 9, page, 4, 128)
    kq, vq = _int8(rng, shape, dev), _int8(rng, shape, dev)
    ks, vs = _scales(rng, shape[:4], dev), _scales(rng, shape[:4], dev)
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], dtype=torch.int32,
                         device=dev)
    if case == "poisoned_null":  # the null block's values and scales: never observable
        kq[:, 0], vq[:, 0], ks[:, 0], vs[:, 0] = 127, -127, 1e3, 1e3
    t, lens = _paged_lens(case, page)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(3, t, 4, 128).astype(np.float32)).to(dev, dtype)
    for layer in (0, 2):
        before = _build.launches()["paged_decode_attention_int8kv"]
        got = paged_decode_attention_int8kv(q, kq, ks, vq, vs, table, kv_len, layer)
        torch.cuda.synchronize()
        assert _build.launches()["paged_decode_attention_int8kv"] == before + 1
        want = paged_decode_attention_int8kv_ref(q, kq, ks, vq, vs, table, kv_len, layer)
        assert torch.isfinite(got.float()).all()
        assert _err(got, want) <= _tol(dtype)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["ragged_t4", "flat_t1", "multi_tile", "bucket",
                                  "first_split_only", "ragged_t16"])
def test_dense_decode_kernel_matches_plain(dev, dtype, kv, case):
    """decode_attention's kernel against its plain version: ragged T=4,
    [B] lengths at T=1, a long multi-tile window, a bucket that bounds the
    reads below S (keys past it hold garbage that must not be read), rows
    whose keys all lie in the first of 16 splits (every later split empty;
    one row has no key at all and must give 0), and a ragged T=16 verify
    chunk."""
    rng = np.random.RandomState(4)
    b, h, dh, bucket = 2, 4, 128, 0
    if case == "ragged_t4":
        t, s, lens = 4, 256, [[5, 6, 7, 8], [200, 201, 202, 203]]
    elif case == "first_split_only":
        t, s, lens = 1, 1024, [[50], [0]]
        n_split = dense_split_plan(b, h, s)
        assert n_split > 2 and 50 <= len(split_tiles(-(-s // DENSE_TILE), n_split, 0)) * DENSE_TILE
    elif case == "ragged_t16":
        t, s = 16, 512
        lens = [list(range(5, 21)), list(range(400, 416))]
    elif case == "flat_t1":
        t, s, lens = 1, 256, [5, 200]
    elif case == "multi_tile":
        t, s, lens = 1, 1024, [[700], [1024]]
    else:
        t, s, bucket, lens = 1, 1024, 300, [[100], [1024]]
    shape = (b, s, h, dh)
    if kv == "int8":
        k, v = _int8(rng, shape, dev), _int8(rng, shape, dev)
        ks, vs = _scales(rng, shape[:3], dev), _scales(rng, shape[:3], dev)
    else:
        k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
                for _ in range(2))
        ks = vs = None
    if bucket:
        if kv == "int8":
            k[:, bucket:], v[:, bucket:], ks[:, bucket:], vs[:, bucket:] = 127, -127, 1e3, 1e3
        else:
            k[:, bucket:], v[:, bucket:] = 1e3, -1e3
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(b, t, h, dh).astype(np.float32)).to(dev, dtype)
    name = "decode_attention_int8kv" if kv == "int8" else "decode_attention"
    before = _build.launches()[name]
    got = decode_attention(q, k, v, kv_len, ks, vs, bucket=bucket)
    torch.cuda.synchronize()
    assert _build.launches()[name] == before + 1
    want = decode_attention_ref(q, k, v, kv_len, ks, vs, bucket=bucket)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= _tol(dtype)
    if case == "first_split_only":
        assert not got[1].float().abs().any()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_head_local_paged_kernel_matches_full_pool_head_slice(dev, kv, tp):
    """The paged kernels under a tp mesh (the reference's ``_shard_body``):
    each rank's call on its head shard of q and the pools (scale pools too)
    equals the head slice of the full-pool kernel's output. A (row, head)'s
    arithmetic depends only on its tiles and the split plan, and a mesh
    call takes the plan of the full head count, so the two run the same
    arithmetic: held bitwise. Launches count under the _tp names."""
    rng = np.random.RandomState(5)
    shape = (3, 9, 16, 8, 128)
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], dtype=torch.int32,
                         device=dev)
    kv_len = torch.tensor([[17, 18], [38, 39], [63, 64]], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(3, 2, 8, 128).astype(np.float32)).to(dev, torch.bfloat16)
    if kv == "int8":
        pools = (_int8(rng, shape, dev), _scales(rng, shape[:4], dev),
                 _int8(rng, shape, dev), _scales(rng, shape[:4], dev))
        axes, fn, name = (-2, -1, -2, -1), paged_decode_attention_int8kv, \
            "paged_decode_attention_int8kv_tp"
    else:
        pools = tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32))
                      .to(dev, torch.bfloat16) for _ in range(2))
        axes, fn, name = (-2, -2), paged_decode_attention, "paged_decode_attention_tp"
    for layer in (0, 2):
        whole = fn(q, *pools, table, kv_len, layer)
        for rank in range(tp):
            mesh = TpMesh(rank=rank, size=tp, device=dev)
            before = _build.launches()[name]
            got = fn(head_shard(q, -2, mesh), *(head_shard(x, ax, mesh)
                                                for x, ax in zip(pools, axes)),
                     table, kv_len, layer, mesh=mesh)
            torch.cuda.synchronize()
            assert _build.launches()[name] == before + 1
            assert torch.equal(got, head_shard(whole, -2, mesh))


def test_decode_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 1, 2, 8), device=dev)
    k8 = torch.zeros((1, 16, 2, 8), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 16, 2), device=dev)
    lens = torch.tensor([4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        decode_attention(q, k8, k8, lens, sc, sc)  # int8 head_dim 8: 8 bytes
    with pytest.raises(ValueError, match="takes torch.int8"):
        decode_attention(q, k8.float(), k8.float(), lens, sc, sc)
    with pytest.raises(ValueError, match="scales must be float32"):
        decode_attention(q, k8, k8, lens, sc.double(), sc)
    pool = torch.zeros((1, 2, 16, 2, 16), dtype=torch.int8, device=dev)
    spool = torch.ones((1, 2, 16, 2), device=dev)
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    q16 = torch.zeros((1, 1, 2, 16), device=dev)
    with pytest.raises(ValueError, match="outside the pool"):
        paged_decode_attention_int8kv(q16, pool, spool, pool, spool, table, lens, layer=1)
    with pytest.raises(ValueError, match="scale pools must be float32"):
        paged_decode_attention_int8kv(q16, pool, spool[..., :1], pool, spool, table, lens)
