"""Decode/verify attention kernels: the paged product path that walks the
page table over the pool, and the dense-cache study.

Counterpart of vtpu/ops/decode_attn.py. ``paged_decode_attention`` and
``paged_decode_attention_int8kv`` take the WHOLE pool [L, n_blocks, page, H,
Dh] (int8 pools with [L, n_blocks, page, H] f32 scale pools) plus a layer
index and attend over pool blocks in place: no per-layer slice, no gathered
window. ``decode_attention`` attends over a dense [B, S, H, Dh] cache (bf16,
or int8 with [B, S, H] scales) bounded to a read bucket; like the
reference's, it is on no serving path (the study surface). Each wraps a
hand-written Hopper kernel in vtpu_torch/csrc (paged_decode_attention.cu,
decode_attention.cu) and has its plain version beside it (``*_ref``): the
same split plan, tile walk, online softmax and combine in PyTorch. Every
kernel cuts each (row, head)'s keys across blocks by a plan taken from
shapes alone (``paged_split_plan``, ``dense_split_plan``) and merges the
splits in a second launch; one wrapper call counts one launch. A wrapper
takes the plain version only for CPU tensors; for a CUDA tensor it launches
the kernel or raises.

int8 scales apply after the products exactly as the reference's
``_attend_head`` places them: k_scale on the scores before the mask, max and
exp; v_scale on the probabilities only in P.V, never in the denominator.

Routing: the reference's TPU floors (PAGED_ATTN_MIN_WINDOW*,
PAGED_ATTN_T_FLOORS) were measured on a TPU and are not carried over. Auto
resolves to the kernel on CUDA and to the gather route on the CPU, for bf16
and int8 pools alike; a row that routes some shape away from the kernel on
the card must come from a measurement on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from vtpu_torch.ops import _build

_NEG_INF = -1e30

# ServingConfig.paged_attn / adapter ``paged_attn=`` override values
PAGED_ATTN_ROUTES = ("kernel", "gather")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_T = 16  # queries per row per call the kernels take
DENSE_TILE = 32  # keys per tile of the dense kernel (DENSE_TILE in decode_attention.cu)
# keys per tile of the paged kernels where the page allows (PAGED_TILE in
# paged_decode_attention.cu): gcd(page, PAGED_TILE), so no tile leaves its page
PAGED_TILE = 32
# the split plan of both kernels: no more blocks than SPLIT_BLOCKS (one
# resident wave at four blocks per SM of the H100's 132, what a 32-key
# tile's ring allows) and no split longer than SPLIT_MAX_TILES tiles (a long
# split is a long serial walk for one block), chosen on the H100 by
# hack/torch_decode_split_sweep.py (PERF.md §6)
SPLIT_BLOCKS = 4 * 132
SPLIT_MAX_TILES = 14
_fns: dict = {}  # C symbol -> bound ctypes function, set at first launch


def paged_attn_route(override: Optional[str], window: int, device) -> str:
    """Resolve the paged decode-attention route for one dispatch.

    ``override`` "kernel" or "gather" forces a route; anything else but None
    raises. None (auto) is "kernel" on CUDA and "gather" elsewhere, at every
    ``window`` (the read window in tokens) and for bf16 and int8 pools: no
    floor has been measured on the card yet, so none applies."""
    if override is not None:
        if override not in PAGED_ATTN_ROUTES:
            raise ValueError(
                f"paged_attn must be one of {PAGED_ATTN_ROUTES} or None "
                f"(auto), got {override!r}")
        return override
    return "kernel" if torch.device(device).type == "cuda" else "gather"


def _norm_kv_len(kv_len: torch.Tensor, t: int) -> torch.Tensor:
    if kv_len.dim() == 1:
        if t != 1:
            raise ValueError("[B] kv_len requires T=1 (ragged [B,T] otherwise)")
        kv_len = kv_len[:, None]
    return kv_len


def _check_pool(q: torch.Tensor, pool: torch.Tensor, table: torch.Tensor) -> None:
    if pool.dim() != 5:
        raise ValueError(
            f"expected the WHOLE pool [L, n_blocks, page, H, Dh], got rank "
            f"{pool.dim()} — pass the full buffer, not a per-layer slice")
    if table.dim() != 2 or table.shape[0] != q.shape[0]:
        raise ValueError(
            f"table must be [B, Wp] with B={q.shape[0]}, got {tuple(table.shape)}")


def _check_scales(k_scale, v_scale) -> bool:
    """Whether the call is int8 (both scales given); one alone raises."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale (int8) or neither")
    return k_scale is not None


def _online_partial(q: torch.Tensor, kv_len: torch.Tensor, tiles):
    """The plain tile walk shared by the plain versions: q [B, T, H, Dh],
    kv_len [B, T]; ``tiles`` yields (first key position, k, v, k_scale,
    v_scale) with k, v [B, n, H, Dh] and scales [B, n, H] or None. f32
    max/denominator/accumulator; masked scores selected to -1e30 and their p
    to exactly 0; k_scale on the scores before the mask, v_scale on p after
    the denominator; P cast to q's dtype before P.V. Returns the unnormalised
    partial (m, l [B, H, T], acc [B, H, T, Dh])."""
    b, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().permute(0, 2, 1, 3)  # [B, H, T, Dh]
    lens = kv_len[:, None, :, None]     # [B, 1, T, 1]
    m = torch.full((b, h, t), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, dh), device=q.device)
    for k0, kt, vt, kst, vst in tiles:
        # int8 -> f32 is exact, as the reference's int8 -> q's dtype is
        kt = kt.float().permute(0, 2, 1, 3)  # [B, H, n, Dh]
        vt = vt.float().permute(0, 2, 1, 3)
        ok = k0 + torch.arange(kt.shape[2], device=q.device) < lens
        sc = qf @ kt.transpose(-1, -2) * scale
        if kst is not None:
            sc = sc * kst.permute(0, 2, 1)[:, :, None, :]
        sc = torch.where(ok, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        if vst is not None:
            p = p * vst.permute(0, 2, 1)[:, :, None, :]
        acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vt
        m = m_new
    return m, l, acc


def _combine(parts: list, dtype: torch.dtype) -> torch.Tensor:
    """The splits' partials ``(m, l, acc)`` of ``_online_partial`` into the
    output [B, T, H, Dh]: each live split (l > 0) weighted by exp(m_i - max
    m), divided by the combined l; a (row, query) with no live split gives 0.
    With one split the weight is exp(0) = 1, so this is acc / l exactly."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])
    live = l > 0
    top = torch.where(live, m, _NEG_INF).amax(dim=0)
    w = torch.where(live, torch.exp(m - top), 0.0)
    lsum = (l * w).sum(dim=0)
    num = (acc * w[..., None]).sum(dim=0)
    out = torch.where(lsum[..., None] > 0, num / lsum[..., None].clamp_min(1e-30), 0.0)
    return out.permute(0, 2, 1, 3).to(dtype)


def paged_tile(page: int) -> int:
    """Keys per tile of the paged kernels at this page size: every tile lies
    inside one page."""
    return math.gcd(page, PAGED_TILE)


def _split_plan(bh: int, n_tiles: int) -> int:
    """The split rule of both kernels, over a key range of ``n_tiles`` tiles
    and B x H (row, head) pairs: as many splits as B x H x n_split <=
    SPLIT_BLOCKS allows (blocks past one resident wave wait for a second),
    more only where a split would walk more than SPLIT_MAX_TILES tiles, and
    at most half the tiles, so that with ``split_tiles``'s balanced ranges
    every split walks two tiles or more."""
    want = max(SPLIT_BLOCKS // max(1, bh), -(-n_tiles // SPLIT_MAX_TILES))
    return max(1, min(want, n_tiles // 2))


def paged_split_plan(b: int, h: int, wp: int, page: int) -> int:
    """How many blocks the paged kernels split each (row, head)'s window of
    ``wp`` pages across: ``_split_plan`` over the window's
    ``wp * page / paged_tile(page)`` tiles. A function of B, H, the window
    and the page only (the lengths live on the device). Under a tp mesh the
    wrappers pass the full head count, so a rank's head-local call runs the
    plan, and so the arithmetic, of the full-pool call."""
    return _split_plan(b * h, wp * (page // paged_tile(page)))


def split_tiles(n_tiles: int, n_split: int, i: int) -> range:
    """The tiles split i of ``n_split`` walks, as the kernels cut them:
    [i * n_tiles // n_split, (i + 1) * n_tiles // n_split)."""
    return range(i * n_tiles // n_split, (i + 1) * n_tiles // n_split)


def _heads(q: torch.Tensor, mesh) -> int:
    """The head count the split plan is taken over: the full model's under a
    mesh (q holds n_heads / tp of them)."""
    return q.shape[2] * (1 if mesh is None else mesh.size)


def _paged_ref(q, k_pool, v_pool, table, kv_len, layer, k_scale_pool=None,
               v_scale_pool=None, mesh=None) -> torch.Tensor:
    kv_len = _norm_kv_len(kv_len, q.shape[1])
    _check_pool(q, k_pool, table)
    nb, page = k_pool.shape[1:3]
    tile, wp = paged_tile(page), table.shape[1]
    per_page = page // tile
    n_tiles = wp * per_page
    n_split = paged_split_plan(q.shape[0], _heads(q, mesh), wp, page)
    # an id outside the pool reads the null block 0, as in the kernels
    table = torch.where((table >= 0) & (table < nb), table, 0)

    def tiles(i):
        for j in split_tiles(n_tiles, n_split, i):
            blk, r0 = table[:, j // per_page], (j % per_page) * tile
            rows = slice(r0, r0 + tile)
            yield (j * tile, k_pool[layer, blk, rows], v_pool[layer, blk, rows],
                   None if k_scale_pool is None else k_scale_pool[layer, blk, rows],
                   None if v_scale_pool is None else v_scale_pool[layer, blk, rows])

    return _combine([_online_partial(q, kv_len, tiles(i)) for i in range(n_split)], q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, table: torch.Tensor,
                               kv_len: torch.Tensor, layer: int = 0, mesh=None) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel: the window's sub-page
    tiles cut as ``paged_split_plan`` cuts them, each split walked with the
    online softmax of ``_online_partial``, the splits' partials then
    combined as the kernel's second launch combines them. Same arguments as
    ``paged_decode_attention``."""
    return _paged_ref(q, k_pool, v_pool, table, kv_len, layer, mesh=mesh)


def paged_decode_attention_int8kv_ref(q: torch.Tensor, kq_pool: torch.Tensor,
                                      k_scale_pool: torch.Tensor, vq_pool: torch.Tensor,
                                      v_scale_pool: torch.Tensor, table: torch.Tensor,
                                      kv_len: torch.Tensor, layer: int = 0,
                                      mesh=None) -> torch.Tensor:
    """Plain PyTorch version of the int8 paged kernel: the same split walk
    with the scales placed as in the reference's ``_attend_head``. Same
    arguments as ``paged_decode_attention_int8kv``."""
    return _paged_ref(q, kq_pool, vq_pool, table, kv_len, layer, k_scale_pool, v_scale_pool,
                      mesh)


def _kernel(lib: str, sym: str, argtypes: list):
    fn = _fns.get(sym)
    if fn is None:
        fn = getattr(_build.load(lib), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[sym] = fn
    return fn


def _check_launch(name: str, q: torch.Tensor, kv_len: torch.Tensor, caches: tuple,
                  others: tuple) -> None:
    """Checks shared by every kernel wrapper on a CUDA tensor: q's dtype,
    int32 [B, T] kv_len, T and head_dim in range, every operand contiguous
    on q's device, and 16-byte aligned caches."""
    b, t, _, dh = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 q, got {q.dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b, t):
        raise ValueError(f"kv_len must be int32 [B, T] = {(b, t)}, got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")
    tensors = (q, kv_len) + caches + others
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{name} needs every operand on q's device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous operands")
    if any(x.data_ptr() % 16 for x in caches):
        raise ValueError(f"{name} needs 16-byte aligned caches")
    if not 1 <= t <= _MAX_T or any((dh * x.element_size()) % 16 for x in (q,) + caches):
        raise ValueError(f"unsupported shape: T={t} (1..{_MAX_T}), head_dim={dh} "
                         "(a multiple of 16 bytes in every operand)")


def _check_paged(name: str, q, k_pool, v_pool, table, kv_len, layer,
                 kv_dtype: torch.dtype, scale_pools: tuple = ()) -> int:
    h, dh = q.shape[2:]
    if k_pool.dtype != kv_dtype or v_pool.dtype != kv_dtype:
        raise ValueError(f"{name} takes {kv_dtype} pools, got {k_pool.dtype}, {v_pool.dtype}")
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[3:]) != (h, dh):
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q heads {(h, dh)}")
    for sp in scale_pools:
        if sp.dtype != torch.float32 or sp.shape != k_pool.shape[:4]:
            raise ValueError(f"scale pools must be float32 {tuple(k_pool.shape[:4])}, "
                             f"got {sp.dtype} {tuple(sp.shape)}")
    if table.dtype != torch.int32:
        raise ValueError("table must be int32")
    _check_launch(name, q, kv_len, (k_pool, v_pool), (table,) + scale_pools)
    layer = int(layer)
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} outside the pool's {k_pool.shape[0]} planes")
    return layer


def _check_head_shard(q: torch.Tensor, pools: tuple, mesh) -> None:
    """With a mesh, q and the pools must be one rank's head-local shard: the
    same n_heads / tp heads on every operand (``_shard_body``'s operands)."""
    if mesh is None:
        return
    h = q.shape[2]
    if any(p.shape[3] != h for p in pools):
        raise ValueError(
            f"under a tp={mesh.size} mesh q and the pools must be rank "
            f"{mesh.rank}'s head shard (n_heads / tp heads each), got q heads "
            f"{h} and pool heads {[p.shape[3] for p in pools]}")


def _partials(n_split: int, q: torch.Tensor):
    """The splits' f32 partials [n_split, B, T, H, Dh] and [n_split, B, T, H,
    2], combined by a kernel's second launch; none for one split."""
    if n_split == 1:
        return None, None
    b, t, h, dh = q.shape
    return (torch.empty((n_split, b, t, h, dh), dtype=torch.float32, device=q.device),
            torch.empty((n_split, b, t, h, 2), dtype=torch.float32, device=q.device))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _paged_partials(q: torch.Tensor, pool: torch.Tensor, table: torch.Tensor, mesh):
    """(n_split, part_acc, part_ml) of one paged call: the plan of the full
    head count under a mesh, and its scratch."""
    if q.shape[3] % 8:
        raise ValueError(f"the paged kernels need head_dim % 8 == 0, got {q.shape[3]}")
    n_split = paged_split_plan(q.shape[0], _heads(q, mesh), table.shape[1], pool.shape[2])
    return (n_split, *_partials(n_split, q))


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor, layer: int = 0, mesh=None) -> torch.Tensor:
    """Fused paged decode/verify attention over the block pool in place.

    q: [B, T, H, Dh] (T = 1 for a decode tick, K+1 for a verify chunk);
    k_pool, v_pool: the whole pool [L, n_blocks, page, H, Dh] in q's dtype;
    ``layer`` picks the plane; table: [B, Wp] int32 block ids for the read
    window, padded with the null block 0; kv_len: ragged [B, T] int32 (query
    i of row b reads k_pos < kv_len[b, i]) or [B] with T = 1.

    ``mesh`` (a TpMesh) is the counterpart of the reference's shard_map
    ``_shard_body``: q and the pools are this rank's head shard (H = n_heads
    / tp), tables and lengths replicated, and the same kernel walks the
    head-local pool with no collective, under the split plan of the full
    head count: each rank's output is the head slice of the full-pool call,
    bit for bit. Its launches count under ``paged_decode_attention_tp``."""
    t = q.shape[1]
    kv_len = _norm_kv_len(kv_len, t)
    _check_pool(q, k_pool, table)
    _check_head_shard(q, (k_pool, v_pool), mesh)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, table, kv_len, layer, mesh)
    name = "paged_decode_attention"
    layer = _check_paged(name, q, k_pool, v_pool, table, kv_len, layer, q.dtype)
    b, _, h, dh = q.shape
    out = torch.empty_like(q)
    n_split, part_acc, part_ml = _paged_partials(q, k_pool, table, mesh)
    fn = _kernel(name, "vtpu_paged_decode_attention",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), _ptr(part_acc), _ptr(part_ml), _DTYPES[q.dtype],
             b, t, h, dh, k_pool.shape[1], k_pool.shape[2], table.shape[1], layer, n_split,
             1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    _build.LAUNCHES[name if mesh is None else f"{name}_tp"] += 1
    _build.check(err, name)
    return out


def paged_decode_attention_int8kv(q: torch.Tensor, kq_pool: torch.Tensor,
                                  k_scale_pool: torch.Tensor, vq_pool: torch.Tensor,
                                  v_scale_pool: torch.Tensor, table: torch.Tensor,
                                  kv_len: torch.Tensor, layer: int = 0,
                                  mesh=None) -> torch.Tensor:
    """int8 paged decode/verify attention: int8 value pools [L, n_blocks,
    page, H, Dh] stream as int8 and convert in the kernel; f32 scale pools
    [L, n_blocks, page, H] walk the same table and apply post-product as in
    ``causal_attention_int8kv``. Same table/kv_len/layer contract as
    ``paged_decode_attention``; q (and the output) float32 or bfloat16.
    ``mesh`` as in ``paged_decode_attention``: the scale pools are head
    shards too, and launches count under ``paged_decode_attention_int8kv_tp``."""
    t = q.shape[1]
    kv_len = _norm_kv_len(kv_len, t)
    _check_pool(q, kq_pool, table)
    _check_head_shard(q, (kq_pool, vq_pool), mesh)
    if q.device.type == "cpu":
        return paged_decode_attention_int8kv_ref(q, kq_pool, k_scale_pool, vq_pool,
                                                 v_scale_pool, table, kv_len, layer, mesh)
    name = "paged_decode_attention_int8kv"
    layer = _check_paged(name, q, kq_pool, vq_pool, table, kv_len, layer, torch.int8,
                         (k_scale_pool, v_scale_pool))
    b, _, h, dh = q.shape
    out = torch.empty_like(q)
    n_split, part_acc, part_ml = _paged_partials(q, kq_pool, table, mesh)
    fn = _kernel("paged_decode_attention", "vtpu_paged_decode_attention_int8kv",
                 [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), kq_pool.data_ptr(), k_scale_pool.data_ptr(), vq_pool.data_ptr(),
             v_scale_pool.data_ptr(), table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             _ptr(part_acc), _ptr(part_ml), _DTYPES[q.dtype], b, t, h, dh, kq_pool.shape[1],
             kq_pool.shape[2], table.shape[1], layer, n_split, 1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.LAUNCHES[name if mesh is None else f"{name}_tp"] += 1
    _build.check(err, name)
    return out


def _dense_args(q, k, kv_len, bucket):
    s = k.shape[1]
    bucket = bucket or s
    if bucket > s:
        raise ValueError(f"bucket {bucket} exceeds cache length {s}")
    return _norm_kv_len(kv_len, q.shape[1]), bucket


def dense_split_plan(b: int, h: int, bucket: int) -> int:
    """How many blocks the dense kernel splits each (row, head)'s key range
    [0, bucket) across: ``_split_plan`` over the bucket's DENSE_TILE-key
    tiles. A function of B, H and the bucket only."""
    return _split_plan(b * h, -(-bucket // DENSE_TILE))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         bucket: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel: the cache's first
    ``bucket`` keys cut as ``dense_split_plan`` cuts them, each split walked
    in DENSE_TILE-key tiles with the online softmax of ``_online_partial``,
    the splits' partials then combined as the kernel's second pass combines
    them. Same arguments as ``decode_attention``."""
    _check_scales(k_scale, v_scale)
    kv_len, bucket = _dense_args(q, k, kv_len, bucket)
    n_split = dense_split_plan(q.shape[0], q.shape[2], bucket)
    n_tiles = -(-bucket // DENSE_TILE)

    def tiles(i):
        for j in split_tiles(n_tiles, n_split, i):
            k0, k1 = j * DENSE_TILE, min((j + 1) * DENSE_TILE, bucket)
            yield (k0, k[:, k0:k1], v[:, k0:k1],
                   None if k_scale is None else k_scale[:, k0:k1],
                   None if v_scale is None else v_scale[:, k0:k1])

    return _combine([_online_partial(q, kv_len, tiles(i)) for i in range(n_split)], q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     bucket: int = 0) -> torch.Tensor:
    """Decode/verify attention over a dense cache, bounded to a read bucket.

    q: [B, T, H, Dh] float32 or bfloat16; k, v: [B, S, H, Dh] in q's dtype,
    or int8 with k_scale/v_scale [B, S, H] float32; kv_len: ragged [B, T]
    int32 (query i of row b reads k_pos < kv_len[b, i]) or [B] with T = 1.
    ``bucket`` (0 = S) bounds the reads: keys at or past it are never read,
    and a bucket past S raises. Like the reference's, this entry point is
    the study surface, on no serving path."""
    scaled = _check_scales(k_scale, v_scale)
    kv_len, bucket = _dense_args(q, k, kv_len, bucket)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, k_scale, v_scale, bucket)
    name = "decode_attention_int8kv" if scaled else "decode_attention"
    b, t, h, dh = q.shape
    kv_dtype = torch.int8 if scaled else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(f"{name} takes {kv_dtype} k/v with q {q.dtype}, got "
                         f"{k.dtype}, {v.dtype}")
    if k.dim() != 4 or k.shape != v.shape or (k.shape[0], *k.shape[2:]) != (b, h, dh):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} must be [B, S, H, Dh] "
                         f"with q's B, H, Dh {(b, h, dh)}")
    scales = (k_scale, v_scale) if scaled else ()
    for sc in scales:
        if sc.dtype != torch.float32 or sc.shape != k.shape[:3]:
            raise ValueError(f"scales must be float32 {tuple(k.shape[:3])}, got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    _check_launch(name, q, kv_len, (k, v), scales)
    if dh % 8:
        raise ValueError(f"{name} needs head_dim % 8 == 0, got {dh}")
    out = torch.empty_like(q)
    n_split = dense_split_plan(b, h, bucket)
    part_acc, part_ml = _partials(n_split, q)
    fn = _kernel("decode_attention", "vtpu_decode_attention",
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             k_scale.data_ptr() if scaled else None, v_scale.data_ptr() if scaled else None,
             kv_len.data_ptr(), out.data_ptr(), _ptr(part_acc), _ptr(part_ml),
             _DTYPES[q.dtype], int(scaled), b, t, h, dh, k.shape[1], bucket, n_split,
             1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    _build.LAUNCHES[name] += 1
    _build.check(err, name)
    return out
