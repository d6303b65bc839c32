"""Paged decode/verify attention that walks the page table over the pool.

Counterpart of the product path in vtpu/ops/decode_attn.py.
``paged_decode_attention`` takes the WHOLE pool [L, n_blocks, page, H, Dh]
plus a layer index and attends over pool blocks in place: no per-layer
slice, no gathered window. It wraps the hand-written Hopper kernel in
vtpu_torch/csrc/paged_decode_attention.cu; ``paged_decode_attention_ref``
beside it is the plain version, the same page-by-page online softmax in
PyTorch. The wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.

Routing: the reference's TPU floors (PAGED_ATTN_MIN_WINDOW*,
PAGED_ATTN_T_FLOORS) were measured on a TPU and are not carried over. Auto
resolves to the kernel on CUDA and to the gather route on the CPU; a row
that routes some shape away from the kernel on the card must come from a
measurement on the card.
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
_MAX_T = 16  # queries per slot per call the kernel takes
_paged_fn = None


def paged_attn_route(override: Optional[str], window: int, device) -> str:
    """Resolve the paged decode-attention route for one dispatch.

    ``override`` "kernel" or "gather" forces a route; anything else but None
    raises. None (auto) is "kernel" on CUDA and "gather" elsewhere, at every
    ``window`` (the read window in tokens): no window floor has been
    measured on the card yet, so none applies."""
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


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, table: torch.Tensor,
                               kv_len: torch.Tensor, layer: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: walk the table page by page with
    an online softmax (f32 max/denominator/accumulator; masked scores
    selected to -1e30 and their p to exactly 0; P cast to q's dtype before
    P.V). Same arguments as ``paged_decode_attention``."""
    t = q.shape[1]
    kv_len = _norm_kv_len(kv_len, t)
    _check_pool(q, k_pool, table)
    b, _, h, dh = q.shape
    page = k_pool.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().permute(0, 2, 1, 3)  # [B, H, T, Dh]
    lens = kv_len[:, None, :, None]     # [B, 1, T, 1]
    m = torch.full((b, h, t), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, dh), device=q.device)
    for j in range(table.shape[1]):
        blk = table[:, j]
        kt = k_pool[layer, blk].float().permute(0, 2, 1, 3)  # [B, H, page, Dh]
        vt = v_pool[layer, blk].float().permute(0, 2, 1, 3)
        ok = j * page + torch.arange(page, device=q.device) < lens
        sc = torch.where(ok, qf @ kt.transpose(-1, -2) * scale, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vt
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l[..., None].clamp_min(1e-30), 0.0)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _paged_kernel():
    global _paged_fn
    if _paged_fn is None:
        fn = _build.load("paged_decode_attention").vtpu_paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _paged_fn = fn
    return _paged_fn


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor, layer: int = 0) -> torch.Tensor:
    """Fused paged decode/verify attention over the block pool in place.

    q: [B, T, H, Dh] (T = 1 for a decode tick, K+1 for a verify chunk);
    k_pool, v_pool: the whole pool [L, n_blocks, page, H, Dh]; ``layer``
    picks the plane; table: [B, Wp] int32 block ids for the read window,
    padded with the null block 0; kv_len: ragged [B, T] int32 (query i of row
    b reads k_pos < kv_len[b, i]) or [B] with T = 1."""
    t = q.shape[1]
    kv_len = _norm_kv_len(kv_len, t)
    _check_pool(q, k_pool, table)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, table, kv_len, layer)
    b, _, h, dh = q.shape
    n_layers, nb, page = k_pool.shape[:3]
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention takes float32 or bfloat16 q "
                         f"and pools of q's dtype, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[3:]) != (h, dh):
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q heads {(h, dh)}")
    if table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("table and kv_len must be int32")
    if tuple(kv_len.shape) != (b, t):
        raise ValueError(f"kv_len must be [B, T] = {(b, t)}, got {tuple(kv_len.shape)}")
    tensors = (q, k_pool, v_pool, table, kv_len)
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged_decode_attention needs every operand on q's device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_decode_attention needs contiguous operands")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention needs 16-byte aligned pools")
    if not 1 <= t <= _MAX_T or (dh * q.element_size()) % 16:
        raise ValueError(f"unsupported shape: T={t} (1..{_MAX_T}), head_dim={dh} "
                         "(a multiple of 16 bytes)")
    layer = int(layer)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the pool's {n_layers} planes")
    out = torch.empty_like(q)
    fn = _paged_kernel()
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, t, h, dh, nb,
             page, table.shape[1], layer, 1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.LAUNCHES["paged_decode_attention"] += 1
    _build.check(err, "paged_decode_attention")
    return out
