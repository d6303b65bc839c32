"""Causal attention: the plain PyTorch paths plus the flash-prefill kernel.

Counterpart of vtpu/ops/attention.py. ``causal_attention``,
``gather_kv_pages`` and ``paged_causal_attention``, with their int8-KV
twins ``causal_attention_int8kv`` and ``paged_causal_attention_int8kv``,
are the plain (gather) route and keep the reference's masking contract
verbatim: kv_len None is plain causal (prefill), [B] is the causal suffix
plus per-row validity (lockstep decode), [B, Sq] is the ragged per-query
form (speculative verify and the serving decode trunk).

``flash_attention`` is the wrapper of the hand-written Hopper kernel in
vtpu_torch/csrc/flash_attention.cu; ``flash_attention_ref`` beside it is its
plain version, the same tiled online-softmax arithmetic in PyTorch. The
wrapper takes the plain version only for CPU tensors; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vtpu_torch.ops import _build

_NEG_INF = -1e30


def _causal_mask(sq: int, sk: int, kv_len: torch.Tensor | None,
                 device) -> torch.Tensor:
    """Broadcastable [*, 1, Sq, Sk] boolean mask for the three kv_len forms."""
    k_pos = torch.arange(sk, device=device)
    if kv_len is not None and kv_len.dim() == 2:
        return (k_pos[None, None, :] < kv_len[:, :, None])[:, None]
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    mask = k_pos[None, :] <= q_pos
    if kv_len is not None:
        valid = k_pos[None, :] < kv_len[:, None]
        return (mask[None] & valid[:, None])[:, None]
    return mask[None, None]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Reference causal attention. q: [B, Sq, H, Dh]; k, v: [B, Sk, H, Dh]
    with Sk >= Sq; kv_len None, [B] or ragged [B, Sq] (see module doc).
    Scores and softmax in f32; probabilities cast to v's dtype for P.V."""
    sq, dh = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(_causal_mask(sq, sk, kv_len, q.device), scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def causal_attention_int8kv(q: torch.Tensor, kq: torch.Tensor, k_scale: torch.Tensor,
                            vq: torch.Tensor, v_scale: torch.Tensor,
                            kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Causal attention over an int8-quantized KV window. q: [B, Sq, H, Dh];
    kq, vq: [B, Sk, H, Dh] int8; k_scale, v_scale: [B, Sk, H] f32; kv_len as
    in ``causal_attention``. The scales apply after the products, never to
    the operands: k_scale multiplies the f32 scores before the mask and
    softmax, v_scale the probabilities after it; the probabilities are cast
    to q's dtype before P.V and the int8 values enter both products as
    values of q's dtype (int8 -> bf16 -> f32 is exact)."""
    sq, dh = q.shape[1], q.shape[3]
    sk = kq.shape[1]
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()) * scale
    scores = scores * k_scale.permute(0, 2, 1)[:, :, None, :]  # [B, H, 1, Sk]
    scores = torch.where(_causal_mask(sq, sk, kv_len, q.device), scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1) * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), vq.to(q.dtype))
    return out.to(q.dtype)


def gather_kv_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One layer's plane [n_blocks, page, ...] gathered through table [B, Wp]
    into [B, Wp * page, ...], positionally identical to a dense cache
    prefix. Padding entries name the null block 0, masked by every reader."""
    b, wp = table.shape
    g = pool[table]
    return g.reshape((b, wp * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_causal_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Gather each slot's pages from one layer's plane, then the reference
    attention (the gather route of the paged decode read)."""
    k = gather_kv_pages(k_pool, table)
    v = gather_kv_pages(v_pool, table)
    return causal_attention(q, k, v, kv_len=kv_len)


def paged_causal_attention_int8kv(q: torch.Tensor, kq_pool: torch.Tensor,
                                  k_scale_pool: torch.Tensor, vq_pool: torch.Tensor,
                                  v_scale_pool: torch.Tensor, table: torch.Tensor,
                                  kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Paged ``causal_attention_int8kv``: one layer's int8 value planes
    [n_blocks, page, H, Dh] and f32 scale planes [n_blocks, page, H],
    gathered through the same table, then the int8-window attention."""
    return causal_attention_int8kv(
        q, gather_kv_pages(kq_pool, table), gather_kv_pages(k_scale_pool, table),
        gather_kv_pages(vq_pool, table), gather_kv_pages(v_scale_pool, table), kv_len=kv_len)


# keys per K/V tile of the CUDA kernel (its BK), and the plain version's q
# tile: a row's visited key tiles are those up to its own diagonal tile
# whatever the kernel's q tile (128 or 64 rows), so the arithmetic is the same
FLASH_BLOCK = 128
_FLASH_DH = (32, 64, 128)
_flash_fn = None


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel: FLASH_BLOCK-row q tiles,
    FLASH_BLOCK-key tiles up to the causal diagonal, online softmax in f32, P
    rounded to the input dtype before P.V. Any S (the last tiles are
    ragged)."""
    b, s, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().permute(0, 2, 1, 3)
    vh = v.float().permute(0, 2, 1, 3)
    out = torch.empty((b, h, s, dh), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, FLASH_BLOCK):
        q1 = min(q0 + FLASH_BLOCK, s)
        qt = qh[:, :, q0:q1]
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((b, h, q1 - q0), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, q1 - q0), device=q.device)
        acc = torch.zeros((b, h, q1 - q0, dh), device=q.device)
        for k0 in range(0, q0 + 1, FLASH_BLOCK):
            k1 = min(k0 + FLASH_BLOCK, s)
            ok = torch.arange(k0, k1, device=q.device)[None, :] <= q_pos
            sc = qt @ kh[:, :, k0:k1].transpose(-1, -2) * scale
            sc = torch.where(ok, sc, _NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(q.dtype).float() @ vh[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _flash_kernel():
    global _flash_fn
    if _flash_fn is None:
        fn = _build.load("flash_attention").vtpu_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _flash_fn = fn
    return _flash_fn


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention for prefill. q, k, v: [B, S, H, Dh], any S.

    On a CUDA tensor this launches the Hopper kernel (bfloat16, wgmma with
    TMA loads; q/k/v read in place through their strides, which must be
    multiples of 8 elements with a unit head_dim stride) or raises; on a
    CPU tensor it runs the plain version ``flash_attention_ref``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"flash_attention needs equal [B, S, H, Dh] q/k/v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention on CUDA takes bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError("flash_attention needs q, k, v on one CUDA device")
    b, s, h, dh = q.shape
    if dh not in _FLASH_DH:
        raise ValueError(f"flash_attention supports head_dim {_FLASH_DH}, got {dh}")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    for x in (q, k, v):
        if x.stride(3) != 1 or any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError("flash_attention needs a unit head_dim stride, other "
                             "strides in multiples of 8 and 16-byte aligned bases")
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _flash_kernel()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, dh,
             strides, 1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    _build.LAUNCHES["flash_attention"] += 1
    _build.check(err, "flash_attention")
    return out
