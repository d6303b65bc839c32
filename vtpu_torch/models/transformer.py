"""Decoder-only transformer (LLaMA-style) in PyTorch.

Counterpart of vtpu/models/transformer.py, with its layouts kept at every
public function so the two packages compare like with like: activations
[B, S, H, Dh], per-layer weights stacked on a leading axis [L, d_in, d_out]
and applied as ``x @ w``, tied embeddings, caches [L, B, max_seq, H, Dh] and
paged pools [L, n_blocks, page, H, Dh].

Differences from the reference, all PyTorch idiom:
- the layer loop is a Python loop (there is no scan/fori_loop split to keep);
- caches are updated IN PLACE (``write_kv`` mutates the pool tensors and the
  step functions return the same dict), which saves a copy of the whole
  cache per step;
- ``cfg.use_kernels`` (for ``use_pallas``) routes prefill to the flash kernel
  at any S and, through ``paged_attn_route``, paged decode to the paged
  kernel; on CPU tensors both wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from vtpu_torch.device import resolve_device
from vtpu_torch.ops import (
    apply_rope, causal_attention, flash_attention, paged_attn_route,
    paged_causal_attention, paged_decode_attention, rms_norm, rope_angles,
    scaled_normal,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 2048
    d_model: int = 512
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1408
    max_seq: int = 1024
    head_dim: int = 128
    dtype: torch.dtype = torch.bfloat16
    use_kernels: bool = True
    # int8 KV cache: not ported yet (the int8 paged kernel is the next
    # slice); a true value raises where a cache would be built
    kv_int8: bool = False

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim


def kv_quantized(cfg) -> bool:
    return bool(getattr(cfg, "kv_int8", False))


def _require_unquantized(cfg) -> None:
    if kv_quantized(cfg):
        raise NotImplementedError(
            "ModelConfig.kv_int8 is not ported to vtpu_torch yet")


def init_params(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Scaled-normal init from a seeded generator on ``device``; per-layer
    tensors stacked on axis 0, norms at one (the reference's layout)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f, l, qd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.qkv_dim

    def w(shape, fan_in):
        return scaled_normal(gen, shape, fan_in, cfg.dtype)

    return {
        "embed": w((cfg.vocab, d), d),
        "layers": {
            "wq": w((l, d, qd), d),
            "wk": w((l, d, qd), d),
            "wv": w((l, d, qd), d),
            "wo": w((l, qd, d), qd),
            "w_gate": w((l, d, f), d),
            "w_up": w((l, d, f), d),
            "w_down": w((l, f, d), f),
            "attn_norm": torch.ones((l, d), dtype=cfg.dtype, device=device),
            "mlp_norm": torch.ones((l, d), dtype=cfg.dtype, device=device),
        },
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, device=None) -> dict[str, torch.Tensor]:
    """Dense per-row cache [L, batch, max_seq, H, Dh], zero-filled."""
    _require_unquantized(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_seq, cfg.n_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_kv_cache(cfg: ModelConfig, slots: int, page: int, n_blocks: int,
                        device=None) -> dict[str, torch.Tensor]:
    """Paged pool state: one block pool per k/v plane [L, n_blocks, page, H,
    Dh] (zero-filled) plus a per-slot page table [slots, max_seq // page]
    int32. Block 0 is the NULL block: the allocator never hands it out and
    unmapped table entries point at it, so padding reads land on one block
    every reader masks."""
    _require_unquantized(cfg)
    if cfg.max_seq % page:
        raise ValueError(f"kv page {page} must divide max_seq {cfg.max_seq}")
    device = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, page, cfg.n_heads, cfg.head_dim)
    return {
        "table": torch.zeros((slots, cfg.max_seq // page), dtype=torch.int32, device=device),
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def kv_bytes_per_token(cfg) -> int:
    """Device bytes one cached token costs across all layers."""
    per_plane = cfg.n_heads * cfg.head_dim
    if kv_quantized(cfg):
        per_layer = 2 * (per_plane * 1 + cfg.n_heads * 4)
    else:
        per_layer = 2 * per_plane * cfg.dtype.itemsize
    return cfg.n_layers * per_layer


def sample_tokens(logits: torch.Tensor, gens: list, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Batched on-device sampling: [B, vocab] logits -> [B] int32 tokens.

    temperature 0 is greedy: argmax, the first index on ties. Otherwise
    temperature scaling, an optional top-k cut, an optional nucleus cut
    (the top-1 token always survives), then exact categorical sampling by
    the Gumbel-max trick with row b's noise drawn from ``gens[b]`` — one
    generator per slot, so one slot's stream never depends on another's."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = filter_logits(logits, temperature, top_k, top_p)
    v = x.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    u = torch.stack([torch.rand(v, generator=g, device=x.device) for g in gens])
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(x + gumbel, dim=-1).to(torch.int32)


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  top_p: float) -> torch.Tensor:
    """Temperature-scaled f32 logits with dropped entries at -inf: the
    distribution ``sample_tokens`` draws from."""
    x = logits.float() / temperature
    v = x.shape[-1]
    if top_k and top_k < v:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, float("-inf"), x)
    if top_p < 1.0:
        srt = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        keep = mass_before < top_p
        keep[:, 0] = True  # at top_p <= 0 the mass test alone keeps nothing
        thresh = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
        x = torch.where(x < thresh, float("-inf"), x)
    return x


@functools.lru_cache(maxsize=8)
def _rope_tables(max_seq: int, head_dim: int, device: str):
    # read-only tables, one per (shape, device): decode ticks reuse them
    return rope_angles(max_seq, head_dim, device=device)


def _layer(params: Params, l: int) -> dict[str, torch.Tensor]:
    return {name: w[l] for name, w in params["layers"].items()}


def _qkv(cfg, lp, x, cos, sin, positions):
    """Project to rotated q/k/v heads: [B, S, H, Dh] each."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    normed = rms_norm(x, lp["attn_norm"])
    q = (normed @ lp["wq"]).reshape(b, s, h, dh)
    k = (normed @ lp["wk"]).reshape(b, s, h, dh)
    v = (normed @ lp["wv"]).reshape(b, s, h, dh)
    return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v


def _mlp_block(lp, x):
    normed = rms_norm(x, lp["mlp_norm"])
    gate = F.silu((normed @ lp["w_gate"]).float()).to(x.dtype)
    return (gate * (normed @ lp["w_up"])) @ lp["w_down"]


def transformer_layer(cfg: ModelConfig, lp: dict[str, torch.Tensor], x: torch.Tensor,
                      cos, sin, positions):
    """One decoder block over a full sequence. x: [B, S, D] -> (x, (k, v)).
    With ``cfg.use_kernels`` attention goes to the flash kernel at any S."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, cos, sin, positions)
    if cfg.use_kernels:
        attn = flash_attention(q, k, v)
    else:
        attn = causal_attention(q, k, v)
    x = x + attn.reshape(b, s, cfg.qkv_dim) @ lp["wo"]
    x = x + _mlp_block(lp, x)
    return x, (k, v)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            logits_at: Optional[torch.Tensor] = None):
    """Full-sequence forward. tokens: [B, S] int. Returns (logits, kv_cache):
    [B, S, vocab] f32 logits, or [B, vocab] gathered at ``logits_at`` ([B]
    positions) before the vocab projection."""
    b, s = tokens.shape
    if s > cfg.max_seq:
        raise ValueError(f"prompt length {s} exceeds max_seq {cfg.max_seq}")
    dev = tokens.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))
    positions = torch.arange(s, device=dev).expand(b, s)
    x = params["embed"][tokens].to(cfg.dtype)
    cache = init_kv_cache(cfg, b, device=dev)
    for l in range(cfg.n_layers):
        x, (k, v) = transformer_layer(cfg, _layer(params, l), x, cos, sin, positions)
        cache["k"][l, :, :s] = k
        cache["v"][l, :, :s] = v
    x = rms_norm(x, params["final_norm"])
    if logits_at is not None:
        x = x[torch.arange(b, device=dev), logits_at]
    logits = (x @ params["embed"].T).float()
    cache["len"].fill_(s)
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, cache: dict[str, torch.Tensor],
                token: torch.Tensor, kv_bucket: int = 0):
    """One lockstep autoregressive step (every row at position len[0]).
    token: [B] int. Updates the cache in place; returns (logits [B, vocab],
    cache with len + 1)."""
    pos0 = cache["len"][0]

    def write_kv(l, kv, k, v):
        kv["k"][l, :, pos0] = k[:, 0]
        kv["v"][l, :, pos0] = v[:, 0]
        return kv

    logits, new_kv = decode_layer_loop(params, cfg, cache, token, kv_bucket, write_kv)
    return logits, {**new_kv, "len": cache["len"] + 1}


def decode_layer_loop(params: Params, cfg: ModelConfig, cache: dict[str, torch.Tensor],
                      token: torch.Tensor, kv_bucket: int, write_kv, ffn_fn=None,
                      paged_attn=None):
    """Shared decode-step body: one token per row is a T=1 verify chunk
    through ``spec_verify_loop``. Returns (logits [B, vocab], kv)."""
    logits, new_kv = spec_verify_loop(
        params, cfg, cache, token[:, None], kv_bucket, write_kv,
        ffn_fn=ffn_fn, paged_attn=paged_attn)
    return logits[:, 0], new_kv


def spec_verify_loop(params: Params, cfg: ModelConfig, cache: dict[str, torch.Tensor],
                     draft: torch.Tensor, kv_bucket: int, write_kv, ffn_fn=None,
                     paged_attn=None):
    """THE decode trunk: one forward over a [B, T] chunk whose row-i query
    sits at cache position len[b] + i. Each layer first scatters the
    chunk's KV (the caller's ``write_kv(l, kv, k, v) -> kv`` owns offsets,
    bounds and dropped writes), then attends over the read window
    (``kv_bucket`` tokens; 0 = max_seq) under the ragged mask k_pos <
    len[b] + i + 1, which alone encodes intra-chunk causality.

    Paged pools ("table" in cache) read either through the paged kernel
    (the whole pool plus the layer index, walking the table in place) or
    through the gather route, resolved by ``paged_attn_route(paged_attn,
    window, device)``. Both share the masking and null-block contracts.
    Returns (logits [B, T, vocab] f32, kv dict)."""
    b, t = draft.shape
    bucket = kv_bucket or cfg.max_seq
    ffn = ffn_fn or _mlp_block
    dev = draft.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))
    lens = cache["len"]
    table = cache.get("table")
    use_kernel = False
    if table is not None:
        page = cache["k"].shape[2]
        table_w = table[:, : bucket // page].contiguous()
        use_kernel = paged_attn_route(paged_attn, bucket, dev) == "kernel"
    steps = torch.arange(t, device=dev, dtype=torch.int32)
    # a slot near the context wall still computes, but its out-of-range
    # rows are never written (write_kv drops them) nor emitted; the clip
    # only keeps the rope lookup in range
    positions = torch.clamp(lens[:, None] + steps[None, :], max=cfg.max_seq - 1)
    ragged_len = torch.clamp(lens[:, None] + 1 + steps[None, :], max=cfg.max_seq)
    x = params["embed"][draft].to(cfg.dtype)
    kv = {"k": cache["k"], "v": cache["v"]}
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x, cos, sin, positions)
        kv = write_kv(l, kv, k, v)
        if use_kernel:
            attn = paged_decode_attention(q, kv["k"], kv["v"], table_w, ragged_len, layer=l)
        elif table is not None:
            attn = paged_causal_attention(q, kv["k"][l], kv["v"][l], table_w,
                                          kv_len=ragged_len)
        else:
            attn = causal_attention(q, kv["k"][l][:, :bucket], kv["v"][l][:, :bucket],
                                    kv_len=ragged_len)
        x = x + attn.reshape(b, t, cfg.qkv_dim) @ lp["wo"]
        x = x + ffn(lp, x)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["embed"].T).float()
    if table is not None:
        kv = {**kv, "table": table}
    return logits, kv


def greedy_generate(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """Prefill + greedy decode; returns [B, steps] generated ids, the first
    being the argmax of the prefill's last-position logits (the token a
    serving engine streams at admission)."""
    logits, cache = prefill(params, cfg, tokens)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(max(steps - 1, 0)):
        logits, cache = decode_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)[:, :steps]
