"""Decoder-only transformer (LLaMA-style) in PyTorch.

Counterpart of vtpu/models/transformer.py, with its layouts kept at every
public function so the two packages compare like with like: activations
[B, S, H, Dh], per-layer weights stacked on a leading axis [L, d_in, d_out]
and applied as ``x @ w``, tied embeddings, caches [L, B, max_seq, H, Dh] and
paged pools [L, n_blocks, page, H, Dh] (``kv_int8``: int8 values with f32
scale planes [..., H] beside them, quantized by ``quantize_kv``).

Differences from the reference, all PyTorch idiom:
- the layer loop is a Python loop (there is no scan/fori_loop split to keep);
- caches are updated IN PLACE (``write_kv`` mutates the pool tensors and the
  step functions return the same dict), which saves a copy of the whole
  cache per step;
- ``cfg.use_kernels`` (for ``use_pallas``) routes prefill to the flash kernel
  at any S and, through ``paged_attn_route``, paged decode to the paged
  kernel (bf16 or int8); on CPU tensors the wrappers run their plain
  versions;
- under a tensor-parallel ``mesh`` (vtpu_torch.parallel.TpMesh) each rank
  runs the trunk on its shard: ``params`` are the rank's shard
  (parallel/sharding.py), caches and pools hold its n_heads / tp heads, and
  the all-reduces XLA places from the reference's shardings are written out
  (``all_reduce_sum`` after ``wo`` and after ``w_down``). ``mesh=None`` is
  the single-device path, unchanged. ``copy_to_axis`` before each
  column-parallel projection is the identity forward; under autograd it
  sums the replicated input's cotangent over the ranks, so training on a
  mesh's 'tp' axis gets the reference's gradients (collectives.py);
- training runs the logits-only ``transformer_forward``: ``prefill`` also
  fills a KV cache, which XLA drops from the reference's loss but which
  would be real memory here, held for the backward.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from vtpu_torch.device import resolve_device
from vtpu_torch.ops import (
    apply_rope, causal_attention, causal_attention_int8kv, flash_attention,
    paged_attn_route, paged_causal_attention, paged_causal_attention_int8kv,
    paged_decode_attention, paged_decode_attention_int8kv, rms_norm, rope_angles,
    scaled_normal,
)
from vtpu_torch.parallel.collectives import all_reduce_sum, copy_to_axis

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
    # int8 KV cache with per-token-per-head f32 scales. Any true value builds
    # int8 caches here; ServingEngine(params, cfg) resolves "auto" first
    # (serving.engine.choose_kv_int8, an H100 measurement)
    kv_int8: bool | str = False

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim


def local_heads(cfg, mesh=None) -> int:
    """Attention heads one rank holds: n_heads, or n_heads / tp under a mesh."""
    return cfg.n_heads if mesh is None else cfg.n_heads // mesh.size


def kv_quantized(cfg) -> bool:
    return bool(getattr(cfg, "kv_int8", False))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, Dh] -> (int8 values, [..., H] f32 absmax/127 scales):
    per-token-per-head symmetric scaling, the scale clamped at 1e-6 / 127,
    rounding half to even as jnp.round does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _kv_planes(cfg, shape: tuple, device) -> dict[str, torch.Tensor]:
    """Zero-filled k/v planes of ``shape`` [..., H, Dh]: cfg.dtype, or int8
    with [..., H] f32 k_scale/v_scale planes."""
    if not kv_quantized(cfg):
        return {key: torch.zeros(shape, dtype=cfg.dtype, device=device) for key in ("k", "v")}
    planes = {key: torch.zeros(shape, dtype=torch.int8, device=device) for key in ("k", "v")}
    for key in ("k_scale", "v_scale"):
        planes[key] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return planes


def kv_keys(cache: dict) -> tuple[str, ...]:
    """The KV planes a cache holds: k/v, plus k_scale/v_scale when int8."""
    return ("k", "v", "k_scale", "v_scale") if "k_scale" in cache else ("k", "v")


def store_kv(cache: dict, l, idx: tuple, k: torch.Tensor, v: torch.Tensor,
             keep: Optional[torch.Tensor] = None) -> None:
    """Write [N, H, Dh] k/v rows at plane ``l`` (a layer, or a slice of
    them with k/v carrying that axis), index ``idx`` of every KV
    plane of ``cache`` in place: as they are, or quantized with their scales
    written beside them for an int8 cache. With ``keep`` ([N] bool) a row
    whose flag is False writes back what its target already holds, so it
    changes no plane: the drop needs no host read of the flags, and the
    write keeps a static shape."""
    if "k_scale" in cache:
        writes = []
        for key, x in (("k", k), ("v", v)):
            xq, sc = quantize_kv(x)
            writes += [(key, xq), (f"{key}_scale", sc)]
    else:
        writes = [("k", k), ("v", v)]
    for key, x in writes:
        plane, at = cache[key], (l, *idx)
        if keep is not None:
            x = torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), x, plane[at])
        plane[at] = x


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


def init_kv_cache(cfg: ModelConfig, batch: int, device=None,
                  mesh=None) -> dict[str, torch.Tensor]:
    """Dense per-row cache [L, batch, max_seq, H, Dh], zero-filled (int8
    with [L, batch, max_seq, H] f32 scale planes when cfg.kv_int8); H is
    the rank's n_heads / tp under a mesh."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_seq, local_heads(cfg, mesh), cfg.head_dim)
    return {**_kv_planes(cfg, shape, device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, slots: int, page: int, n_blocks: int,
                        device=None, mesh=None) -> dict[str, torch.Tensor]:
    """Paged pool state: one block pool per k/v plane [L, n_blocks, page, H,
    Dh] (zero-filled; int8 with [L, n_blocks, page, H] f32 scale pools when
    cfg.kv_int8) plus a per-slot page table [slots, max_seq // page] int32.
    Block 0 is the NULL block: the allocator never hands it out and unmapped
    table entries point at it, so padding reads land on one block every
    reader masks. Under a mesh the pools hold the rank's n_heads / tp heads
    of every block; the table and lengths are whole on every rank."""
    if cfg.max_seq % page:
        raise ValueError(f"kv page {page} must divide max_seq {cfg.max_seq}")
    device = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, page, local_heads(cfg, mesh), cfg.head_dim)
    return {
        "table": torch.zeros((slots, cfg.max_seq // page), dtype=torch.int32, device=device),
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
        **_kv_planes(cfg, shape, device),
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
                  top_k: int = 0, top_p: float = 1.0, return_logprobs: bool = False):
    """Batched on-device sampling: [B, vocab] logits -> [B] int32 tokens.

    temperature 0 is greedy: argmax, the first index on ties. Otherwise
    temperature scaling, an optional top-k cut, an optional nucleus cut
    (the top-1 token always survives), then exact categorical sampling by
    the Gumbel-max trick with row b's noise drawn from ``gens[b]`` — one
    generator per slot, so one slot's stream never depends on another's.

    ``return_logprobs``: return (tokens, logprobs [B] f32), log p(token)
    under the FINAL distribution: the filtered, temperature-scaled logits,
    or the raw logits under greedy."""
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
        x = logits.float()
    else:
        x = filter_logits(logits, temperature, top_k, top_p)
        v = x.shape[-1]
        tiny = torch.finfo(torch.float32).tiny
        u = torch.stack([torch.rand(v, generator=g, device=x.device) for g in gens])
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        tok = torch.argmax(x + gumbel, dim=-1)
    if not return_logprobs:
        return tok.to(torch.int32)
    lp = torch.log_softmax(x, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), lp


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


# What a multi-tick flush writes in its frozen lanes' token columns: sampled
# ids are >= 0, so -1 is never a real token (the host trusts the counts; the
# sentinel keeps the [B, k] matrix self-describing)
LOOP_PAD_TOKEN = -1


def multi_tick_decode(decode_fn, sample_fn, k: int, eos_token: int, logprobs: bool, state,
                      tokens: torch.Tensor, active: torch.Tensor, gens: list,
                      cap: torch.Tensor):
    """``k`` decode ticks in one call with the sampled token fed back on the
    device: inner tick i's token is inner tick i+1's input and never visits
    the host. The serving engine's multi-tick loop (``decode_loop_k``) runs
    this as one flush; on a CUDA card it replays from one graph.

    ``decode_fn(state, tokens [B], active [B]) -> (logits [B, vocab],
    state)`` is one tick of the trunk; ``sample_fn(logits, gens) -> (tok
    [B] int32, logprobs [B] f32 or None)`` the on-device sampler, drawing
    once a tick from each slot's generator.

    Per-slot early exit: a lane freezes the inner tick after it emits its
    cap'th token (``cap`` [B] int32, its remaining budget) or
    ``eos_token``. Its active flag goes False, so later inner ticks drop
    its KV writes like any inactive slot's and its length stops advancing;
    its output columns hold LOOP_PAD_TOKEN. Paged write addresses come
    from the advancing device length, so nothing is read back between
    inner ticks: the call can be captured.

    Returns (out [B, k] int32, counts [B] int32, carry [B] int32, lps
    [B, k] f32 or None, state): ``out[b, :counts[b]]`` are slot b's tokens
    this flush, ``carry`` each slot's last sampled token, the next flush's
    input, still on the device."""
    b = tokens.shape[0]
    dev = tokens.device
    out = torch.full((b, k), LOOP_PAD_TOKEN, dtype=torch.int32, device=dev)
    lps = torch.zeros((b, k), dtype=torch.float32, device=dev) if logprobs else None
    bud0 = torch.where(active, cap.clamp_min(0), 0).to(torch.int32)
    bud, tok, act = bud0, tokens, active
    for i in range(k):
        logits, state = decode_fn(state, tok, act)
        nxt, lp = sample_fn(logits, gens)
        out[:, i] = torch.where(act, nxt, LOOP_PAD_TOKEN)
        if logprobs:
            lps[:, i] = torch.where(act, lp, 0.0)
        bud = bud - act.to(torch.int32)
        # the emitted token is the lane's next input; after a freeze the
        # lane is masked, so the stale value is never observed
        tok = torch.where(act, nxt, tok)
        act = act & (bud > 0) & (nxt != eos_token)
    return out, bud0 - bud, tok, lps, state


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, k: int,
                max_ngram: int) -> torch.Tensor:
    """On-device n-gram draft over a right-aligned token window.

    ``hist`` [B, W] int32 holds each slot's most recent tokens packed at the
    right edge (``hist[:, W-1]`` is the pending token the next tick
    conditions on) and ``hist_len`` [B] counts the real trailing entries.
    For each slot: the most recent earlier occurrence of the longest
    matching suffix n-gram (n = max_ngram down to 1), and the ``k`` tokens
    that followed it; as the host's ``lookup_draft`` does, a match whose
    full k-token continuation fits the window beats a more recent one
    whose continuation runs off the edge (on a periodic stream the most
    recent match abuts the suffix and would propose one real token plus
    zeros). Slots with no match propose zeros: under greedy verification
    the draft moves only the acceptance rate, never the stream.

    Fixed-shape masked arithmetic over [B, W] (``torch.gather`` for the
    continuation, a masked ``amax`` for the most recent start): no host
    read, no shape that depends on the data, so it runs inside a captured
    flush. Longer n-grams overwrite shorter ones, so the longest wins."""
    b, w = hist.shape
    dev = hist.device
    draft = torch.zeros((b, k), dtype=torch.int32, device=dev)
    hist_len = hist_len.long()
    first_real = (w - torch.clamp(hist_len, max=w))[:, None]
    for n in range(1, max_ngram + 1):
        m = w - n  # candidate starts 0..m-1 (the suffix itself excluded)
        if m < 1:
            break
        tail = hist[:, w - n:]
        eq = torch.ones((b, m), dtype=torch.bool, device=dev)
        for j in range(n):
            eq = eq & (hist[:, j:m + j] == tail[:, j:j + 1])
        starts = torch.arange(m, device=dev)[None, :]
        # a candidate is real only inside the slot's valid tail, and a
        # suffix match needs n + 1 real tokens
        ok = eq & (starts >= first_real) & (hist_len >= n + 1)[:, None]
        full = ok & (starts + n + k <= w)
        wfull = torch.where(full, starts, -1).amax(dim=1)
        wany = torch.where(ok, starts, -1).amax(dim=1)
        wstar = torch.where(wfull >= 0, wfull, wany)
        idx = wstar[:, None] + n + torch.arange(k, device=dev)[None, :]
        cont = torch.where(idx < w, torch.gather(hist, 1, idx.clamp(0, w - 1)), 0)
        draft = torch.where((wstar >= 0)[:, None], cont.to(torch.int32), draft)
    return draft


def multi_tick_spec_decode(spec_fn, k: int, spec_tokens: int, ngram: int, eos_token: int,
                           state, tokens: torch.Tensor, active: torch.Tensor,
                           cap: torch.Tensor, hist: torch.Tensor, hist_len: torch.Tensor,
                           k_dyn: Optional[int] = None):
    """Fused speculation: draft and verify as the body of the multi-tick
    loop, so one flush runs up to ``k`` verify ticks of up to
    ``spec_tokens + 1`` tokens each.

    Each inner tick drafts on the device (the pending token plus an
    ``ngram_draft`` continuation from the slot's window, carried through
    the loop) and runs one greedy verify chunk through ``spec_fn(state,
    draft [B, T], active, budget) -> (pred [B, T], count [B], state)``
    (``batched_spec_step``: T = spec_tokens + 1 positions, the accepted
    prefix plus the bonus token counted against the remaining budget).
    The accepted run shifts into the right-aligned window (frozen lanes
    count 0, so theirs stays), the last accepted token is the next tick's
    pending token, and a lane freezes when its budget reaches 0 or an
    accepted position is ``eos_token``. Greedy verification emits the
    model's own argmax at every accepted position, so the stream equals
    plain greedy decode for any draft.

    ``k_dyn`` (a Python int, clamped to [0, k]; None = k) is how many inner
    ticks this call runs: the output keeps the static ``k`` columns, and
    the ticks not run hold LOOP_PAD_TOKEN and zero counts. A captured
    graph has a fixed loop count, so the engine captures one graph per
    k_dyn it may dispatch.

    Returns (out [B, k, spec_tokens+1] int32, counts [B, k] int32, carry
    [B] int32, state): ``out[b, i, :counts[b, i]]`` are slot b's tokens of
    inner tick i."""
    b = tokens.shape[0]
    t = spec_tokens + 1
    w = hist.shape[1]
    dev = tokens.device
    out = torch.full((b, k, t), LOOP_PAD_TOKEN, dtype=torch.int32, device=dev)
    cnts = torch.zeros((b, k), dtype=torch.int32, device=dev)
    bud = torch.where(active, cap.clamp_min(0), 0).to(torch.int32)
    tok, act, hlen = tokens, active, hist_len
    steps = torch.arange(t, device=dev)
    window = torch.arange(w, device=dev)[None, :]
    for i in range(k if k_dyn is None else max(0, min(int(k_dyn), k))):
        cont = ngram_draft(hist, hlen, spec_tokens, ngram)
        draft = torch.cat([tok[:, None], cont], dim=1)
        pred, count, state = spec_fn(state, draft, act, bud)
        accepted = steps[None, :] < count[:, None]
        out[:, i] = torch.where(accepted, pred, LOOP_PAD_TOKEN)
        cnts[:, i] = count
        bud = bud - count
        # an eos freezes the lane after the tick that accepted it (the host
        # truncates the delivered run at the eos)
        hit = (accepted & (pred == eos_token)).any(dim=1)
        # shift the accepted run into the window: a no-op at count 0
        hist = torch.gather(torch.cat([hist, pred], dim=1), 1,
                            count.long()[:, None] + window)
        hlen = torch.clamp(hlen + count, max=w)
        last = torch.gather(pred, 1, (count.long() - 1).clamp(0, t - 1)[:, None])[:, 0]
        tok = torch.where(act & (count > 0), last, tok)
        act = act & (bud > 0) & ~hit
    return out, cnts, tok, state


@functools.lru_cache(maxsize=8)
def _rope_tables(max_seq: int, head_dim: int, device: str):
    # read-only tables, one per (shape, device): decode ticks reuse them
    return rope_angles(max_seq, head_dim, device=device)


def _layer(params: Params, l: int) -> dict[str, torch.Tensor]:
    return {name: w[l] for name, w in params["layers"].items()}


def _qkv(cfg, lp, x, cos, sin, positions, mesh=None):
    """Project to rotated q/k/v heads: [B, S, H, Dh] each (the rank's
    n_heads / tp heads under a mesh)."""
    b, s, _ = x.shape
    h, dh = local_heads(cfg, mesh), cfg.head_dim
    normed = copy_to_axis(rms_norm(x, lp["attn_norm"]), mesh)
    q = (normed @ lp["wq"]).reshape(b, s, h, dh)
    k = (normed @ lp["wk"]).reshape(b, s, h, dh)
    v = (normed @ lp["wv"]).reshape(b, s, h, dh)
    return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v


def _mlp_block(lp, x, mesh=None):
    normed = copy_to_axis(rms_norm(x, lp["mlp_norm"]), mesh)
    gate = F.silu((normed @ lp["w_gate"]).float()).to(x.dtype)
    return all_reduce_sum((gate * (normed @ lp["w_up"])) @ lp["w_down"], mesh)


def attention_block(cfg, lp: dict[str, torch.Tensor], x: torch.Tensor, cos, sin, positions,
                    mesh=None):
    """The attention half of a decoder block over a full sequence, shared by
    every family with an attention trunk (dense and MoE). x: [B, S, D] ->
    (x + attention output, (k, v)). With ``cfg.use_kernels`` attention
    goes to the flash kernel at any S."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, cos, sin, positions, mesh)
    if cfg.use_kernels:
        attn = flash_attention(q, k, v)
    else:
        attn = causal_attention(q, k, v)
    return x + all_reduce_sum(attn.reshape(b, s, -1) @ lp["wo"], mesh), (k, v)


def transformer_layer(cfg: ModelConfig, lp: dict[str, torch.Tensor], x: torch.Tensor,
                      cos, sin, positions, mesh=None):
    """One decoder block over a full sequence. x: [B, S, D] -> (x, (k, v))."""
    x, kv = attention_block(cfg, lp, x, cos, sin, positions, mesh)
    return x + _mlp_block(lp, x, mesh), kv


def _trunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor, mesh, kv: Optional[list]):
    """The full-sequence layer loop: tokens [B, S] -> the final norm's
    output [B, S, D]; each layer's (k, v) appended to ``kv`` when given."""
    b, s = tokens.shape
    if s > cfg.max_seq:
        raise ValueError(f"prompt length {s} exceeds max_seq {cfg.max_seq}")
    dev = tokens.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))
    positions = torch.arange(s, device=dev).expand(b, s)
    x = params["embed"][tokens].to(cfg.dtype)
    for l in range(cfg.n_layers):
        x, layer_kv = transformer_layer(cfg, _layer(params, l), x, cos, sin, positions, mesh)
        if kv is not None:
            kv.append(layer_kv)
    return rms_norm(x, params["final_norm"])


def transformer_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                        mesh=None) -> torch.Tensor:
    """Logits-only full-sequence forward, the training forward: tokens
    [B, S] -> [B, S, vocab] f32, with no KV cache. Under ``mesh`` (a 'tp'
    axis) the rank's shard of params in, logits whole on every rank."""
    x = _trunk(params, cfg, tokens, mesh, None)
    return (x @ params["embed"].T).float()


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            logits_at: Optional[torch.Tensor] = None, mesh=None):
    """Full-sequence forward. tokens: [B, S] int. Returns (logits, kv_cache):
    [B, S, vocab] f32 logits, or [B, vocab] gathered at ``logits_at`` ([B]
    positions) before the vocab projection. An int8 cache stores the
    quantized K/V; the forward itself attends over the unquantized ones.
    Under ``mesh``: the rank's shard of params in, its head shard of the
    cache out, logits whole on every rank."""
    b, s = tokens.shape
    dev = tokens.device
    kv: list = []
    x = _trunk(params, cfg, tokens, mesh, kv)
    cache = fill_kv_cache(init_kv_cache(cfg, b, device=dev, mesh=mesh),
                          torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))
    del kv
    if logits_at is not None:
        x = x[torch.arange(b, device=dev), logits_at]
    logits = (x @ params["embed"].T).float()
    cache["len"].fill_(s)
    return logits, cache


def fill_kv_cache(cache: dict[str, torch.Tensor], ks: torch.Tensor,
                  vs: torch.Tensor) -> dict[str, torch.Tensor]:
    """Write freshly computed [L, B, S, H, Dh] KV into the leading S
    positions of a (possibly int8) cache, in place: in the cache's dtype,
    or quantized with their scales beside them. The prefill fill site.
    Returns the cache."""
    if "k_scale" not in cache:
        ks, vs = ks.to(cache["k"].dtype), vs.to(cache["v"].dtype)
    store_kv(cache, slice(None), (slice(None), slice(0, ks.shape[2])), ks, vs)
    return cache


def decode_step(params: Params, cfg: ModelConfig, cache: dict[str, torch.Tensor],
                token: torch.Tensor, kv_bucket: int = 0):
    """One lockstep autoregressive step (every row at position len[0]).
    token: [B] int. Updates the cache in place; returns (logits [B, vocab],
    cache with len + 1)."""
    pos0 = cache["len"][0]

    def write_kv(l, kv, k, v):
        store_kv(kv, l, (slice(None), pos0), k[:, 0], v[:, 0])
        return kv

    logits, new_kv = decode_layer_loop(params, cfg, cache, token, kv_bucket, write_kv)
    return logits, {**new_kv, "len": cache["len"] + 1}


def decode_layer_loop(params: Params, cfg: ModelConfig, cache: dict[str, torch.Tensor],
                      token: torch.Tensor, kv_bucket: int, write_kv, ffn_fn=None,
                      paged_attn=None, mesh=None):
    """Shared decode-step body: one token per row is a T=1 verify chunk
    through ``spec_verify_loop``. Returns (logits [B, vocab], kv)."""
    logits, new_kv = spec_verify_loop(
        params, cfg, cache, token[:, None], kv_bucket, write_kv,
        ffn_fn=ffn_fn, paged_attn=paged_attn, mesh=mesh)
    return logits[:, 0], new_kv


def spec_verify_loop(params: Params, cfg: ModelConfig, cache: dict[str, torch.Tensor],
                     draft: torch.Tensor, kv_bucket: int, write_kv, ffn_fn=None,
                     paged_attn=None, mesh=None):
    """THE decode trunk: one forward over a [B, T] chunk whose row-i query
    sits at cache position len[b] + i. Each layer first scatters the
    chunk's KV (the caller's ``write_kv(l, kv, k, v) -> kv`` owns offsets,
    bounds and dropped writes), then attends over the read window
    (``kv_bucket`` tokens; 0 = max_seq) under the ragged mask k_pos <
    len[b] + i + 1, which alone encodes intra-chunk causality.

    Paged pools ("table" in cache) read either through the paged kernel
    (the whole pool plus the layer index, walking the table in place) or
    through the gather route, resolved by ``paged_attn_route(paged_attn,
    window, device, T)`` (auto sends T > 16 to gather). Both share the masking and null-block contracts. An
    int8 cache (k_scale/v_scale present) takes the int8 twin of each route.
    Under ``mesh`` the cache is the rank's head shard, the paged kernel runs
    head-local (the reference's ``_shard_body``) and the layer's partial
    sums are all-reduced; a custom ``ffn_fn`` owns its own reduction.
    Returns (logits [B, T, vocab] f32, kv dict)."""
    b, t = draft.shape
    bucket = kv_bucket or cfg.max_seq
    ffn = ffn_fn or functools.partial(_mlp_block, mesh=mesh)
    dev = draft.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))
    lens = cache["len"]
    table = cache.get("table")
    use_kernel = False
    if table is not None:
        page = cache["k"].shape[2]
        table_w = table[:, : bucket // page].contiguous()
        use_kernel = paged_attn_route(paged_attn, bucket, dev, t) == "kernel"
    steps = torch.arange(t, device=dev, dtype=torch.int32)
    # a slot near the context wall still computes, but its out-of-range
    # rows are never written (write_kv drops them) nor emitted; the clip
    # only keeps the rope lookup in range
    positions = torch.clamp(lens[:, None] + steps[None, :], max=cfg.max_seq - 1)
    ragged_len = torch.clamp(lens[:, None] + 1 + steps[None, :], max=cfg.max_seq)
    x = params["embed"][draft].to(cfg.dtype)
    quant = "k_scale" in cache
    kv = {key: cache[key] for key in kv_keys(cache)}
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x, cos, sin, positions, mesh)
        kv = write_kv(l, kv, k, v)
        if use_kernel and quant:
            attn = paged_decode_attention_int8kv(q, kv["k"], kv["k_scale"], kv["v"],
                                                 kv["v_scale"], table_w, ragged_len, layer=l,
                                                 mesh=mesh)
        elif use_kernel:
            attn = paged_decode_attention(q, kv["k"], kv["v"], table_w, ragged_len, layer=l,
                                          mesh=mesh)
        else:
            # one layer's planes; the gather route reads them through the
            # table, the dense cache over its first ``bucket`` positions
            view = ({key: kv[key][l] for key in kv} if table is not None
                    else {key: kv[key][l][:, :bucket] for key in kv})
            if table is not None and quant:
                attn = paged_causal_attention_int8kv(
                    q, view["k"], view["k_scale"], view["v"], view["v_scale"], table_w,
                    kv_len=ragged_len)
            elif table is not None:
                attn = paged_causal_attention(q, view["k"], view["v"], table_w,
                                              kv_len=ragged_len)
            elif quant:
                attn = causal_attention_int8kv(q, view["k"], view["k_scale"], view["v"],
                                               view["v_scale"], kv_len=ragged_len)
            else:
                attn = causal_attention(q, view["k"], view["v"], kv_len=ragged_len)
        x = x + all_reduce_sum(attn.reshape(b, t, -1) @ lp["wo"], mesh)
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
