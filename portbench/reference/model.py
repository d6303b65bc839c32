"""Plain PyTorch reference of the benchmark's configurations: a LLaMA-style
decoder (RMSNorm, half-split rotary embeddings, multi-head attention,
SwiGLU) with a dense MLP or routed experts, in float32 with TF32 off.

It reads the configuration file itself (the published keys as run, see
``portbench/configs``) and the weights the benchmark made, and imports
nothing of the program. It follows the architecture with the departures
the configuration lists: tied embeddings, no QK-norm, the top-k gates
renormalised where ``norm_topk_prob`` is true, and GShard capacity at
admission: an expert takes at most ``capacity`` choices of an admission
batch, first choices before second ones, tokens in row order, and a
choice past it is dropped. Tokens decoded after admission are routed
without a capacity (nothing drops).

``fp8=True`` is the control: every matmul's weights (per output column)
and activations (per row) rounded to float8 e4m3 first, the precision one
step below the configuration's bf16.

Computed layer by layer, each layer's weights widened to float32 only
while it runs, so it fits beside whatever else the card holds.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with a scale per slice along ``dim`` (the
    absmax maps to the largest fp8 value), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [..., in] float32 @ w [in, out] (any dtype), in float32."""
    w = w.float()
    if fp8:
        return _q8(x, -1) @ _q8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x [R, S, H, Dh] at positions 0..S-1, half against half."""
    s, dh = x.shape[1], x.shape[3]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, sn = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads_at_once: int = 8) -> torch.Tensor:
    """Causal softmax attention, [R, S, H, Dh] each, a few heads at a time."""
    r, s, h, dh = q.shape
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, h, heads_at_once):
        hs = slice(h0, h0 + heads_at_once)
        sc = torch.einsum("rqhd,rkhd->rhqk", q[:, :, hs], k[:, :, hs]) / math.sqrt(dh)
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, hs] = torch.einsum("rhqk,rkhd->rqhd", p, v[:, :, hs])
    return out


def _experts(cfg: dict, lp: dict, l: int, h: torch.Tensor, claim: torch.Tensor,
             capacity: int, fp8: bool) -> tuple[torch.Tensor, int]:
    """The routed experts over h [T, D] (rows flattened in order).
    ``claim`` [T] marks the admission's real tokens, which compete for
    ``capacity`` slots an expert; the others route without a limit.
    Returns (output [T, D], choices dropped)."""
    t = h.shape[0]
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(_linear(h, lp["router"][l], fp8), dim=-1)
    gv, gi = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        gv = gv / gv.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones((t, k), dtype=torch.bool, device=h.device)
    taken = torch.zeros((e,), dtype=torch.int64, device=h.device)
    claims = claim.to(torch.int64)[:, None]
    for j in range(k):
        hot = F.one_hot(gi[:, j], e) * claims  # [T, E]
        pos = ((torch.cumsum(hot, 0) - hot + taken) * hot).sum(-1)
        keep[:, j] = ~claim | (pos < capacity)
        taken += hot.sum(0)
    out = torch.zeros_like(h)
    for x in range(e):
        sel = (gi == x) & keep
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gate = (gv * sel)[rows].sum(-1, keepdim=True)
        xe = h[rows]
        a = F.silu(_linear(xe, lp["w_gate"][l, x], fp8)) * _linear(xe, lp["w_up"][l, x], fp8)
        out.index_add_(0, rows, gate * _linear(a, lp["w_down"][l, x], fp8))
    return out, int((~keep).sum())


@contextlib.contextmanager
def _exact_f32():
    """float32 matmuls in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@torch.no_grad()
def logits(cfg: dict, params: dict, rows: list, claim_lens: list, bucket: int,
           target: int, start: int, stop: int, fp8: bool = False) -> tuple[torch.Tensor, int]:
    """Teacher-forced logits of one sequence, with the rows it was admitted
    beside.

    ``rows``: token-id sequences (1-D int tensors on the card), the
    admission batch in its row order; row ``target`` may run on past its
    prompt (its served tokens). ``claim_lens[i]``: row i's prompt length
    (its tokens that competed for expert capacity at admission); the
    capacity is the configuration's formula over len(rows) x ``bucket``.
    Returns (float32 logits [stop - start, vocab] of row ``target`` at
    positions start..stop-1, expert choices dropped)."""
    dev = rows[0].device
    s = max(max(int(r.numel()) for r in rows), bucket)
    tok = torch.zeros((len(rows), s), dtype=torch.long, device=dev)
    claim = torch.zeros((len(rows), s), dtype=torch.bool, device=dev)
    for i, (r, n) in enumerate(zip(rows, claim_lens)):
        tok[i, :r.numel()] = r.long()
        claim[i, :n] = True
    moe = cfg["family"] == "moe"
    if moe:
        capacity = max(1, math.ceil(cfg["num_experts_per_tok"] * len(rows) * bucket
                                    / cfg["num_experts"] * cfg["capacity_factor"]))
    h_, dh = cfg["num_attention_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    lp = params["layers"]
    dropped = 0
    with _exact_f32():
        x = params["embed"][tok].float()
        r = len(rows)
        for l in range(cfg["num_hidden_layers"]):
            a = _rms(x, lp["attn_norm"][l], eps)
            q = _rope(_linear(a, lp["wq"][l], fp8).view(r, s, h_, dh), theta)
            k = _rope(_linear(a, lp["wk"][l], fp8).view(r, s, h_, dh), theta)
            v = _linear(a, lp["wv"][l], fp8).view(r, s, h_, dh)
            x = x + _linear(_attention(q, k, v).reshape(r, s, -1), lp["wo"][l], fp8)
            del q, k, v
            m = _rms(x, lp["mlp_norm"][l], eps)
            if moe:
                out, d = _experts(cfg, lp, l, m.reshape(r * s, -1), claim.reshape(-1),
                                  capacity, fp8)
                x = x + out.view_as(x)
                dropped += d
            else:
                act = F.silu(_linear(m, lp["w_gate"][l], fp8)) * _linear(m, lp["w_up"][l], fp8)
                x = x + _linear(act, lp["w_down"][l], fp8)
        y = _rms(x[target, start:stop], params["final_norm"], eps)
        return _linear(y, params["embed"].T, fp8), dropped
