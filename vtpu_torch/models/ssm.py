"""Selective state-space (Mamba-style) language model in PyTorch: the third
model family.

Counterpart of vtpu/models/ssm.py: its forward, loss, prefill and O(1)
decode. No KV cache: a slot's decode state is a conv window
[K-1, Di] and an SSM state [Di, N] a layer, the same size at any context.
bf16 activations, an f32 scan accumulator, and ``a_log`` and ``dt_bias``
kept f32 in a bf16 model.

The selective scan h_t = a_t h_{t-1} + b_t over a sequence is a log-depth
Hillis-Steele scan (``_scan_states``): ceil(log2 S) rounds of elementwise
products over the whole [B, S, Di, N] tensors, where the reference runs
``jax.lax.associative_scan``. Both compute the same prefix; they differ
only in the order of their roundings. None of it is a Pallas kernel in the
reference, and none is a hand-written kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import Params, _layer
from vtpu_torch.ops import rms_norm, scaled_normal
from vtpu_torch.ops.loss import next_token_ce


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    vocab: int = 2048
    d_model: int = 512
    n_layers: int = 4
    d_state: int = 16  # per-channel SSM state width N
    d_conv: int = 4  # short causal conv window
    expand: int = 2  # inner width = expand * d_model
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


def init_ssm_params(seed: int, cfg: SSMConfig, device=None) -> Params:
    """Scaled-normal init from a seeded generator on ``device``; stacked [L,
    ...] tensors; A = -[1..N] per channel stored as its log, f32, and a zero
    f32 step-size bias per layer (the reference's layout)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, di, n, l = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_layers

    def w(shape, fan_in):
        return scaled_normal(gen, shape, fan_in, cfg.dtype)

    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "embed": w((cfg.vocab, d), d),
        "layers": {
            "in_proj": w((l, d, 2 * di), d),  # -> (x, z)
            "conv_w": w((l, cfg.d_conv, di), cfg.d_conv),
            "x_proj": w((l, di, 2 * n + 1), di),  # -> (B, C, dt)
            "dt_bias": torch.zeros((l,), dtype=torch.float32, device=device),
            "a_log": a_log.expand(l, di, n).contiguous(),
            "d_skip": torch.ones((l, di), dtype=cfg.dtype, device=device),
            "out_proj": w((l, di, d), di),
            "norm": torch.ones((l, d), dtype=cfg.dtype, device=device),
        },
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, Di], w: [K, Di] -> [B, S, Di]:
    sum_k w[k] * x[t - (K-1) + k], in x's dtype as the reference sums it."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1]] * w[i]
    return out


def _selective_mix(lp: dict[str, torch.Tensor], x: torch.Tensor):
    """Input-dependent SSM coefficients from x: [B, S, Di]: per-step decay a
    and drive b [B, S, Di, N] (f32) and the readout C [B, S, N]."""
    n = lp["a_log"].shape[-1]
    # f32 operands, rounded to x's dtype once after an f32 sum, as the
    # reference's x @ x_proj is. A bf16 GEMM this skinny (2N+1 columns over
    # Di) may be split along Di by cuBLAS with its partial sums reduced in
    # bf16 (torch's default allow_bf16_reduced_precision_reduction): on an
    # H100 a [2, 1024]-token admission then moved dt far enough to flip
    # greedy tokens at logit margins near 0.8
    proj = (x.float() @ lp["x_proj"].float()).to(x.dtype).float()  # [B, S, 2N+1]
    b_in, c_out, dt = proj[..., :n], proj[..., n:2 * n], proj[..., -1:]
    dt = F.softplus(dt + lp["dt_bias"])  # [B, S, 1], > 0
    a = -torch.exp(lp["a_log"])  # [Di, N], negative: a stable decay
    a_disc = torch.exp(dt[..., None] * a)
    b_disc = (dt[..., None] * b_in[:, :, None, :]) * x.float()[..., None]
    return a_disc, b_disc, c_out


def _scan_states(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (h_{-1} = 0), log-depth: round r
    folds each position's running pair into the one 2^r positions before it,
    (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2), so after ceil(log2 S)
    rounds position t holds the whole prefix. a, b: [B, S, ...] f32. Each
    round is a new tensor: autograd's backward reads every round's inputs."""
    s = a.shape[1]
    h, d = b, 1
    while d < s:
        h = torch.cat([h[:, :d], torch.addcmul(h[:, d:], a[:, d:], h[:, :-d])], dim=1)
        if 2 * d < s:  # the last round's decays are never read
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


def ssm_layer(cfg: SSMConfig, lp: dict[str, torch.Tensor], x: torch.Tensor, state_at=None):
    """One selective-SSM block over a full sequence. x: [B, S, D] -> out.

    With ``state_at`` (a position, or [B] positions, one a row) also returns
    the decode state there, (conv window [B, K-1, Di], h [B, Di, N]): the
    last K-1 raw mixer inputs before the position and the scan's state after
    the one before it, what ``ssm_decode_step`` consumes next."""
    b = x.shape[0]
    k = cfg.d_conv
    normed = rms_norm(x, lp["norm"])
    xi_raw, z = (normed @ lp["in_proj"]).chunk(2, dim=-1)  # [B, S, Di] each
    xi = F.silu(_causal_conv(xi_raw, lp["conv_w"]).float()).to(x.dtype)
    a, bb, c = _selective_mix(lp, xi)
    h = _scan_states(a, bb)
    y = torch.einsum("bsdn,bsn->bsd", h, c)  # readout
    y = y + xi.float() * lp["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = x + y @ lp["out_proj"]
    if state_at is None:
        return out
    dev = x.device
    at = torch.as_tensor(state_at, device=dev).reshape(-1).expand(b)
    rows = torch.arange(b, device=dev)
    # position p of the left-padded input is raw position p - (K-1): the
    # K-1 entries from state_at are raw positions state_at-K+1 .. state_at-1
    padded = F.pad(xi_raw, (0, 0, k - 1, 0))
    window = padded[rows[:, None], at[:, None] + torch.arange(k - 1, device=dev)]
    return out, (window.to(cfg.dtype), h[rows, at - 1])


def ssm_forward(params: Params, cfg: SSMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (f32)."""
    x = params["embed"][tokens].to(cfg.dtype)
    for l in range(cfg.n_layers):
        x = ssm_layer(cfg, _layer(params, l), x)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["embed"].T).float()


def ssm_loss(params: Params, cfg: SSMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of ``ssm_forward``."""
    return next_token_ce(ssm_forward(params, cfg, tokens), tokens)


def ssm_prefill(params: Params, cfg: SSMConfig, tokens: torch.Tensor, true_len,
                logits_at: Optional[torch.Tensor] = None):
    """Full-sequence forward that also returns the decode state at position
    ``true_len`` (an int or [B] ints: each row's prompt length; the rows are
    right-padded). The scan is causal, so padding past a row's length
    cannot reach its state. Returns (logits, {"conv": [L, B, K-1, Di],
    "h": [L, B, Di, N]}): [B, S, vocab] f32 logits, or [B, vocab] gathered at
    ``logits_at`` ([B] positions) before the vocab projection."""
    x = params["embed"][tokens].to(cfg.dtype)
    wins, hs = [], []
    for l in range(cfg.n_layers):
        x, (win, h) = ssm_layer(cfg, _layer(params, l), x, state_at=true_len)
        wins.append(win)
        hs.append(h)
    x = rms_norm(x, params["final_norm"])
    if logits_at is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logits_at]
    return (x @ params["embed"].T).float(), {"conv": torch.stack(wins), "h": torch.stack(hs)}


# ---------------------------------------------------------------- O(1) decode


def init_ssm_state(cfg: SSMConfig, batch: int, device=None) -> dict[str, torch.Tensor]:
    """Zero decode state: conv windows [L, B, K-1, Di] in cfg.dtype and SSM
    states [L, B, Di, N] in f32."""
    device = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=cfg.dtype, device=device),
        "h": torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def ssm_decode_step(params: Params, cfg: SSMConfig, state: dict[str, torch.Tensor],
                    token: torch.Tensor):
    """One recurrent step. token: [B] -> (logits [B, vocab] f32, new state):
    the sequence path at one position, the conv window in place of the
    padding and h = a h + b in place of the scan. ``state`` is not written;
    the new state is fresh tensors."""
    x = params["embed"][token[:, None]].to(cfg.dtype)  # [B, 1, D]
    convs, hs = [], []
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        normed = rms_norm(x, lp["norm"])
        xi, z = (normed @ lp["in_proj"]).chunk(2, dim=-1)  # [B, 1, Di]
        window = torch.cat([state["conv"][l], xi], dim=1)  # [B, K, Di]
        conv = torch.einsum("bkd,kd->bd", window, lp["conv_w"])[:, None]
        xi = F.silu(conv.float()).to(x.dtype)
        a, b, c = _selective_mix(lp, xi)  # [B, 1, Di, N], [B, 1, N]
        h = a[:, 0] * state["h"][l] + b[:, 0]  # [B, Di, N]
        y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None]
        y = y + xi.float() * lp["d_skip"].float()
        y = (y * F.silu(z.float())).to(x.dtype)
        x = x + y @ lp["out_proj"]
        convs.append(window[:, 1:])
        hs.append(h)
    x = rms_norm(x, params["final_norm"])
    logits = (x[:, 0] @ params["embed"].T).float()
    return logits, {"conv": torch.stack(convs), "h": torch.stack(hs)}
