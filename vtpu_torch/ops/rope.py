"""Rotary position embeddings, precomputed-table style.

Counterpart of vtpu/ops/rope.py: the half-split rotation (x[..., :half]
against x[..., half:]), not the interleaved pairing."""

from __future__ import annotations

import torch


def rope_angles(max_seq: int, head_dim: int, base: float = 10000.0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_seq, head_dim // 2] in f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=device), exps)
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, Dh] by the angles at ``positions`` [B, S] (int)."""
    half = x.shape[-1] // 2
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1 = x[..., :half]
    x2 = x[..., half:]
    rot = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return rot.to(x.dtype)
