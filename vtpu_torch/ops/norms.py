"""Normalization ops (bf16-safe: accumulate in f32, emit in input dtype).

Counterpart of vtpu/ops/norms.py."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: f32 variance, weight applied in f32, then cast to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
