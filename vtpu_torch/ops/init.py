"""Weight init shared by every model family (counterpart of vtpu/ops/init.py)."""

from __future__ import annotations

import math

import torch


def scaled_normal(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32 from ``gen`` on its device, cast to dtype."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x / math.sqrt(fan_in)).to(dtype)
