"""The loss every training path shares (counterpart of vtpu/ops/loss.py)."""

from __future__ import annotations

import torch


def next_token_ce(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy: the mean over B x (S - 1) of -log softmax
    at the next token, in f32. logits: [B, S, V]; tokens: [B, S]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long()).mean()
