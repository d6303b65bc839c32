"""Ulysses sequence parallelism: an all-to-all head/sequence exchange
(counterpart of vtpu/parallel/ulysses.py).

The complement to ring attention (ring.py): two ``all_to_all``s re-split
[B, S/n, H, Dh] into [B, S, H/n, Dh], each rank runs plain full-sequence
causal attention over its head slice (the port's ``causal_attention``, as
the reference runs its plain one), and the output is re-split back. The
head count must divide by the axis size.
"""

from __future__ import annotations

import torch

from vtpu_torch.ops import causal_attention
from vtpu_torch.parallel.collectives import all_to_all


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      axis: str = "sp") -> torch.Tensor:
    """Causal attention over a sequence split on ``mesh``'s ``axis``:
    q/k/v are this rank's chunk [B, S/n, H, Dh], and so is the output."""
    sp = mesh.axis(axis)
    n, heads = sp.size, q.shape[2]
    if heads % n != 0:
        raise ValueError(
            f"ulysses needs heads % mesh == 0, got {heads} heads over {n} devices "
            "(use ring_attention instead)"
        )

    def to_heads(x):  # split the heads over the ranks, gather the sequence
        return all_to_all(x, 2, 1, sp)

    out = causal_attention(to_heads(q), to_heads(k), to_heads(v))  # [B, S, H/n, Dh]
    return all_to_all(out, 1, 2, sp)  # [B, S/n, H, Dh]
