"""Ring attention: causal attention with the sequence split over an 'sp'
axis (counterpart of vtpu/parallel/ring.py).

Each rank holds one sequence chunk of q/k/v; k/v blocks go round the ring
with ``ppermute`` while an online-softmax accumulator (o, m, l) folds each
block in, in f32, so no rank ever holds the whole [S, S] score matrix. The
causal mask compares global positions: rank i's queries sit at
i * S/n + [0, S/n). Every rank runs the same ops on every block, those its
mask empties included (a graph that differs by rank would order the
backward's collectives differently, collectives.py). The reference rotates
k/v n times and never reads the last rotation; here the ring turns n - 1
times.
"""

from __future__ import annotations

import math

import torch

from vtpu_torch.parallel.collectives import ppermute

_NEG = -1e30


def _local_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp) -> torch.Tensor:
    """The ring over ``sp`` (a mesh's axis view, ``Mesh.axis``).
    q/k/v: [B, S_loc, H, Dh], this rank's chunk -> [B, S_loc, H, Dh]."""
    n, idx = sp.size, sp.rank
    b, s_loc, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    qf = q.float()
    q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
    o = torch.zeros((b, h, s_loc, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, h, s_loc), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_blk, v_blk = k, v
    for t in range(n):
        src = (idx - t) % n  # which global chunk this k/v block is
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        k_pos = src * s_loc + torch.arange(s_loc, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]  # [1, 1, S_loc_q, S_loc_k]
        scores = torch.where(mask, scores, _NEG)
        new_m = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - new_m)
        p = torch.where(mask, torch.exp(scores - new_m[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = new_m
        if t < n - 1:
            k_blk, v_blk = ppermute(k_blk, perm, sp), ppermute(v_blk, perm, sp)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "sp") -> torch.Tensor:
    """Causal attention over a sequence split on ``mesh``'s ``axis``:
    q/k/v are this rank's chunk [B, S/n, H, Dh] (chunk i holds positions
    i * S/n ...), and so is the output."""
    return _local_ring(q, k, v, mesh.axis(axis))
