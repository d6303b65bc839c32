"""Long-context sequence-parallel training forward: the flagship model over
a ring (counterpart of vtpu/parallel/longctx.py).

The whole transformer forward runs with the sequence split over an 'sp'
axis: every elementwise op, norm, matmul and RoPE is local to a chunk, and
only attention communicates, through the ring (ring.py). RoPE and the
causal mask take global positions. Parameters are replicated over the
ring: each leaf enters through ``copy_to_axis``, so its gradient is the
sum of every chunk's, as ``jax.grad`` of the reference's ``shard_map``
gives it.
"""

from __future__ import annotations

import torch

from vtpu_torch.models.transformer import (
    Params, _layer, _mlp_block, _qkv, _rope_tables,
)
from vtpu_torch.ops import rms_norm
from vtpu_torch.parallel.collectives import all_reduce_sum, copy_to_axis, ppermute
from vtpu_torch.parallel.ring import _local_ring


def _over(params: Params, ax) -> Params:
    """Every leaf of ``params`` through ``copy_to_axis`` over ``ax``."""
    return {"embed": copy_to_axis(params["embed"], ax),
            "layers": {k: copy_to_axis(w, ax) for k, w in params["layers"].items()},
            "final_norm": copy_to_axis(params["final_norm"], ax)}


def place_sp_tokens(tokens, mesh, axis: str = "sp"):
    """This rank's sequence chunk [B, S/n] of a global [B, S] batch (a
    tensor or a numpy array, the same on every rank)."""
    n, idx = mesh.shape[axis], mesh.coords[axis]
    s = tokens.shape[1]
    if s % n:
        raise ValueError(f"seq len {s} not divisible by {axis}={n}")
    part = s // n
    return tokens[:, idx * part:(idx + 1) * part]


def sp_prefill(params: Params, cfg, tokens: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """Sequence-parallel full forward. tokens: this rank's chunk [B, S/n]
    (``place_sp_tokens``); params: the whole tree, replicated. Returns this
    rank's chunk of the logits [B, S/n, V] (f32)."""
    sp = mesh.axis(axis)
    b, s_loc = tokens.shape
    if sp.size * s_loc > cfg.max_seq:
        raise ValueError(f"seq len {sp.size * s_loc} exceeds max_seq {cfg.max_seq}")
    params = _over(params, sp)
    dev = tokens.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))
    positions = (sp.rank * s_loc + torch.arange(s_loc, device=dev)).expand(b, s_loc)
    x = params["embed"][tokens].to(cfg.dtype)
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x, cos, sin, positions)
        attn = _local_ring(q, k, v, sp)
        x = x + attn.reshape(b, s_loc, cfg.qkv_dim) @ lp["wo"]
        x = x + _mlp_block(lp, x)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["embed"].T).float()


def sp_loss(params: Params, cfg, tokens: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """Next-token cross-entropy over the sequence-parallel forward: the
    mean over B x (S - 1) of the global sequence, whole on every rank.
    tokens: this rank's chunk [B, S/n]. A chunk's last position predicts
    the next rank's first token (one ppermute of that column); only the
    last rank's last position predicts nothing."""
    sp = mesh.axis(axis)
    n = sp.size
    b, s_loc = tokens.shape
    logits = sp_prefill(params, cfg, tokens, mesh, axis)
    following = ppermute(tokens[:, :1], [(i, (i - 1) % n) for i in range(n)], sp)
    targets = torch.cat([tokens[:, 1:], following], dim=1).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    keep = torch.ones(s_loc, dtype=torch.float32, device=tokens.device)
    keep[-1] = float(sp.rank != n - 1)
    total = all_reduce_sum((nll * keep).sum(), sp)
    return total / (b * (n * s_loc - 1))
