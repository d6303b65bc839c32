"""Mixture-of-Experts transformer in PyTorch: the second model family.

Counterpart of vtpu/models/moe.py: its forward, its loss and its serving
side (the expert-parallel block is parallel/expert.py's ``make_ep_ffn``,
``moe_forward``'s ``ffn``). GShard-style top-k routing
with static shapes: an expert's capacity is a Python int, dispatch and
combine are dense [T, E, C] one-hot tensors applied by einsum, so nothing
here reads the device from the host and a decode step can be captured in a
CUDA graph. Per-layer weights are stacked [L, ...], experts on their own
axis [L, E, ...]; the router stays f32 in a bf16 model.

The attention trunk is the dense family's (``attention_block``: the same
q/k/v projections and rope, the flash kernel with ``cfg.use_kernels``);
decode, speculation and chunked prefill run the dense decode trunk with
``moe_decode_ffn`` as its post-attention block.

Under a tensor-parallel ``mesh`` (serving) the attention trunk splits as
the dense family's, and the expert stacks hold this rank's slice of the
expert axis when tp divides ``n_experts`` (parallel/sharding.py
``shard_moe_params``; replicated otherwise). Every rank routes every token
with the replicated router, so each computes the same dispatch and the
same drops; it runs its own experts only, and the partial combines are
summed by ``all_reduce_sum`` (the reference's einsum over a split expert
axis, which XLA reduces over 'tp').

Every one-hot is a comparison with an ``arange``. JAX's ``one_hot`` gives a
zero row for an index past its class count, which is what a token dropped
past an expert's capacity needs; ``torch.nn.functional.one_hot`` refuses
such an index, and without ``num_classes`` reads the maximum back from the
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import (
    Params, _layer, _rope_tables, attention_block, fill_kv_cache, init_kv_cache,
)
from vtpu_torch.ops import rms_norm, scaled_normal
from vtpu_torch.ops.loss import next_token_ce
from vtpu_torch.parallel.collectives import all_reduce_sum


# the MoE block's stages as a stage timer names them (``moe_ffn``)
MOE_STAGES = ("route", "dispatch", "experts", "combine")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab: int = 2048
    d_model: int = 512
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024  # per-expert hidden width
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    max_seq: int = 1024
    head_dim: int = 128
    dtype: torch.dtype = torch.bfloat16
    # int8 KV cache, as ModelConfig.kv_int8 ("auto" reads as int8 here: the
    # engine resolves it only for (params, cfg), as the reference does)
    kv_int8: bool | str = False
    # prefill attention through the flash kernel (ModelConfig.use_kernels);
    # decode reads the paged kernels through the shared trunk's route
    use_kernels: bool = True

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    def capacity(self, tokens: int) -> int:
        """Static per-expert slot count for a ``tokens``-token batch."""
        return max(1, math.ceil(self.top_k * tokens / self.n_experts * self.capacity_factor))


def init_moe_params(seed: int, cfg: MoEConfig, device=None) -> Params:
    """Scaled-normal init from a seeded generator on ``device``; stacked [L,
    ...] tensors, experts stacked on their own axis [L, E, ...], the router
    f32 (the reference's layout)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f, l, e, qd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts, cfg.qkv_dim

    def w(shape, fan_in):
        return scaled_normal(gen, shape, fan_in, cfg.dtype)

    return {
        "embed": w((cfg.vocab, d), d),
        "layers": {
            "wq": w((l, d, qd), d),
            "wk": w((l, d, qd), d),
            "wv": w((l, d, qd), d),
            "wo": w((l, qd, d), qd),
            # router stays f32: the softmax over experts decides the routing
            "router": scaled_normal(gen, (l, d, e), d, torch.float32),
            "w_gate": w((l, e, d, f), d),
            "w_up": w((l, e, d, f), d),
            "w_down": w((l, e, f, d), f),
            "attn_norm": torch.ones((l, d), dtype=cfg.dtype, device=device),
            "mlp_norm": torch.ones((l, d), dtype=cfg.dtype, device=device),
        },
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=device),
    }


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: MoEConfig, capacity: int,
          pad_mask: Optional[torch.Tensor] = None):
    """Top-k routing over flat tokens x: [T, D].

    Returns (dispatch [T, E, C] one-hot, combine [T, E, C] gate weights, aux
    load-balancing loss scalar), all f32. Choices are served in k-th-choice
    priority: every token's first choice claims its slot before any second
    choice, and within one choice tokens claim slots in order. A choice past
    its expert's capacity is dropped (its combine row is zero, so the
    residual passes the token through). ``pad_mask`` ([T] bool, True = real
    token) keeps pads out of routing: they claim no slot, so right padding
    cannot move a real token's slot."""
    t, e = x.shape[0], cfg.n_experts
    dev = x.device
    probs = torch.softmax(x.float() @ router_w, dim=-1)  # [T, E]
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    experts = torch.arange(e, device=dev)
    slots = torch.arange(capacity, device=dev)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    prev = torch.zeros((e,), dtype=torch.int64, device=dev)
    for j in range(cfg.top_k):
        onehot = (gate_idx[:, j:j + 1] == experts).to(torch.int64)  # [T, E]
        if pad_mask is not None:
            onehot = onehot * pad_mask.to(torch.int64)[:, None]
        pos_all = torch.cumsum(onehot, dim=0) - onehot + prev[None, :]
        pos = (pos_all * onehot).sum(dim=-1)  # [T] slot within the chosen expert
        prev = prev + onehot.sum(dim=0)
        # a position at or past capacity matches no slot: a zero row
        slot = (pos[:, None] == slots).to(torch.float32)  # [T, C]
        hot = onehot.to(torch.float32)[:, :, None] * slot[:, None, :]  # [T, E, C]
        dispatch += hot
        combine += gate_vals[:, j, None, None] * hot
    # load-balancing auxiliary (Switch/GShard): E * sum(frac_tokens * mean_prob)
    frac = (gate_idx[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return dispatch, combine, aux


def expert_ffn(lp_e: dict[str, torch.Tensor], slots: torch.Tensor) -> torch.Tensor:
    """SwiGLU over dispatched slots [E, C, D] with per-expert weights [E, D, F]."""
    gate = torch.bmm(slots, lp_e["w_gate"])
    up = torch.bmm(slots, lp_e["w_up"])
    act = F.silu(gate.float()).to(slots.dtype) * up
    return torch.bmm(act, lp_e["w_down"])


def moe_ffn(lp: dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None, pad_mask: Optional[torch.Tensor] = None,
            mesh=None, timer=None):
    """The MoE block. x: [B, S, D] -> (out [B, S, D], aux).
    ``capacity`` overrides the config formula (serving decode passes the
    full token count so routing can never drop a token); ``pad_mask``
    ([B, S] bool, True = real) keeps pads out of routing. Under ``mesh``
    with the expert axis split (``lp``'s stacks hold n_experts / tp
    experts) the route is the whole one, each rank dispatches to and
    combines from its own experts, and the partial outputs are summed.
    ``timer`` (a ``vtpu_torch.obs.devtime.StageTimer``) times the
    ``MOE_STAGES``: the route, the dispatch einsum, the experts and the
    combine einsum with its all-reduce."""
    lap = timer.lap() if timer is not None else None
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    cap = capacity or cfg.capacity(b * s)
    dispatch, combine, aux = route(lp["router"], flat, cfg, cap,
                                   pad_mask=None if pad_mask is None else pad_mask.reshape(b * s))
    if lap:
        lap("route")
    local = lp["w_gate"].shape[0]
    split = local != cfg.n_experts
    if split:
        e0 = mesh.rank * local
        dispatch, combine = dispatch[:, e0:e0 + local], combine[:, e0:e0 + local]
    slots = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), flat)  # [E, C, D]
    if lap:
        lap("dispatch")
    out_slots = expert_ffn(lp, slots)
    if lap:
        lap("experts")
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), out_slots)
    if split:
        out = all_reduce_sum(out, mesh)
    if lap:
        lap("combine")
    return out.reshape(b, s, d), aux


def _moe_layer(cfg: MoEConfig, lp, x, cos, sin, positions, ffn, mesh=None):
    """One MoE decoder block over a full sequence: the dense family's
    attention block, then ``ffn(lp, normed, cfg) -> (out, aux)``. Returns
    (out, aux, (k, v))."""
    x, kv = attention_block(cfg, lp, x, cos, sin, positions, mesh)
    moe_out, aux = ffn(lp, rms_norm(x, lp["mlp_norm"]), cfg)
    return x + moe_out, aux, kv


def _embed(params: Params, cfg: MoEConfig, tokens: torch.Tensor):
    b, s = tokens.shape
    if s > cfg.max_seq:
        raise ValueError(f"sequence length {s} exceeds max_seq {cfg.max_seq}")
    dev = tokens.device
    cos, sin = _rope_tables(cfg.max_seq, cfg.head_dim, str(dev))
    positions = torch.arange(s, device=dev).expand(b, s)
    return params["embed"][tokens].to(cfg.dtype), cos, sin, positions


def moe_forward(params: Params, cfg: MoEConfig, tokens: torch.Tensor, ffn=moe_ffn):
    """Full-sequence forward. tokens: [B, S] -> (logits [B, S, vocab] f32,
    aux loss averaged over layers). ``ffn(lp, normed, cfg) -> (out, aux)``
    is the post-attention block."""
    x, cos, sin, positions = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l in range(cfg.n_layers):
        x, layer_aux, _ = _moe_layer(cfg, _layer(params, l), x, cos, sin, positions, ffn)
        aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"])
    return (x @ params["embed"].T).float(), aux / cfg.n_layers


def moe_loss(params: Params, cfg: MoEConfig, tokens: torch.Tensor, ffn=moe_ffn) -> torch.Tensor:
    """Next-token cross-entropy + 0.01 x the load-balancing aux."""
    logits, aux = moe_forward(params, cfg, tokens, ffn=ffn)
    return next_token_ce(logits, tokens) + 0.01 * aux


# ------------------------------------------------------------------ serving


def moe_decode_ffn(cfg: MoEConfig, mesh=None, timer=None):
    """The post-attention block for the shared decode trunk
    (transformer.spec_verify_loop): routed experts in place of the dense
    MLP; the aux term is a training loss, dropped here. Capacity is the full
    token count: a decode tick routes every slot's token jointly (a retired
    slot's stale one too), and a drop triggered by such a token would zero a
    live slot's expert output; with capacity >= tokens nothing can drop. x
    is [B, T, D]: T = 1 for decode, K+1 for a verify chunk, C for a prefill
    chunk. Under ``mesh`` the block owns its all-reduce (``moe_ffn``).
    ``timer``: a stage timer for ``moe_ffn`` (a timed prefill chunk)."""

    def ffn(lp, x):
        out, _ = moe_ffn(lp, rms_norm(x, lp["mlp_norm"]), cfg, capacity=x.shape[0] * x.shape[1],
                         mesh=mesh, timer=timer)
        return out

    return ffn


def moe_prefill(params: Params, cfg: MoEConfig, tokens: torch.Tensor, true_len=None,
                logits_at: Optional[torch.Tensor] = None, ffn=moe_ffn, mesh=None,
                timer=None):
    """Full-sequence forward that also fills a KV cache: the serving-side
    sibling of ``moe_forward`` (the aux term dropped). tokens: [B, S] ->
    (logits, cache): [B, S, vocab] f32 logits, or [B, vocab] gathered at
    ``logits_at`` ([B] positions) before the vocab projection.

    ``true_len`` (an int or [B] ints) marks where each row's right padding
    starts. Given, pads are masked out of routing (they claim no capacity
    slot) and capacity follows the config's formula over the B x S tokens,
    which bounds dispatch and combine at the largest buckets; a real
    token's choice past capacity drops, as in training. Without it capacity
    is the full token count and nothing can drop. ``ffn`` is the MoE block
    (``moe_ffn``'s signature; it is given the pad mask or the capacity, and
    the mesh under one, and ``timer``, a stage timer, where one is given).
    An int8 cache stores the quantized K/V. Under ``mesh``: the rank's
    shard of params in, its head shard of the cache out, logits whole on
    every rank."""
    b, s = tokens.shape
    dev = tokens.device
    x, cos, sin, positions = _embed(params, cfg, tokens)
    split = {} if mesh is None else {"mesh": mesh}  # a one-device ffn takes no mesh
    if timer is not None:
        split["timer"] = timer
    if true_len is not None:
        lens = torch.as_tensor(true_len, device=dev).reshape(-1, 1)
        pad_mask = positions < lens  # [B, S]

        def serving_ffn(lp, normed, cfg_):
            return ffn(lp, normed, cfg_, pad_mask=pad_mask, **split)
    else:
        def serving_ffn(lp, normed, cfg_):
            return ffn(lp, normed, cfg_, capacity=normed.shape[0] * normed.shape[1], **split)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        x, _, (k, v) = _moe_layer(cfg, _layer(params, l), x, cos, sin, positions, serving_ffn,
                                  mesh)
        ks.append(k)
        vs.append(v)
    cache = fill_kv_cache(init_kv_cache(cfg, b, device=dev, mesh=mesh), torch.stack(ks),
                          torch.stack(vs))
    del ks, vs
    x = rms_norm(x, params["final_norm"])
    if logits_at is not None:
        x = x[torch.arange(b, device=dev), logits_at]
    logits = (x @ params["embed"].T).float()
    cache["len"].fill_(s)
    return logits, cache
