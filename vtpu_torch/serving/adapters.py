"""Slot-model adapter: the contract between the serving engine and the
dense transformer (counterpart of vtpu/serving/adapters.py).

Contract (all shapes static; per-slot state is data, never shape):
  params                        parameter dict passed back into every call
  max_context                   cap on prompt + generation
  init_state(slots) -> state
  prefill_into_slot(params, state, padded[1, bucket], slot, true_len)
      -> (last_logits [vocab], state)
  prefill_into_slots(params, state, padded[N, bucket], slots[N], true_lens[N])
      -> (last_logits [N, vocab], state)
  decode_step(params, state, tokens[B], active[B], kv_bucket) -> (logits, state)

The state is updated in place; the returned dict is the one to keep.

Under a tensor-parallel mesh rank 0's adapter leads and every other
rank's follows it (``follow``, run in a loop by
vtpu_torch.parallel.launch.serve_worker): see ``TransformerSlotModel``.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Optional

import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import (
    init_kv_cache, init_paged_kv_cache, kv_quantized, prefill, sample_tokens,
)
from vtpu_torch.ops.decode_attn import PAGED_ATTN_ROUTES
from vtpu_torch.parallel.collectives import broadcast_

# rank 0's calls as the other ranks receive them: a header of _HEADER int64
# words (op, then up to two sizes), then one int64 payload holding the
# call's tensor arguments and rank 0's _MIRRORED state planes
_OP_INIT, _OP_PREFILL, _OP_DECODE, _OP_STOP = range(4)
_HEADER = 3
_MIRRORED = ("table", "len")


def sampled_decode_step(model: Any, temperature: float, top_k: int, top_p: float):
    """Compose a slot model's decode_step with the on-device sampler:

        (params, state, tokens[B], active[B], gens[B], kv_bucket)
            -> (next_tokens [B] int32, state)

    A tick hands the host [B] int32 tokens, never [B, vocab] logits."""

    def step(params, state, tokens, active, gens, kv_bucket):
        logits, state = model.decode_step(params, state, tokens, active, kv_bucket)
        return sample_tokens(logits, gens, temperature, top_k, top_p), state

    return step


def batched_admission_step(model: Any, temperature: float, top_k: int, top_p: float):
    """Compose the batched prefill with the on-device sampler into one
    admission step:

        (params, state, buf[B], tokens[N, bucket], slots[N], true_lens[N],
         gens[N]) -> (first_tokens [N] int32, buf[B], state)

    N prompts' trunk forward, the per-slot KV scatter, the N first tokens
    and their scatter into the engine's per-slot first-token buffer ``buf``
    all happen without a host sync; the next decode tick reads the tokens
    from ``buf``."""

    def step(params, state, buf, tokens, slots, true_lens, gens):
        last, state = model.prefill_into_slots(params, state, tokens, slots, true_lens)
        tok = sample_tokens(last, gens, temperature, top_k, top_p)
        buf[slots] = tok
        return tok, buf, state

    return step


class TransformerSlotModel:
    """Dense transformer with a slot-pooled KV cache: a dense per-slot ring,
    or with ``kv_page`` a paged block pool whose page table the engine
    fills at admission. With ``cfg.kv_int8`` either holds int8 values with
    f32 scale planes beside them, as ``init_kv_cache`` and
    ``init_paged_kv_cache`` lay them out. ``paged_attn`` (None, "kernel",
    "gather") is the paged read-route override.

    With ``mesh`` (a vtpu_torch.parallel.TpMesh) ``params`` is this
    rank's tensor-parallel shard (``shard_params``, or
    ``params_from_numpy(..., mesh=)``) and the cache or pool holds its n_heads / tp heads; tables and lengths
    are whole on every rank. Rank 0's adapter drives: each of
    ``init_state``, ``prefill_into_slot(s)`` and ``decode_step`` first
    broadcasts the call (op, shapes, tensor arguments) and rank 0's current
    table and lengths, then runs it. The other ranks' adapters run the
    same call on their shards from ``follow``. A lock keeps one call (and
    its broadcasts) at a time."""

    supports_kv_buckets = True

    def __init__(self, params: Any, cfg: Any, kv_page: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 paged_attn: Optional[str] = None, device=None, mesh=None):
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device} but the model runs "
                f"on {self.device}")
        if paged_attn is not None:
            if paged_attn not in PAGED_ATTN_ROUTES:
                raise ValueError(
                    f"paged_attn must be one of {PAGED_ATTN_ROUTES} or None "
                    f"(auto), got {paged_attn!r}")
            if kv_page is None:
                raise ValueError(
                    "paged_attn forces a paged decode-attention route, but the "
                    "cache is dense (kv_page=None)")
        if mesh is not None:
            _validate_serving_mesh(mesh, cfg)
            _check_rank_shard(params, cfg, mesh)
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.max_context = cfg.max_seq
        self.kv_page = kv_page
        self.kv_pool_blocks = kv_pool_blocks
        self.paged_attn = paged_attn
        self.n_kv_blocks = None  # usable blocks + the null block, at init_state
        self._lock = threading.Lock()
        self._stopped = False

    # ------------------------------------------------- the engine's calls

    def init_state(self, slots: int):
        with self._lock:
            self._announce(_OP_INIT, (slots,))
            return self._init_state(slots)

    def prefill_into_slot(self, params, state, padded, slot, true_len):
        dev = padded.device
        last, state = self.prefill_into_slots(
            params, state, padded, torch.tensor([slot], device=dev),
            torch.tensor([true_len], device=dev))
        return last[0], state

    def prefill_into_slots(self, params, state, padded, slots, true_lens):
        with self._lock:
            self._announce(_OP_PREFILL, tuple(padded.shape), (padded, slots, true_lens), state)
            return self._prefill(params, state, padded, slots, true_lens)

    def decode_step(self, params, state, tokens, active, kv_bucket):
        with self._lock:
            self._announce(_OP_DECODE, (kv_bucket,), (tokens, active), state)
            return self._decode(params, state, tokens, active, kv_bucket)

    def stop_workers(self) -> None:
        """Rank 0: tell the other ranks to leave ``follow`` (once). A no-op
        without a mesh."""
        with self._lock:
            if self._drives() and not self._stopped:
                self._stopped = True
                broadcast_(torch.tensor([_OP_STOP] + [0] * (_HEADER - 1)), self.mesh)

    # ------------------------------------------------------ rank 0 / others

    def _drives(self) -> bool:
        """Whether this adapter's calls must reach other ranks first."""
        if self.mesh is None or self.mesh.size == 1:
            return False
        if self.mesh.rank != 0:
            raise RuntimeError(
                f"rank {self.mesh.rank} follows rank 0's calls (serve_worker); "
                "only rank 0 calls the adapter")
        return True

    def _announce(self, op: int, dims: tuple, tensors: tuple = (), state=None) -> None:
        if not self._drives():
            return
        if self._stopped:
            raise RuntimeError("the worker ranks were stopped")
        header = torch.tensor([op, *dims] + [0] * (_HEADER - 1 - len(dims)))
        broadcast_(header, self.mesh)
        if op == _OP_INIT:
            return
        parts = list(tensors) + [state[key] for key in _MIRRORED if key in state]
        broadcast_(torch.cat([x.reshape(-1).to(torch.int64) for x in parts]), self.mesh)

    def follow(self, state):
        """A non-zero rank's side of rank 0's next call: receive it and run
        it on this rank's shard, after overwriting the table and lengths
        with rank 0's. Returns (False, state) when rank 0 stopped the
        workers, else (True, the new state)."""
        header = broadcast_(torch.zeros(_HEADER, dtype=torch.int64), self.mesh)
        op, d0, d1 = header.tolist()
        if op == _OP_STOP:
            return False, state
        if op == _OP_INIT:
            return True, self._init_state(d0)
        b = state["len"].shape[0]
        shapes = {_OP_PREFILL: [(d0, d1), (d0,), (d0,)], _OP_DECODE: [(b,), (b,)]}.get(op)
        if shapes is None:
            raise RuntimeError(f"unknown op {op} from rank 0")
        mirrored = [state[key] for key in _MIRRORED if key in state]
        sizes = [math.prod(shape) for shape in shapes] + [x.numel() for x in mirrored]
        payload = broadcast_(torch.empty(sum(sizes), dtype=torch.int64, device=self.device),
                             self.mesh)
        parts = torch.split(payload, sizes)
        for x, part in zip(mirrored, parts[len(shapes):]):
            x.copy_(part.view(x.shape))
        args = [part.view(shape) for part, shape in zip(parts, shapes)]
        if op == _OP_PREFILL:
            _, state = self._prefill(self.params, state, *args)
        else:
            tokens, active = args
            _, state = self._decode(self.params, state, tokens.to(torch.int32), active.bool(), d0)
        return True, state

    # ------------------------------------------------------- the steps

    def _init_state(self, slots: int):
        if self.kv_page is None:
            return init_kv_cache(self.cfg, slots, device=self.device, mesh=self.mesh)
        if self.kv_pool_blocks is not None and self.kv_pool_blocks < 1:
            raise ValueError(f"kv_pool_blocks must be >= 1, got {self.kv_pool_blocks}")
        usable = (self.kv_pool_blocks if self.kv_pool_blocks is not None
                  else slots * (self.max_context // self.kv_page))
        self.n_kv_blocks = usable + 1
        return init_paged_kv_cache(self.cfg, slots, self.kv_page, self.n_kv_blocks,
                                   device=self.device, mesh=self.mesh)

    def _prefill(self, params, state, padded, slots, true_lens):
        from vtpu_torch.serving.engine import prefill_into_slots

        # logits_at: each row's final position is gathered before the vocab
        # projection, so the [N, bucket, vocab] logits never exist
        return prefill_into_slots(
            params, self.cfg, state, padded, slots, true_lens,
            prefill_fn=lambda p, c, t, mesh: prefill(p, c, t, logits_at=true_lens - 1,
                                                     mesh=mesh),
            mesh=self.mesh)

    def _decode(self, params, state, tokens, active, kv_bucket):
        from vtpu_torch.serving.engine import batched_decode_step

        return batched_decode_step(params, self.cfg, state, tokens, active,
                                   kv_bucket=kv_bucket, paged_attn=self.paged_attn,
                                   mesh=self.mesh)


def _validate_serving_mesh(mesh: Any, cfg: Any) -> None:
    """Construction-time checks of a tensor-parallel serving mesh; each
    error names the numbers at fault (reference: adapters.py
    ``_validate_serving_mesh``; a TpMesh has the 'tp' axis only)."""
    tp = int(mesh.shape["tp"])
    if cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide the attention head count "
            f"(n_heads={cfg.n_heads}): q/k/v and the KV cache/pool split "
            "their head axis over 'tp'"
            + (f", as do the int8 k_scale/v_scale planes (n_heads = {cfg.n_heads})"
               if kv_quantized(cfg) else ""))
    if cfg.d_ff % tp:
        raise ValueError(f"tp={tp} must divide d_ff={cfg.d_ff}: w_gate/w_up split "
                         "their output axis and w_down its input axis over 'tp'")


def _check_rank_shard(params: Any, cfg: Any, mesh: Any) -> None:
    """Refuse params that are not one rank's shard (a full tree, or another
    tp's shard), naming the column counts."""
    qd = params["layers"]["wq"].shape[-1]
    if qd * mesh.size != cfg.qkv_dim:
        raise ValueError(
            f"under tp={mesh.size} the params must be one rank's shard (shard_params): "
            f"wq has {qd} output columns, expected {cfg.qkv_dim // mesh.size}")
