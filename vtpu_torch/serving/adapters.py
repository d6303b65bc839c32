"""Slot-model adapter: the contract between the serving engine and the
dense transformer (counterpart of vtpu/serving/adapters.py, single device).

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
"""

from __future__ import annotations

from typing import Any, Optional

from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import (
    init_kv_cache, init_paged_kv_cache, prefill, sample_tokens,
)
from vtpu_torch.ops.decode_attn import PAGED_ATTN_ROUTES


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
    """Dense transformer with a slot-pooled KV cache on one device: a dense
    per-slot ring, or with ``kv_page`` a paged block pool whose page table
    the engine fills at admission. With ``cfg.kv_int8`` either holds int8
    values with f32 scale planes beside them, as ``init_kv_cache`` and
    ``init_paged_kv_cache`` lay them out.
    ``paged_attn`` (None, "kernel", "gather") is the paged read-route
    override."""

    supports_kv_buckets = True

    def __init__(self, params: Any, cfg: Any, kv_page: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 paged_attn: Optional[str] = None, device=None):
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
        self.cfg = cfg
        self.params = params
        self.max_context = cfg.max_seq
        self.kv_page = kv_page
        self.kv_pool_blocks = kv_pool_blocks
        self.paged_attn = paged_attn
        self.n_kv_blocks = None  # usable blocks + the null block, at init_state

    def init_state(self, slots: int):
        if self.kv_page is None:
            return init_kv_cache(self.cfg, slots, device=self.device)
        if self.kv_pool_blocks is not None and self.kv_pool_blocks < 1:
            raise ValueError(f"kv_pool_blocks must be >= 1, got {self.kv_pool_blocks}")
        usable = (self.kv_pool_blocks if self.kv_pool_blocks is not None
                  else slots * (self.max_context // self.kv_page))
        self.n_kv_blocks = usable + 1
        return init_paged_kv_cache(self.cfg, slots, self.kv_page, self.n_kv_blocks,
                                   device=self.device)

    def prefill_into_slot(self, params, state, padded, slot, true_len):
        from vtpu_torch.serving.engine import prefill_into_slot

        return prefill_into_slot(params, self.cfg, state, padded, slot, true_len)

    def prefill_into_slots(self, params, state, padded, slots, true_lens):
        from vtpu_torch.serving.engine import prefill_into_slots

        # logits_at: each row's final position is gathered before the vocab
        # projection, so the [N, bucket, vocab] logits never exist
        return prefill_into_slots(
            params, self.cfg, state, padded, slots, true_lens,
            prefill_fn=lambda p, c, t: prefill(p, c, t, logits_at=true_lens - 1))

    def decode_step(self, params, state, tokens, active, kv_bucket):
        from vtpu_torch.serving.engine import batched_decode_step

        return batched_decode_step(params, self.cfg, state, tokens, active,
                                   kv_bucket=kv_bucket, paged_attn=self.paged_attn)
