"""Slot-model adapters: the contract between the serving engine and a model
family (counterpart of vtpu/serving/adapters.py). Three families: the dense
transformer (``TransformerSlotModel``) and the MoE (``MoeSlotModel``), each
with a dense per-slot KV cache or a paged block pool, and the selective SSM
(``SsmSlotModel``: an O(1) recurrent state a slot, no KV cache).

Contract (all shapes static; per-slot state is data, never shape):
  params                        parameter dict passed back into every call
  cfg                           the family's config
  device                        the device the params live on
  max_context                   cap on prompt + generation, or None (SSM)
  supports_kv_buckets           True if decode accepts a bounded read window
  kv_page, paged_attn           the paged pool and read route it was built
                                with (None for a dense cache and the SSM)
  init_state(slots) -> state
  prefill_into_slot(params, state, padded[1, bucket], slot, true_len)
      -> (last_logits [vocab], state)
  prefill_into_slots(params, state, padded[N, bucket], slots[N], true_lens[N])
      -> (last_logits [N, vocab], state)
  decode_step(params, state, tokens[B], active[B], kv_bucket) -> (logits, state)
  prefill_chunk_into_slot(params, state, chunk[1, C], slot, offset, new_len,
                          kv_bucket, block_ids=None) -> (logits [1, C, vocab], state)
  spec_step(params, state, draft[B, T], active[B], cap[B], kv_bucket)
      -> (pred [B, T], count [B], state)

The state is updated in place, every tensor at its address (the engine's
CUDA graphs hold them); the returned dict is the one to keep. The SSM has
no ``spec_step`` and no ``prefill_chunk_into_slot``: the engine serves it
without speculation and chunked admission, as the reference does.
``prefill_chunk_into_slot`` with an explicit ``block_ids`` row and the slot
count as ``slot`` (whose length write is dropped) is the slot-less prefill
that builds a shared prefix into fresh pool blocks.

The KV families also own every write the engine makes into the KV planes
outside a step, so that under a mesh each reaches every rank: the
copy-on-write of a prefix's boundary block (``copy_blocks``), a dense
prefix's buffers (``build_prefix`` / ``install_prefix`` / ``drop_prefix``)
and the KV-overcommit host tier (``init_host_tier``, ``swap_out``,
``swap_in``: whole pool blocks between the pool and a pinned host tier,
through the staging pair ``swap_page_gather`` / ``swap_page_scatter``).

Under a tensor-parallel mesh rank 0's adapter leads and every other
rank's follows it (``follow``, run in a loop by
vtpu_torch.parallel.launch.serve_worker): see ``TransformerSlotModel``.
The dense and MoE families serve under a mesh; the SSM on one device only,
as the reference's takes no mesh.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import weakref
from typing import Any, Optional

import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.moe import MOE_STAGES, moe_decode_ffn, moe_prefill
from vtpu_torch.models.ssm import init_ssm_state, ssm_decode_step, ssm_prefill
from vtpu_torch.models.transformer import (
    init_kv_cache, init_paged_kv_cache, kv_keys, kv_quantized, multi_tick_decode,
    multi_tick_spec_decode, prefill, sample_tokens,
)
from vtpu_torch.ops.decode_attn import PAGED_ATTN_ROUTES
from vtpu_torch.parallel.collectives import all_gather, broadcast_

# rank 0's calls as the other ranks receive them: a header of _HEADER int64
# words (the op, the paged read route rank 0 runs it on as an index of
# _ROUTES, then up to four sizes), then, for every op but INIT and STOP,
# one int64 payload holding the call's tensor arguments and rank 0's
# _MIRRORED state planes. A migration's snapshot and upload move their KV
# bytes in a collective of their own after that (_to_bytes)
(_OP_INIT, _OP_PREFILL, _OP_DECODE, _OP_STOP, _OP_CHUNK, _OP_VERIFY, _OP_COPY, _OP_PREFIX,
 _OP_INSTALL, _OP_DROP, _OP_TIER, _OP_SWAP_OUT, _OP_SWAP_IN, _OP_SNAPSHOT,
 _OP_UPLOAD) = range(15)
_HEADER = 6
_ROUTES = (None,) + PAGED_ATTN_ROUTES
_MIRRORED = ("table", "len")
# rank 0's adapter that drives each process group, by the group's id: two
# engines' calls on one group would interleave on its followers
_GROUP_OWNERS: "weakref.WeakValueDictionary[int, TransformerSlotModel]" = (
    weakref.WeakValueDictionary())


def _payload_shapes(op: int, dims: list, b: int) -> list:
    """The shapes of an op's tensor arguments in its payload, from its
    header's sizes and the slot count ``b``."""
    if op == _OP_PREFILL:  # (rows, bucket): padded, slots, true_lens
        return [(dims[0], dims[1]), (dims[0],), (dims[0],)]
    if op == _OP_DECODE:  # (kv_bucket,): tokens, active
        return [(b,), (b,)]
    if op == _OP_VERIFY:  # (T, kv_bucket): draft, active, cap
        return [(b, dims[0]), (b,), (b,)]
    if op == _OP_CHUNK:  # (C, kv_bucket, window pages or 0): (slot, offset, new_len), chunk, ids
        return [(3,), (1, dims[0])] + ([(dims[2],)] if dims[2] else [])
    if op in (_OP_COPY, _OP_SWAP_OUT, _OP_SWAP_IN):  # (n, ...): two id lists
        return [(dims[0],), (dims[0],)]
    if op == _OP_SNAPSHOT:  # (pool blocks, host blocks, stage): the two id lists
        return [(dims[0],), (dims[1],)]
    if op == _OP_UPLOAD:  # (n, stage, into the host tier): the n pool or host ids
        return [(dims[0],)]
    if op == _OP_PREFIX:  # (key, padded length, n, C): the padded prompt, each chunk's window
        return [(1, dims[1]), (dims[1] // dims[3],)]
    if op in (_OP_INSTALL, _OP_DROP, _OP_TIER):
        return []
    raise RuntimeError(f"unknown op {op} from rank 0")


def _device_ids(values, device: torch.device) -> torch.Tensor:
    """Host ids as an int64 tensor on ``device``, without a host wait (on
    CUDA through pinned memory)."""
    x = torch.as_tensor(values, dtype=torch.long)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _runs(ids: list[int]):
    """(index, first id, length) of each run of consecutive ids in
    ``ids``: the host-tier blocks one copy moves."""
    i = 0
    while i < len(ids):
        r = 1
        while i + r < len(ids) and ids[i + r] == ids[i] + r:
            r += 1
        yield i, ids[i], r
        i += r


def to_host(tier: dict, snap: dict, host: list[int], non_blocking: bool) -> None:
    """Copy a staging snapshot (``swap_page_gather``'s block-major planes)
    into host-tier blocks ``host``, one copy a plane for each run of
    consecutive host blocks."""
    for j, h, r in _runs(host):
        for key, x in snap.items():
            tier[key][h:h + r].copy_(x[j:j + r], non_blocking=non_blocking)


def head_axis_concat(shards: list[dict], out: dict) -> dict:
    """Whole-head block-major planes from every rank's head shard, in rank
    order: axis 3 of [n, L, page, heads, Dh] and of the scale planes'
    [n, L, page, heads] alike, into ``out``'s planes."""
    for key, buf in out.items():
        torch.cat([shard[key] for shard in shards], dim=3, out=buf)
    return out


def head_slice(planes: dict, rank: int, size: int, pin: bool = False) -> dict:
    """Rank ``rank``'s heads of whole-head block-major planes (axis 3), each
    contiguous on the host (pinned with ``pin``): the inverse of
    ``head_axis_concat``."""
    out = {}
    for key, x in planes.items():
        h = x.shape[3] // size
        part = x.narrow(3, rank * h, h)
        out[key] = torch.empty(part.shape, dtype=part.dtype, pin_memory=pin).copy_(part)
    return out


def _to_bytes(planes: dict) -> torch.Tensor:
    """Planes as one flat uint8 tensor, plane after plane: what the
    migration ops' collectives carry (the header's int64 payload carries
    ids only)."""
    return torch.cat([x.reshape(-1).view(torch.uint8) for x in planes.values()])


def _from_bytes(flat: torch.Tensor, like: dict) -> dict:
    """``_to_bytes``' inverse for planes shaped as ``like``'s."""
    out, at = {}, 0
    for key, x in like.items():
        n = x.numel() * x.element_size()
        out[key] = flat[at:at + n].view(x.dtype).view(x.shape)
        at += n
    return out


def copy_blocks(state: dict, src: list[int], dst: list[int]) -> dict:
    """Pool block ``src[i]`` copied into block ``dst[i]``, every layer and
    plane (scales included), in place: a prefix's copy-on-write boundary
    block."""
    for s, d in zip(src, dst):
        for key in kv_keys(state):
            state[key][:, d].copy_(state[key][:, s])
    return state


def restore_pages(state: dict, tier: dict, blocks: list[int], host: list[int],
                  stage: int) -> dict:
    """The swap-in of host-tier blocks ``host`` into pool ``blocks`` (same
    order) on the current stream, ahead of the step that reads them: up to
    ``stage`` blocks at a time, the pinned host blocks copy non-blocking
    into a device staging buffer (one copy a plane for each run of
    consecutive host blocks) and the staging scatter writes them into the
    pool in place."""
    dev = state["k"].device
    cuda = dev.type == "cuda"
    for i in range(0, len(blocks), stage):
        grp, hgrp = blocks[i:i + stage], host[i:i + stage]
        pages = {}
        for key, plane in tier.items():
            buf = torch.empty((len(grp),) + tuple(plane.shape[1:]), dtype=plane.dtype,
                              device=dev)
            for j, h, r in _runs(hgrp):
                buf[j:j + r].copy_(plane[h:h + r], non_blocking=cuda)
            pages[key] = buf
        swap_page_scatter(state, _device_ids(grp, dev), pages)
    return state


def sampled_decode_step(model: Any, temperature: float, top_k: int, top_p: float,
                        logprobs: bool = False):
    """Compose a slot model's decode_step with the on-device sampler:

        (params, state, tokens[B], active[B], gens[B], kv_bucket)
            -> (next_tokens [B] int32, state)

    With ``logprobs`` the first element is the pair (next_tokens [B] int32,
    logprobs [B] f32): log p(token) under the sampled distribution. A tick
    hands the host [B] tokens (and logprobs), never [B, vocab] logits."""

    def step(params, state, tokens, active, gens, kv_bucket):
        logits, state = model.decode_step(params, state, tokens, active, kv_bucket)
        return sample_tokens(logits, gens, temperature, top_k, top_p, logprobs), state

    return step


def multi_tick_decode_step(model: Any, temperature: float, top_k: int, top_p: float,
                           logprobs: bool, k: int, eos_token: int):
    """Compose a slot model's decode_step with the on-device sampler into a
    k-tick flush (models.transformer.multi_tick_decode):

        (params, state, tokens[B], active[B], cap[B], gens[B], kv_bucket)
            -> ((out [B, k] int32, counts [B] int32, carry [B] int32,
                 logprobs [B, k] f32 or None), state)

    The loop body is the unchanged decode step, so a flush is token-equal
    to k single ticks, and the sampler draws from each slot's generator
    once an inner tick, k times a flush, as k eager ticks would. ``cap`` is
    each slot's remaining budget clamped to k (its early-exit wall);
    ``eos_token`` freezes a slot the tick after it samples it."""

    def step(params, state, tokens, active, cap, gens, kv_bucket):
        def decode(st, tok, act):
            return model.decode_step(params, st, tok, act, kv_bucket)

        def sample(logits, gens):
            out = sample_tokens(logits, gens, temperature, top_k, top_p, logprobs)
            return out if logprobs else (out, None)

        out, counts, carry, lps, state = multi_tick_decode(
            decode, sample, k, eos_token, logprobs, state, tokens, active, gens, cap)
        return (out, counts, carry, lps), state

    return step


def verify_step(model: Any):
    """A slot model's spec_step in the engine's step signature:

        (params, state, draft[B, T], active[B], cap[B], gens, kv_bucket)
            -> ((pred [B, T] int32, count [B] int32), state)

    the synchronous loop's verify tick (greedy: ``gens`` is unused)."""

    def step(params, state, draft, active, cap, gens, kv_bucket):
        pred, count, state = model.spec_step(params, state, draft, active, cap, kv_bucket)
        return (pred, count), state

    return step


def fused_spec_decode_step(model: Any, k: int, spec_tokens: int, eos_token: int, ngram: int):
    """Compose a slot model's spec_step (the ``batched_spec_step`` verify
    trunk) with the on-device n-gram draft into a fused speculation flush
    (models.transformer.multi_tick_spec_decode):

        (params, state, tokens[B], active[B], cap[B], hist[B, W],
         hist_len[B], gens, kv_bucket, k_dyn=None)
            -> ((out [B, k, spec_tokens+1] int32, counts [B, k] int32,
                 carry [B] int32), state)

    The inner body is the unchanged spec_step, so a fused flush is
    token-equal to k host-drafted verify ticks, and greedy verification
    makes both token-equal to plain greedy decode. ``hist``/``hist_len``
    are each slot's recent tokens (right-aligned) for the draft; ``cap``
    the remaining budgets; ``k_dyn`` the inner ticks this call runs (a
    LoopPolicy's pick; the output keeps k columns). Speculation is greedy
    only: ``gens`` is accepted for a uniform step signature and unused."""

    def step(params, state, tokens, active, cap, hist, hist_len, gens, kv_bucket, k_dyn=None):
        def spec(st, draft, act, bud):
            return model.spec_step(params, st, draft, act, bud, kv_bucket)

        out, counts, carry, state = multi_tick_spec_decode(
            spec, k, spec_tokens, ngram, eos_token, state, tokens, active, cap, hist,
            hist_len, k_dyn)
        return (out, counts, carry), state

    return step


def batched_admission_step(model: Any, temperature: float, top_k: int, top_p: float):
    """Compose the batched prefill with the on-device sampler into one
    admission step:

        (params, state, buf[B], tokens[N, bucket], slots[N], true_lens[N],
         gens[N]) -> (first_tokens [N] int32, buf[B], state)

    N prompts' trunk forward, the per-slot KV scatter, the N first tokens
    and their scatter into the engine's per-slot first-token buffer ``buf``
    all happen without a host sync; the next decode tick reads the tokens
    from ``buf``. A ``timer=`` keyword goes on to the prefill (a stage
    timer of the model's ``timed_stages``)."""

    def step(params, state, buf, tokens, slots, true_lens, gens, **timer):
        last, state = model.prefill_into_slots(params, state, tokens, slots, true_lens, **timer)
        tok = sample_tokens(last, gens, temperature, top_k, top_p)
        buf[slots] = tok
        return tok, buf, state

    return step


def swap_page_gather(state: dict, ids: torch.Tensor) -> dict:
    """KV-overcommit D2H staging source (the reference's
    ``swap_page_gather``): gather pool blocks ``ids`` ([n] int64 on the
    pool's device, n up to ``kv_swap_stage_blocks``; a padded id 0 names
    the null block) of every KV plane, the int8 scale planes included, into
    a fresh contiguous snapshot: one [n, L, page, ...] tensor a plane,
    block-major, so each block is one contiguous run that copies to its
    host-tier block in one transfer. The snapshot owns its memory: the
    engine releases the blocks (and a later step may overwrite them) as
    soon as the gather is enqueued, since stream order runs it first."""
    return {key: state[key].transpose(0, 1).index_select(0, ids) for key in kv_keys(state)}


def swap_page_scatter(state: dict, ids: torch.Tensor, pages: dict) -> dict:
    """KV-overcommit H2D staging sink (the reference's
    ``swap_page_scatter``): write staged blocks (the gather's block-major
    [n, L, page, ...] plane dict, uploaded from the host tier) into pool
    blocks ``ids`` IN PLACE, ``index_copy_`` on the state's own tensors,
    whose addresses the decode graphs hold. A padded id 0 writes the null
    block, which every reader masks; its staged pages must be finite
    (zeros): a masked read still multiplies by them. Returns the state."""
    for key, val in pages.items():
        state[key].index_copy_(1, ids, val.transpose(0, 1))
    return state


class TransformerSlotModel:
    """Dense transformer with a slot-pooled KV cache: a dense per-slot ring,
    or with ``kv_page`` a paged block pool whose page table the engine
    fills at admission. With ``cfg.kv_int8`` either holds int8 values with
    f32 scale planes beside them, as ``init_kv_cache`` and
    ``init_paged_kv_cache`` lay them out. ``paged_attn`` (None, "kernel",
    "gather") is the paged read-route override.

    With ``mesh`` (a vtpu_torch.parallel.TpMesh) ``params`` is this rank's
    tensor-parallel shard (``shard_params``, or ``params_from_numpy(...,
    mesh=)``) and the cache or pool holds its n_heads / tp heads; tables
    and lengths are whole on every rank. Rank 0's adapter drives: every
    call of the engine's (each step, and each KV write outside a step:
    ``copy_blocks``, the dense prefix buffers, the host tier and its swaps)
    first broadcasts the op with the paged route this adapter runs on, its
    sizes, its tensor arguments and rank 0's current table and lengths
    (the engine's own writes of a table row or a length, at a reservation,
    a resume or a handoff, so reach every rank before the next op reads
    them), then runs it. The other ranks' adapters run the same op on
    their shards from ``follow``, one at a time on one stream. A lock keeps
    one call (and its broadcasts) at a time: the loop thread and the
    prefill workers both call the adapter, so the lock's order is the
    followers' order. On one device there is no lock: the calls run as
    their callers issue them. A flush or a fused flush calls
    ``decode_step`` or ``spec_step`` once an inner tick, each its own op:
    rank 0's sampler and n-gram draft decide every tick, and the followers
    receive the tokens."""

    family = "dense transformer"
    supports_kv_buckets = True
    # the family's post-attention block in the decode trunk (None: the
    # dense MLP)
    _ffn = None
    # the stages of an admission a stage timer can lap (none: the dense
    # family is timed per dispatch only)
    timed_stages = ()

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
            if mesh.size > 1 and mesh.rank == 0 and mesh.group is not None:
                _claim_group(self, mesh)
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.max_context = cfg.max_seq
        self.kv_page = kv_page
        self.kv_pool_blocks = kv_pool_blocks
        self.paged_attn = paged_attn
        self.n_kv_blocks = None  # usable blocks + the null block, at init_state
        # one call and its broadcasts at a time, only where they reach
        # other ranks
        self._lock = (threading.Lock() if mesh is not None and mesh.size > 1
                      else contextlib.nullcontext())
        self._stopped = False
        # dense prefix buffers by key (this rank's head shard), each with
        # its true length; the host tier of overcommit
        self._prefixes: dict[int, tuple[dict, int]] = {}
        self._prefix_keys = itertools.count()
        self._host_pool: dict[str, torch.Tensor] = {}

    # ------------------------------------------------- the engine's calls

    def init_state(self, slots: int):
        with self._lock:
            self._announce(_OP_INIT, (slots,))
            return self._init_state(slots)

    def prefill_into_slot(self, params, state, padded, slot, true_len, timer=None):
        # a rebuild inside a swap dispatch calls this: no host wait
        dev = padded.device
        last, state = self.prefill_into_slots(
            params, state, padded, _device_ids([slot], dev), _device_ids([true_len], dev),
            timer=timer)
        return last[0], state

    def prefill_into_slots(self, params, state, padded, slots, true_lens, timer=None):
        """``timer``: a stage timer (vtpu_torch/obs/devtime.py) of the
        ``timed_stages``, on this rank's work only."""
        with self._lock:
            self._announce(_OP_PREFILL, tuple(padded.shape), (padded, slots, true_lens), state)
            return self._prefill(params, state, padded, slots, true_lens, timer)

    def decode_step(self, params, state, tokens, active, kv_bucket):
        with self._lock:
            self._announce(_OP_DECODE, (kv_bucket,), (tokens, active), state)
            return self._decode(params, state, tokens, active, kv_bucket)

    def spec_step(self, params, state, draft, active, cap, kv_bucket):
        """One verify tick over a [B, T] draft (engine.py's
        ``batched_spec_step``): (pred [B, T], count [B], state)."""
        with self._lock:
            self._announce(_OP_VERIFY, (draft.shape[1], kv_bucket), (draft, active, cap), state)
            return self._verify(params, state, draft, active, cap, kv_bucket)

    def prefill_chunk_into_slot(self, params, state, chunk, slot, offset, new_len,
                                kv_bucket=0, block_ids=None, timer=None):
        """One [1, C] prompt chunk into *slot* at ``offset`` (engine.py's
        ``chunked_prefill_into_slot``)."""
        with self._lock:
            ids = () if block_ids is None else (block_ids,)
            self._announce(_OP_CHUNK, (chunk.shape[1], kv_bucket, sum(x.numel() for x in ids)),
                           ([slot, offset, new_len], chunk) + ids, state)
            return self._chunk(params, state, chunk, slot, offset, new_len, kv_bucket,
                               block_ids, timer)

    def copy_blocks(self, state, src: list[int], dst: list[int]):
        """Pool block ``src[i]`` into ``dst[i]`` on every rank (a prefix's
        copy-on-write boundary block), on the caller's stream."""
        with self._lock:
            self._announce(_OP_COPY, (len(src),), (src, dst), state)
            return copy_blocks(state, src, dst)

    def build_prefix(self, params, state, padded, n: int, chunk: int,
                     buckets: list[int]) -> tuple[int, torch.Tensor]:
        """Chunk-prefill a [1, pad] padded prefix (``n`` true tokens,
        ``buckets`` each chunk's read window) into a one-row dense cache of
        its own, never the serving state, on every rank, and keep its
        padded length's KV (this rank's head shard) under a new key.
        Returns (the key, the last true position's logits [vocab])."""
        with self._lock:
            key = next(self._prefix_keys)
            self._announce(_OP_PREFIX, (key, padded.shape[1], n, chunk), (padded, buckets),
                           state)
            return key, self._build_prefix(params, key, padded, n, chunk, buckets)

    def install_prefix(self, state, key: int, slot: int):
        """Copy prefix ``key``'s buffers into *slot*'s leading positions
        and set its length, in place, on every rank."""
        with self._lock:
            self._announce(_OP_INSTALL, (key, slot), (), state)
            return self._install_prefix(state, key, slot)

    def drop_prefix(self, state, key: int) -> None:
        with self._lock:
            self._announce(_OP_DROP, (key,), (), state)
            self._prefixes.pop(key, None)

    def init_host_tier(self, state, blocks: int, pin: bool) -> dict:
        """The KV-overcommit host tier on every rank: one preallocated
        plane per KV plane, scale planes included, [blocks, L, page, ...]
        block-major (each host block one contiguous run; this rank's head
        shard), pinned when ``pin``. Returns rank 0's tier."""
        with self._lock:
            self._announce(_OP_TIER, (blocks, int(pin)), (), state)
            return self._init_host_tier(state, blocks, pin)

    def swap_out(self, state, blocks: list[int], host: list[int], stage: int) -> list:
        """The staging gathers of a swap-out of pool ``blocks`` to host-tier
        blocks ``host``, ``stage`` blocks each: [(index, snapshot)], whose
        host copies the caller enqueues (rank 0's engine, on its side
        stream). Every other rank gathers its head shard of the same blocks
        on its stream and copies it into its own tier behind them."""
        with self._lock:
            self._announce(_OP_SWAP_OUT, (len(blocks), stage), (blocks, host), state)
            return self._gather(state, blocks, stage)

    def swap_in(self, state, blocks: list[int], host: list[int], stage: int):
        """Host-tier blocks ``host`` back into pool ``blocks``, in place, on
        every rank from its own tier (``restore_pages``)."""
        with self._lock:
            self._announce(_OP_SWAP_IN, (len(blocks), stage), (blocks, host), state)
            return restore_pages(state, self._host_pool, blocks, host, stage)

    def snapshot(self, state, blocks: list[int], host: list[int], stage: int):
        """A migrating session's pages as host memory, block-major, whole
        heads: pool ``blocks`` (through the staging gathers, ``stage``
        blocks each) then host-tier blocks ``host``, [n, L, page, ...] a
        plane, pinned on a card. Every rank gathers its own head shard of
        the pool blocks and reads its own tier's, and rank 0 assembles the
        heads (``head_axis_concat``) from an all-gather of the shards'
        bytes. No rank's host tier is written. Rank 0 gets the payload;
        the caller makes sure its own tier's spills of ``host`` landed."""
        with self._lock:
            self._announce(_OP_SNAPSHOT, (len(blocks), len(host), stage), (blocks, host),
                           state)
            return self._snapshot(state, blocks, host, stage)

    def upload(self, state, payload: dict, ids: list[int], stage: int, tier: bool = False):
        """A migrating session's whole-head payload (``snapshot``'s layout)
        onto every rank's head shard: into pool ``ids`` through the
        staging scatters (``restore_pages``), or with ``tier`` into host-
        tier blocks ``ids``. Rank 0 broadcasts the payload's bytes and each
        rank keeps its own heads (``head_slice``); no rank builds the whole
        pool. On a card the caller makes sure no spill into those host
        blocks is still in flight on its side stream."""
        with self._lock:
            self._announce(_OP_UPLOAD, (len(ids), stage, int(tier)), (ids,), state)
            return self._upload(state, payload, ids, stage, tier)

    def stop_workers(self) -> None:
        """Rank 0: tell the other ranks to leave ``follow`` (once). A no-op
        without a mesh."""
        with self._lock:
            if self._drives() and not self._stopped:
                self._stopped = True
                broadcast_(torch.tensor([_OP_STOP] + [0] * (_HEADER - 1)), self.mesh)
                if _GROUP_OWNERS.get(id(self.mesh.group)) is self:
                    del _GROUP_OWNERS[id(self.mesh.group)]

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
        header = torch.tensor([op, _ROUTES.index(self.paged_attn), *dims]
                              + [0] * (_HEADER - 2 - len(dims)))
        broadcast_(header, self.mesh)
        if op == _OP_INIT:
            return
        parts = [x if torch.is_tensor(x) else torch.tensor(x) for x in tensors]
        parts += [state[key] for key in _MIRRORED if key in state]
        broadcast_(torch.cat([x.reshape(-1).to(device=self.device, dtype=torch.int64)
                              for x in parts]), self.mesh)

    def follow(self, state):
        """A non-zero rank's side of rank 0's next call: receive it and run
        it on this rank's shard, on the paged route rank 0 runs, after
        overwriting the table and lengths with rank 0's. Returns (False,
        state) when rank 0 stopped the workers, else (True, the new
        state)."""
        header = broadcast_(torch.zeros(_HEADER, dtype=torch.int64), self.mesh)
        op, route, *dims = header.tolist()
        if op == _OP_STOP:
            return False, state
        self.paged_attn = _ROUTES[route]
        if op == _OP_INIT:
            return True, self._init_state(dims[0])
        shapes = _payload_shapes(op, dims, state["len"].shape[0])
        mirrored = [state[key] for key in _MIRRORED if key in state]
        sizes = [math.prod(shape) for shape in shapes] + [x.numel() for x in mirrored]
        payload = broadcast_(torch.empty(sum(sizes), dtype=torch.int64, device=self.device),
                             self.mesh)
        parts = torch.split(payload, sizes)
        for x, part in zip(mirrored, parts[len(shapes):]):
            x.copy_(part.view(x.shape))
        return True, self._run(op, dims, [p.view(s) for p, s in zip(parts, shapes)], state)

    def _run(self, op: int, dims: list, args: list, state):
        """A follower's run of one op of rank 0's on its own shard."""
        i32 = torch.int32
        if op == _OP_PREFILL:
            _, state = self._prefill(self.params, state, *args)
        elif op == _OP_DECODE:
            tokens, active = args
            _, state = self._decode(self.params, state, tokens.to(i32), active.bool(), dims[0])
        elif op == _OP_VERIFY:
            draft, active, cap = args
            _, _, state = self._verify(self.params, state, draft.to(i32), active.bool(),
                                       cap.to(i32), dims[1])
        elif op == _OP_CHUNK:
            (slot, offset, new_len), chunk = args[0].tolist(), args[1]
            _, state = self._chunk(self.params, state, chunk.to(i32), slot, offset, new_len,
                                   dims[1], args[2] if dims[2] else None)
        elif op == _OP_COPY:
            state = copy_blocks(state, args[0].tolist(), args[1].tolist())
        elif op == _OP_PREFIX:
            self._build_prefix(self.params, dims[0], args[0].to(i32), dims[2], dims[3],
                               args[1].tolist())
        elif op == _OP_INSTALL:
            state = self._install_prefix(state, dims[0], dims[1])
        elif op == _OP_DROP:
            self._prefixes.pop(dims[0], None)
        elif op == _OP_TIER:
            self._init_host_tier(state, dims[0], bool(dims[1]))
        elif op == _OP_SWAP_OUT:
            blocks, host = args[0].tolist(), args[1].tolist()
            # on this rank's stream, so a later op that writes the blocks
            # runs after the gather, and a swap-in after the copies
            for i, snap in self._gather(state, blocks, dims[1]):
                to_host(self._host_pool, snap, host[i:i + dims[1]],
                        non_blocking=self.device.type == "cuda")
        elif op == _OP_SWAP_IN:
            state = restore_pages(state, self._host_pool, args[0].tolist(), args[1].tolist(),
                                  dims[1])
        elif op == _OP_SNAPSHOT:
            self._snapshot(state, args[0].tolist(), args[1].tolist(), dims[2])
        elif op == _OP_UPLOAD:
            state = self._upload(state, None, args[0].tolist(), dims[1], bool(dims[2]))
        else:
            raise RuntimeError(f"unknown op {op} from rank 0")
        return state

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

    def _prefill_fn(self, true_lens, timer=None):
        """The family's full-sequence forward for an admission, gathering
        each row's final position before the vocab projection (so the
        [N, bucket, vocab] logits never exist). The dense family times no
        stages."""
        return lambda p, c, t, mesh: prefill(p, c, t, logits_at=true_lens - 1, mesh=mesh)

    def _timed_ffn(self, timer):
        """The decode trunk's post-attention block for a prefill chunk,
        its stages timed by ``timer`` where the family has any."""
        return self._ffn

    def _prefill(self, params, state, padded, slots, true_lens, timer=None):
        from vtpu_torch.serving.engine import prefill_into_slots

        return prefill_into_slots(params, self.cfg, state, padded, slots, true_lens,
                                  prefill_fn=self._prefill_fn(true_lens, timer), mesh=self.mesh)

    def _decode(self, params, state, tokens, active, kv_bucket):
        from vtpu_torch.serving.engine import batched_decode_step

        return batched_decode_step(params, self.cfg, state, tokens, active,
                                   kv_bucket=kv_bucket, ffn_fn=self._ffn,
                                   paged_attn=self.paged_attn, mesh=self.mesh)

    def _verify(self, params, state, draft, active, cap, kv_bucket):
        from vtpu_torch.serving.engine import batched_spec_step

        return batched_spec_step(params, self.cfg, state, draft, active, cap,
                                 kv_bucket=kv_bucket, ffn_fn=self._ffn,
                                 paged_attn=self.paged_attn, mesh=self.mesh)

    def _chunk(self, params, state, chunk, slot, offset, new_len, kv_bucket, block_ids,
               timer=None):
        from vtpu_torch.serving.engine import chunked_prefill_into_slot

        return chunked_prefill_into_slot(params, self.cfg, state, chunk, slot, offset,
                                         new_len, kv_bucket=kv_bucket, block_ids=block_ids,
                                         ffn_fn=self._timed_ffn(timer), mesh=self.mesh)

    def _build_prefix(self, params, key: int, padded, n: int, chunk: int,
                      buckets: list[int]) -> torch.Tensor:
        scratch = init_kv_cache(self.cfg, 1, device=self.device, mesh=self.mesh)
        pad = padded.shape[1]
        logits = None
        for j, off in enumerate(range(0, pad, chunk)):
            logits, scratch = self._chunk(params, scratch, padded[:, off:off + chunk], 0, off,
                                          min(off + chunk, n), buckets[j], None)
        self._prefixes[key] = ({k: scratch[k][:, 0, :pad].clone() for k in kv_keys(scratch)}, n)
        return logits[0, (n - 1) - (pad - chunk)]

    def _install_prefix(self, state, key: int, slot: int):
        buffers, n = self._prefixes[key]
        for k, buf in buffers.items():
            state[k][:, slot, :buf.shape[1]].copy_(buf)
        state["len"][slot].fill_(n)
        return state

    def _init_host_tier(self, state, blocks: int, pin: bool) -> dict:
        self._host_pool = {
            key: torch.empty((blocks, state[key].shape[0]) + tuple(state[key].shape[2:]),
                             dtype=state[key].dtype, pin_memory=pin)
            for key in kv_keys(state)}
        return self._host_pool

    def _gather(self, state, blocks: list[int], stage: int) -> list:
        return [(i, swap_page_gather(state, _device_ids(blocks[i:i + stage], self.device)))
                for i in range(0, len(blocks), stage)]

    def _split(self) -> bool:
        """Whether the heads are split over more than one rank."""
        return self.mesh is not None and self.mesh.size > 1

    def _snapshot(self, state, blocks: list[int], host: list[int], stage: int):
        cuda = self.device.type == "cuda"
        n = len(blocks) + len(host)
        mine = {key: torch.empty((n, state[key].shape[0]) + tuple(state[key].shape[2:]),
                                 dtype=state[key].dtype, pin_memory=cuda)
                for key in kv_keys(state)}
        for i, snap in self._gather(state, blocks, stage):
            to_host(mine, snap, list(range(i, min(i + stage, len(blocks)))),
                    non_blocking=cuda)
        if cuda and (blocks or self._split()):
            # the gathers' copies, and on a follower the spills its stream
            # queued into its own tier, have landed before the host reads
            torch.cuda.current_stream(self.device).synchronize()
        done = len(blocks)
        for j, h, r in _runs(host):
            for key, buf in mine.items():
                buf[done + j:done + j + r].copy_(self._host_pool[key][h:h + r])
        if not self._split():
            return mine
        shards = all_gather(_to_bytes(mine), self.mesh)
        if self.mesh.rank != 0:
            return None
        whole = {key: torch.empty(x.shape[:3] + (x.shape[3] * self.mesh.size,) + x.shape[4:],
                                  dtype=x.dtype, pin_memory=cuda) for key, x in mine.items()}
        return head_axis_concat([_from_bytes(b, mine) for b in shards], whole)

    def _upload(self, state, payload: Optional[dict], ids: list[int], stage: int,
                tier: bool):
        cuda = self.device.type == "cuda"
        if self._split():
            size, rank = self.mesh.size, self.mesh.rank
            # the whole-head planes' shapes, without their memory
            like = {key: torch.empty((len(ids), state[key].shape[0])
                                     + tuple(state[key].shape[2:3])
                                     + (state[key].shape[3] * size,)
                                     + tuple(state[key].shape[4:]),
                                     dtype=state[key].dtype, device="meta")
                    for key in kv_keys(state)}
            if rank == 0:
                flat = _to_bytes({key: payload[key] for key in like})
            else:
                flat = torch.empty(sum(x.numel() * x.element_size() for x in like.values()),
                                   dtype=torch.uint8)
            broadcast_(flat, self.mesh)
            payload = head_slice(_from_bytes(flat, like), rank, size, pin=cuda)
        if not tier:
            return restore_pages(state, payload, ids, list(range(len(ids))), stage)
        if cuda and self.mesh is not None and self.mesh.rank != 0:
            # a follower's spills copy on its own stream: land them before
            # the host writes
            torch.cuda.current_stream(self.device).synchronize()
        for j, h, r in _runs(ids):
            for key, plane in self._host_pool.items():
                plane[h:h + r].copy_(payload[key][j:j + r])
        return state


def _claim_group(model: "TransformerSlotModel", mesh: Any) -> None:
    """Make ``model`` the one owner of its mesh's process group, or refuse
    while another live adapter drives it."""
    other = _GROUP_OWNERS.get(id(mesh.group))
    if other is not None and other.mesh.group is mesh.group and not other._stopped:
        raise ValueError(
            f"another engine's adapter drives this process group (tp={mesh.size}): two "
            "engines' broadcasts on one group would interleave on its followers; give each "
            "engine its own group (vtpu_torch.parallel.own_group)")
    _GROUP_OWNERS[id(mesh.group)] = model


def _validate_serving_mesh(mesh: Any, cfg: Any) -> None:
    """Construction-time checks of a tensor-parallel serving mesh; each
    error names the numbers at fault (reference: adapters.py
    ``_validate_serving_mesh``; a TpMesh has the 'tp' axis only). The dense
    MLP splits d_ff over 'tp'; the MoE's experts split on their own axis
    (``MoeSlotModel``)."""
    tp = int(mesh.shape["tp"])
    if cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide the attention head count "
            f"(n_heads={cfg.n_heads}): q/k/v and the KV cache/pool split "
            "their head axis over 'tp'"
            + (f", as do the int8 k_scale/v_scale planes (n_heads = {cfg.n_heads})"
               if kv_quantized(cfg) else ""))
    if not hasattr(cfg, "n_experts") and cfg.d_ff % tp:
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


class MoeSlotModel(TransformerSlotModel):
    """Mixture-of-Experts (vtpu_torch/models/moe.py): the dense family's
    attention trunk with routed experts as its post-attention block, so it
    shares the slot KV machinery (a dense cache or the paged pool, bf16 or
    int8, bounded read windows, both paged read routes) and only swaps the
    FFN: ``moe_decode_ffn`` in decode, verify and chunk steps (capacity =
    every token of the step, so nothing drops), ``moe_prefill`` with each
    row's true length at admission (pads masked out of routing, capacity by
    the config's formula).

    With ``mesh`` the attention trunk splits as the dense family's and the
    expert stacks split their expert axis over 'tp' when it divides
    ``n_experts`` (``shard_moe_params``; replicated otherwise): every rank
    routes every token with the same replicated router, so the same
    choices drop, runs its own experts only, and the partial combines are
    summed by one all-reduce a layer (none with replicated experts)."""

    family = "MoE"
    # the stages an admission's stage timer laps (the engine hands one to
    # prefill_into_slot(s) and prefill_chunk_into_slot with its ring on)
    timed_stages = MOE_STAGES

    def __init__(self, params: Any, cfg: Any, kv_page: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 paged_attn: Optional[str] = None, device=None, mesh=None):
        super().__init__(params, cfg, kv_page=kv_page, kv_pool_blocks=kv_pool_blocks,
                         paged_attn=paged_attn, device=device, mesh=mesh)
        if mesh is not None:
            tp = mesh.size
            want = cfg.n_experts // tp if cfg.n_experts % tp == 0 else cfg.n_experts
            got = params["layers"]["w_gate"].shape[1]
            if got != want:
                raise ValueError(
                    f"under tp={tp} the MoE params must be one rank's shard (shard_moe_params): "
                    f"w_gate holds {got} experts, expected {want} of n_experts={cfg.n_experts}")
        self._ffn = moe_decode_ffn(cfg, mesh=mesh)

    def _prefill_fn(self, true_lens, timer=None):
        # true_lens masks each row's pads out of routing
        return lambda p, c, t, mesh: moe_prefill(p, c, t, true_len=true_lens,
                                                 logits_at=true_lens - 1, mesh=mesh, timer=timer)

    def _timed_ffn(self, timer):
        return self._ffn if timer is None else moe_decode_ffn(self.cfg, mesh=self.mesh,
                                                               timer=timer)


class SsmSlotModel:
    """Selective SSM (vtpu_torch/models/ssm.py): an O(1) recurrent state a
    slot (conv windows [L, B, K-1, Di] and SSM states [L, B, Di, N]), so
    there is no context cap and nothing for a read window to bound. Every
    write goes into the state's own tensors: an admission scatters each
    row's state at that row's true length into its slot, and a decode step
    writes the new state masked by ``active`` (an inactive slot keeps its
    state). No speculation, no chunked admission, no paged pool; one
    device only (the reference's takes no mesh)."""

    family = "selective SSM"
    supports_kv_buckets = False
    max_context = None
    kv_page = None
    paged_attn = None
    mesh = None

    def __init__(self, params: Any, cfg: Any, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device} but the model runs "
                f"on {self.device}")
        self.params = params
        self.cfg = cfg

    def init_state(self, slots: int):
        return init_ssm_state(self.cfg, slots, device=self.device)

    def prefill_into_slot(self, params, state, padded, slot, true_len):
        # a rebuild inside a swap dispatch calls this: no host wait
        dev = padded.device
        last, state = self.prefill_into_slots(
            params, state, padded, _device_ids([slot], dev), _device_ids([true_len], dev))
        return last[0], state

    def prefill_into_slots(self, params, state, padded, slots, true_lens):
        """N right-padded prompts in one forward; row i's state at
        true_lens[i] goes into slot slots[i] (distinct slots). Returns (last
        logits [N, vocab], state)."""
        last, rows = ssm_prefill(params, self.cfg, padded, true_lens, logits_at=true_lens - 1)
        for key in ("conv", "h"):
            state[key][:, slots] = rows[key].to(state[key].dtype)
        return last, state

    def decode_step(self, params, state, tokens, active, kv_bucket):
        """One recurrent step for every slot; ``kv_bucket`` is accepted for
        the shared step signature (no read window). Returns (logits [B,
        vocab], state)."""
        logits, new = ssm_decode_step(params, self.cfg, state, tokens)
        keep = active[None, :, None, None]
        for key in ("conv", "h"):
            state[key].copy_(torch.where(keep, new[key], state[key]))
        return logits, state

    def stop_workers(self) -> None:
        """One device: there are no worker ranks to stop."""
