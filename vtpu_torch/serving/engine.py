"""Continuous-batching serving engine over the model families.

Counterpart of vtpu/serving/engine.py: a model family's slot adapter
(serving/adapters.py: the dense transformer by default, or ``model=`` an
MoE or selective-SSM adapter) behind a fixed pool of B cache slots
(dense ring or paged block pool), bucketed batched admission with the first
tokens sampled on the device (or the serial path, ``async_admission=False``:
one prompt a dispatch and a blocking first-token fetch), chunked prefill for
prompts past the largest bucket (``prefill_chunk``) and registered shared
prefixes (``register_prefix`` / ``submit(prefix=)``), and the sampled decode
tick with ONE device->host fetch per tick (tokens, and their logprobs with
``logprobs=True``), on one of the reference's device-sampled loops: the
one-tick-deep pipelined loop (the default, as in the reference), the
synchronous loop (``pipeline_decode=False``), the multi-tick device loop
(``decode_loop_k``: k ticks a dispatch, one fetch a flush), speculation
(``spec_tokens``: prompt-lookup drafts verified K+1 positions a tick on the
synchronous loop) and, with both, fused speculation (draft and verify
inside the flush, its depth picked by a ``LoopPolicy``). On one CUDA card
each loop replays its steps from CUDA graphs (serving/graphs.py). KV
overcommit (``kv_swap``, paged pool, one device): ``park`` takes a session
out of the decode batch with its pages still in the pool; an admission or
resume the free list cannot cover evicts parked sessions' private pages,
lowest priority first and least recently parked within a priority, to a
preallocated pinned host tier (or drops them, to be rebuilt through
prefill on resume), and ``resume`` restores the session token-exact. A custom
``sample=`` callable runs the reference's host path: the synchronous loop
fetches the [B, vocab] logits once a tick and calls the callable per live
row. Requests join and leave slots without any shape
changing; inactive slots compute but their writes are dropped. The request
trace and the tick-phase profiler (vtpu_torch/obs) record what the loop
does, host-side only.

Failure domains: a failure ends one request, or degrades a route, never
the engine. ``submit(deadline_ms=)`` sheds a request that outlives its
deadline (SHED_DEADLINE), ``shed_queue_depth`` bounds the waiting line
(SHED_OVERLOAD, victims picked by a ``ShedPolicy``), an exception in one
request's delivery retires that slot alone (FAULTED), and the fetch
watchdog (``fetch_watchdog_ms``) degrades a stalled engine one rung at a
time and lifts the rungs once latency recovers. A ``FaultPlan``
(``ServingConfig.faults``, serving/faults.py) fires each seam on schedule.

Disaggregated prefill/decode (``disagg``, serving/disagg.py): prefill
workers, each on a thread and a CUDA stream of its own, claim the
waiting line, chunk-prefill into slot-less pool blocks and deliver the
first token; the loop installs each handoff into a free slot with one
table-row write and no KV copy, and restarts a worker that died.

What the port has not reached raises instead of being ignored:
``ModelConfig.kv_int8="auto"`` is refused. ``kv_int8=True`` serves int8
KV: dense or paged int8 planes with f32 scale planes beside them, written
quantized at every KV write site here. ``mesh=`` (a
vtpu_torch.parallel.TpMesh) serves every loop and feature above
tensor-parallel over torch.distributed, for the dense and MoE families:
see ``ServingEngine`` for how the ranks split the work.

Every write into the engine's state (a chunk's KV, a prefix install, a
copy-on-write block, a swap-in, a table row, a length) goes into the
state's own tensors in place: the CUDA graphs of the pipelined loop hold their
addresses, so a replaced tensor would leave a replay reading stale KV. Every
write into the KV planes goes through the adapter (a step, or
``copy_blocks``, ``install_prefix``, ``swap_in``), which under a mesh
makes it on every rank; a table row and a length are the engine's own
writes, which reach the other ranks with the adapter's next call.

Writes the reference drops. JAX's ``.at[...].set(..., mode="drop")`` lets an
out-of-range block id or position vanish (inactive lanes, positions past the
context wall, a retired slot's stale table row). A torch ``index_put_``
with such an index raises on the CPU and asserts on the device, and picking
the kept rows on the host would read the device every tick. So a dropped
row is sent to a target of its own (the null block 0 of a paged pool,
which every reader masks; its own clipped position in a dense cache) and
writes back what that target holds. A paged pool is never written through
a dropped row's table entry: a stale row may name blocks the allocator has
handed to another slot.

Host<->device traffic of the loop. Host values reach the device through
pinned memory with non-blocking copies, and the tick's tokens come back
through a copy staged into pinned memory right after the tick and waited
for at delivery: a copy from or to pageable memory would make the host wait
for the whole stream, and so, on the pipelined loop, for the tick in flight.
The host tier is pinned too: a swap-out's copies run on a side stream
behind the gather and are polled by an event at tick heads, a swap-in's
run on the main stream ahead of the tick that reads the blocks, and
neither makes the host wait.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import logging
import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from vtpu_torch.device import resolve_device
from vtpu_torch.models.transformer import (
    ModelConfig, Params, decode_layer_loop, kv_bytes_per_token, kv_keys, prefill,
    sample_tokens, spec_verify_loop, store_kv,
)
from vtpu_torch.obs import RequestTrace, TickProfiler, pct
from vtpu_torch.obs.trace import TERMINAL_CODES
from vtpu_torch.ops import _build
from vtpu_torch.ops.decode_attn import paged_attn_route
from vtpu_torch.serving.adapters import (
    TransformerSlotModel, batched_admission_step, fused_spec_decode_step,
    multi_tick_decode_step, sampled_decode_step, to_host, verify_step,
)
from vtpu_torch.serving.disagg import DisaggConfig, DisaggRuntime
from vtpu_torch.serving.faults import EngineDeath, FaultInjected, FaultPlan
from vtpu_torch.serving.graphs import DecodeGraphs
from vtpu_torch.serving.shed import (
    EngineSignals, accepts_signals, load_loop_policy, load_shed_policy,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The reference's serving knobs, field for field, every one served.
    Beside these fields: int8 KV (``ModelConfig.kv_int8=True``) and
    tensor-parallel serving (``ServingEngine(..., mesh=)``), dense or
    paged, on either paged route.

    ``decode_unroll`` only chooses how XLA lowers the reference's layer
    loop (unrolled or a fori_loop); the port's layer loop is a Python loop,
    always unrolled, so None, True and False serve the same computation.

    Every field is served under a tensor-parallel mesh as on one device.
    Deadlines, overload shedding, fault plans, the watchdog's rungs, the
    loop policy and the duty supplier are rank-0 host decisions; the other
    ranks follow rank 0's ops."""

    slots: int = 4  # concurrent sequences (the decode batch)
    prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024)
    max_new_tokens: int = 64
    eos_token: int = -1  # -1: never stops early
    # bounded KV read window per tick: None (auto) and True bucket the
    # window to the longest live sequence; False reads max_seq every tick
    kv_read_buckets: Optional[bool] = None
    decode_unroll: Optional[bool] = None  # accepted; see the docstring
    # speculative decoding: draft length K (0 = off). Drafts continue the
    # most recent earlier occurrence of the stream's last (up to)
    # spec_ngram tokens; one verify tick checks K+1 positions and emits
    # 1..K+1 tokens. Greedy only: a custom sampler, temperature > 0 or
    # logprobs disable it (stats()["spec_disabled_reason"] says which). A
    # tick where no slot finds a draft runs the plain decode step
    spec_tokens: int = 0
    spec_ngram: int = 3
    # drafting pauses while the EMA of tokens emitted per (slot, verify
    # tick) sits below this (0 = always speculate), and re-probes after
    # spec_cooloff_ticks plain ticks
    spec_min_mean: float = 1.25
    spec_cooloff_ticks: int = 64
    # prompts past the largest bucket (and prefixed suffixes) admit in
    # [1, C] chunks, one a loop pass between decode ticks; must divide
    # max_seq. None: no chunking
    prefill_chunk: Optional[int] = None
    # on-device sampling: temperature 0 is greedy; otherwise Gumbel-max over
    # the temperature/top-k/top-p filtered logits, one generator per slot
    # seeded from sampling_seed
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    sampling_seed: int = 0
    # stream log p(token) of every decoded token into Request.logprobs
    # (device sampling only)
    logprobs: bool = False
    # None (auto): the one-tick-deep pipelined loop with device sampling,
    # the synchronous loop with a custom sample= callable; True pipelines
    # (and raises with a custom sampler); False: synchronous
    pipeline_decode: Optional[bool] = None
    # same-bucket prompts coalesce into one [N, bucket] admission dispatch,
    # N the largest size here that fits the free slots (1 always included)
    prefill_batch_sizes: tuple[int, ...] = (1, 2, 4, 8)
    # None (auto): batched admission with device sampling, the serial path
    # with a custom sampler; True: batched (raises with a custom sampler);
    # False: serial, one [1, bucket] dispatch and a blocking first-token fetch
    async_admission: Optional[bool] = None
    # per-tick admission budget in prompt tokens, bypassed while nothing
    # decodes; 0 = uncapped
    prefill_budget: int = 0
    # paged KV pool: tokens per block (None = dense per-slot ring); must
    # divide max_seq and every prefill bucket
    kv_page: Optional[int] = None
    # usable pool blocks (excluding the null block 0); None = slots * pages
    kv_pool_blocks: Optional[int] = None
    # paged read route: None (auto: kernel on CUDA), "kernel" or "gather"
    paged_attn: Optional[str] = None
    # KV overcommit: the host tier's capacity in blocks (None = off, the
    # plain paged pool). Needs kv_page. park() keeps a session's pages in
    # the pool; an admission or resume the free list cannot cover evicts
    # parked sessions' private pages (lowest Request.priority first, least
    # recently parked within a priority) to the pinned host tier, or drops
    # them when it is full and the sequence can be rebuilt through prefill.
    # Shared prefix blocks are never evicted. 0: no host tier, every
    # eviction drops (recompute-only overcommit)
    kv_swap: Optional[int] = None
    # blocks one staging gather or scatter moves
    kv_swap_stage_blocks: int = 8
    # a resuming session of at most this many cached tokens is rebuilt
    # through prefill even when its host pages exist; 0 = recompute only
    # where the pages were dropped
    kv_swap_recompute_tokens: int = 0
    # request-trace ring capacity in events; 0 turns the ring off (the
    # latency percentiles in stats() stay live)
    trace_events: int = 16384
    # disaggregated prefill/decode: a DisaggConfig (serving/disagg.py) runs
    # prefill workers beside the loop (None: co-scheduled). Needs the paged
    # pool, prefill_chunk, device sampling, no speculation and batched
    # admission
    disagg: Optional[Any] = None
    # k decode ticks a dispatch with the sampled token fed back on the
    # device, one fetch a flush (None and 1: one tick a dispatch). Needs
    # device sampling. With spec_tokens the flush drafts and verifies on
    # the device (fused speculation)
    decode_loop_k: Optional[int] = None
    # the fused flush's depth: None = decode_loop_k every flush; else a
    # LoopPolicy (serving/shed.py; instance, class or "module:attr") that
    # picks it per flush, up to decode_loop_k. Requires the fused loop
    loop_policy: Optional[Any] = None
    # overload shedding: the waiting line's bound (0 = unbounded). Whatever
    # overflows it after a tick head's admissions ends SHED_OVERLOAD,
    # victims picked by shed_policy (serving/shed.py; None = lowest
    # priority first, nearest deadline within a tier; an instance, a class
    # or a "module:attr" string)
    shed_queue_depth: int = 0
    shed_policy: Optional[Any] = None
    # fetch watchdog: a fetch that waits past this many ms
    # steps the degradation ladder, first decode_loop_k down to one-token
    # flushes, then the paged route down to gather (0 = off); latency back
    # under it for fetch_watchdog_recover_ms lifts one rung at a time, the
    # last one first (0 = degradation is one-way). On one card every step
    # of both routes is captured when the engine is built
    fetch_watchdog_ms: float = 0.0
    fetch_watchdog_recover_ms: float = 0.0
    # a request whose prefill worker died is re-queued after
    # worker_retry_backoff_ms x 2^(deaths - 1), and ends FAULTED past
    # worker_retry_limit deaths
    worker_retry_limit: int = 2
    worker_retry_backoff_ms: float = 10.0
    # a FaultPlan (serving/faults.py): its seams fire on schedule; None =
    # every seam is one attribute check
    faults: Optional[Any] = None
    # a zero-argument callable returning the device's attested busy
    # fraction (or None): signals().duty, which a shed policy reads
    duty_supplier: Optional[Any] = None


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse what this port has not reached: ``kv_int8="auto"``. Every
    ServingConfig is ported, under a tensor-parallel mesh as on one device
    (the mesh itself is checked by the adapter, ``_validate_serving_mesh``)."""
    if isinstance(getattr(cfg, "kv_int8", False), str):
        raise NotImplementedError(
            f"ModelConfig.kv_int8={cfg.kv_int8!r} is not ported to vtpu_torch: the "
            "reference resolves 'auto' with a router measured on a TPU (v5e), and "
            "an H100 router needs an H100 measurement; pass True or False")


class BlockAllocator:
    """Host-side free list + refcounts over the shared KV block pool.

    Block 0 is RESERVED as the null block: unmapped page-table entries
    point at it, so padding reads land on one shared, always-masked block.
    The allocator manages ids 1..n_blocks-1; a block returns to the free
    list when its last mapping is released. Thread-safe."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (null + 1 usable), got {n_blocks}")
        self.n_blocks = n_blocks
        # LIFO: recently freed blocks are handed out first
        self._free = list(range(n_blocks - 1, 0, -1))
        self._ref = [0] * n_blocks
        self._min_free = n_blocks - 1
        self._lock = threading.Lock()

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_hwm(self) -> int:
        """Lifetime high-water mark of simultaneously allocated blocks."""
        with self._lock:
            return self.n_blocks - 1 - self._min_free

    def alloc(self, n: int) -> Optional[list[int]]:
        """n fresh blocks at refcount 1, or None (all-or-nothing)."""
        with self._lock:
            if n > len(self._free):
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            self._min_free = min(self._min_free, len(self._free))
            return out

    def share(self, blocks: list[int]) -> None:
        """Map already-live blocks into one more table (+1)."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(f"share of dead block {b}")
                self._ref[b] += 1

    def release(self, blocks: list[int]) -> None:
        """Drop one mapping per block; free it at refcount zero."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(f"double free of block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]


class WaitQueue:
    """FIFO admission queue: a deque plus a live-membership set, so removal
    from anywhere in the line is an O(1) tombstone and head pops stay O(1)
    amortized. Requests compare by identity. Iteration yields live entries
    in FIFO order off a snapshot (callers may tombstone mid-iteration).
    Thread-safe."""

    __slots__ = ("_q", "_live", "_lock")

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._live: set = set()
        self._lock = threading.Lock()

    def append(self, req) -> None:
        with self._lock:
            self._q.append(req)
            self._live.add(req)

    def remove(self, req) -> None:
        with self._lock:
            self._live.discard(req)

    def take(self, req) -> bool:
        """Atomically tombstone *req* if it is still live."""
        with self._lock:
            if req in self._live:
                self._live.discard(req)
                return True
            return False

    def _compact(self) -> None:
        q = self._q
        while q and q[0] not in self._live:
            q.popleft()

    def head(self):
        with self._lock:
            self._compact()
            return self._q[0] if self._q else None

    def popleft(self):
        with self._lock:
            self._compact()
            req = self._q.popleft()
            self._live.discard(req)
            return req

    def clear(self) -> None:
        with self._lock:
            self._q.clear()
            self._live.clear()

    def __contains__(self, req) -> bool:
        with self._lock:
            return req in self._live

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)

    def __iter__(self):
        with self._lock:
            snap = list(self._q)
            live = set(self._live)
        seen = set()
        for r in snap:
            # remove-then-append leaves a stale copy beside the live one
            if r in live and r not in seen:
                seen.add(r)
                yield r


class Status:
    """Typed terminal status, delivered exactly once per request."""

    OK = "OK"
    CANCELLED = "CANCELLED"
    SHED_DEADLINE = "SHED_DEADLINE"
    SHED_OVERLOAD = "SHED_OVERLOAD"
    FAULTED = "FAULTED"

    ALL = (OK, CANCELLED, SHED_DEADLINE, SHED_OVERLOAD, FAULTED)


class Terminal:
    """The end-of-stream sentinel ``Request.finish`` puts on the stream."""

    __slots__ = ("status",)

    def __init__(self, status: str):
        self.status = status

    def __repr__(self) -> str:
        return f"Terminal({self.status})"


@dataclasses.dataclass(eq=False)
class Request:
    # eq=False: requests compare by identity (the lifecycle checks use `is`)
    tokens: Any  # [S] int32 numpy prompt (the suffix when ``prefix`` is set)
    max_new_tokens: int = 0
    prefix: Optional[int] = None  # registered prefix id (register_prefix)
    # QoS tier of overcommit eviction and overload shedding: the lowest
    # priority leaves first (parked sessions: least recently parked within
    # a tier)
    priority: int = 0
    # absolute service deadline (monotonic_ns) from submit(deadline_ms=);
    # past it the request ends SHED_DEADLINE at the next tick head
    deadline_ns: Optional[int] = None
    rid: int = -1  # engine-unique id assigned by submit()
    t_submit_ns: int = 0
    t_depart_ns: int = 0  # left the waiting line (admitted)
    out: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    status: Optional[str] = None
    delivered: int = 0  # tokens put on the stream
    # log p(token) per decoded token when ServingConfig.logprobs is on (the
    # first token, sampled at admission, has none), appended before the
    # token is put on the stream
    logprobs: list = dataclasses.field(default_factory=list)
    _abort: Optional[str] = dataclasses.field(default=None, repr=False)
    _final_lock: Any = dataclasses.field(default_factory=threading.Lock, repr=False)

    @property
    def cancelled(self) -> bool:
        return self._abort is not None

    def cancel(self) -> None:
        """Abandon the request: the engine retires it at its next tick head."""
        if self._abort is None:
            self._abort = Status.CANCELLED

    def finish(self, status: str) -> bool:
        """Deliver the typed terminal exactly once (thread-safe)."""
        with self._final_lock:
            if self.status is not None:
                return False
            self.status = status
        self.out.put(Terminal(status))
        return True

    def stream(self):
        """Yield generated token ids until the terminal (see ``status``)."""
        while True:
            tok = self.out.get()
            if tok is None or isinstance(tok, Terminal):
                return
            yield tok


def batched_decode_step(params: Params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                        active: torch.Tensor, kv_bucket: int = 0, ffn_fn=None,
                        paged_attn=None, mesh=None):
    """One decode tick for the whole slot pool: each active slot writes its
    new KV at ITS OWN length (dense: (l, slot, len); paged: (l, table[slot,
    len // page], len % page)) and advances by one. Inactive slots compute
    but write nothing, and neither does a slot at the context wall: such a
    row is redirected (paged: to the null block 0, since a retired slot's
    stale table row may name blocks another slot now owns; dense: to its
    own position, clipped to the cache) and writes back what its target
    holds, so no plane changes (an int8 cache's scales included). Nothing
    here reads the device from the host, and every shape is static: the
    step can be captured in a CUDA graph. ``kv_bucket`` bounds the
    attention reads (0 = max_seq); ``paged_attn`` picks the paged read
    route; under ``mesh`` params and cache are the rank's shards (the
    table and lengths are whole, so the kept rows are the same on every
    rank). Updates the cache in place, the lengths included; returns
    (logits [B, vocab], cache)."""
    lens = cache["len"]
    keep = active & (lens < cfg.max_seq)
    pos = torch.clamp(lens, max=cfg.max_seq - 1).long()
    rows = torch.arange(lens.shape[0], device=lens.device)
    if "table" in cache:
        page = cache["k"].shape[2]
        blk = torch.where(keep, cache["table"][rows, pos // page].long(), 0)
        idx = (blk, pos % page)
    else:
        idx = (rows, pos)

    def write_kv(l, kv, k, v):
        store_kv(kv, l, idx, k[:, 0], v[:, 0], keep=keep)  # int8: values and scales
        return kv

    logits, new_kv = decode_layer_loop(params, cfg, cache, tokens, kv_bucket, write_kv,
                                       ffn_fn=ffn_fn, paged_attn=paged_attn, mesh=mesh)
    lens.add_(active.to(lens.dtype))
    return logits, {**new_kv, "len": lens}


def batched_spec_step(params: Params, cfg: ModelConfig, cache: dict, draft: torch.Tensor,
                      active: torch.Tensor, cap: torch.Tensor, kv_bucket: int = 0, ffn_fn=None,
                      paged_attn=None, mesh=None):
    """One speculative tick for the slot pool: verify a [B, T] draft chunk
    (column 0 is each slot's pending token, columns 1..T-1 the guessed
    continuation) through ``spec_verify_loop`` and accept greedily.

    Returns (pred [B, T] int32, count [B] int32, cache): ``pred[b,
    :count[b]]`` are the tokens slot b emits (the verified draft prefix is
    the model's own argmax there), ``count`` = leading matches + 1 (the
    first disagreeing argmax is the bonus token, so a tick never emits
    less than a plain one), capped by ``cap`` (the remaining budget) and 0
    on inactive rows. The length grows by count IN PLACE; rejected
    positions keep stale KV above it, overwritten by the next chunk before
    any query reads them.

    Dropped writes (inactive rows, positions at or past the context wall)
    write back what their target holds, as in ``batched_decode_step``, but
    a chunk writes T positions a row, and an ``index_put_`` whose indices
    repeat has no defined winner on CUDA: a dropped position must never
    share its target with a kept one. Dense: a dropped position goes to
    its row's position len - 1, below every kept write of the row (an
    active row holds its prompt, so len >= 1 whenever one of its positions
    is dropped). Paged: to the null block 0. A kept position past the
    slot's reservation maps, through the null-padded table row, to block 0
    as well, which no reader unmasks. The reference drops these writes
    with an out-of-range index instead.

    The paged read route is resolved at T = draft width: the kernel under
    auto for T <= 16, the gather route past it. Nothing here reads the
    device from the host: the step can be captured."""
    b, t = draft.shape
    lens = cache["len"]
    dev = draft.device
    pos = lens[:, None].long() + torch.arange(t, device=dev)[None, :]  # [B, T]
    keep = active[:, None] & (pos < cfg.max_seq)
    rows = torch.arange(b, device=dev)[:, None].expand(b, t)
    if "table" in cache:
        page = cache["k"].shape[2]
        table = cache["table"]
        blocks = torch.gather(table, 1, torch.clamp(pos // page, max=table.shape[1] - 1))
        idx = (torch.where(keep, blocks.long(), 0).reshape(-1), (pos % page).reshape(-1))
    else:
        drop = torch.clamp(lens.long() - 1, min=0)[:, None].expand(b, t)
        idx = (rows.reshape(-1), torch.where(keep, pos, drop).reshape(-1))
    flat_keep = keep.reshape(-1)

    def write_kv(l, kv, k, v):
        store_kv(kv, l, idx, k.reshape((b * t,) + k.shape[2:]),
                 v.reshape((b * t,) + v.shape[2:]), keep=flat_keep)
        return kv

    logits, new_kv = spec_verify_loop(params, cfg, cache, draft, kv_bucket, write_kv,
                                      ffn_fn=ffn_fn, paged_attn=paged_attn, mesh=mesh)
    pred = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, T]
    match = (draft[:, 1:] == pred[:, :-1]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1)  # leading matches
    count = torch.where(active, torch.minimum(accepted + 1, cap.long()), 0).to(torch.int32)
    lens.copy_(torch.clamp(lens + count, max=cfg.max_seq))
    return pred, count, {**new_kv, "len": lens}


def _scatter_prefill_pages(cache: dict, seq_cache: dict, logits: torch.Tensor,
                           slots: torch.Tensor, true_lens: torch.Tensor, s: int):
    """Install N freshly prefilled rows into a PAGED pool: the dense
    [L, N, s, H, Dh] KV reshapes to pages and scatters into each row's
    mapped blocks (the table rows the engine set at reservation). Pad pages
    past a short reservation land on the null block 0, which every reader
    masks. An int8 pool's [L, N, s, H] scales scatter beside its values.
    Under a tensor-parallel mesh both the rows and the pool are the rank's
    head shard, so the scatter is the same and needs no mesh. Returns
    (last-position logits [N, vocab], cache)."""
    page = cache["k"].shape[2]
    wp = s // page
    blk = cache["table"][slots, :wp].long()  # [N, Wp]
    n = slots.shape[0]
    for key in kv_keys(cache):
        pool = cache[key]
        pages = seq_cache[key][:, :, :s].reshape(
            (pool.shape[0], n, wp, page) + tuple(pool.shape[3:]))
        pool[:, blk] = pages
    cache["len"][slots] = true_lens.to(torch.int32)
    if logits.dim() == 2:
        return logits, cache
    return logits[torch.arange(n, device=logits.device), true_lens - 1], cache


def prefill_into_slot(params: Params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                      slot: int, true_len: int, prefill_fn=None, mesh=None):
    """Prefill one [1, bucket] right-padded prompt and install it in *slot*.
    Returns (first-token logits [vocab], cache)."""
    dev = tokens.device
    last, cache = prefill_into_slots(
        params, cfg, cache, tokens, torch.tensor([slot], device=dev),
        torch.tensor([true_len], device=dev), prefill_fn=prefill_fn, mesh=mesh)
    return last[0], cache


def prefill_into_slots(params: Params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                       slots: torch.Tensor, true_lens: torch.Tensor, prefill_fn=None,
                       mesh=None):
    """Batched admission: prefill N right-padded [N, bucket] prompts in one
    forward and scatter each row's KV into its own slot (distinct slots).
    Causality makes the right padding harmless. ``prefill_fn(params, cfg,
    tokens, mesh=mesh)`` (default ``prefill``) may return [N, S, vocab]
    logits or, gathering at the final positions, [N, vocab]. Returns
    (last-position logits [N, vocab], cache)."""
    logits, seq_cache = (prefill_fn or prefill)(params, cfg, tokens, mesh=mesh)
    s = tokens.shape[1]
    if "table" in cache:
        return _scatter_prefill_pages(cache, seq_cache, logits, slots, true_lens, s)
    for key in kv_keys(cache):
        cache[key][:, slots, :s] = seq_cache[key][:, :, :s]
    cache["len"][slots] = true_lens.to(torch.int32)
    if logits.dim() == 2:
        return logits, cache
    return logits[torch.arange(tokens.shape[0], device=logits.device), true_lens - 1], cache


def pad_to_chunks(tokens, n: int, c: int) -> torch.Tensor:
    """Right-pad an [n] prompt with zeros to a host [1, ceil(n/c)*c] int32
    chunk grid (the one padding contract every chunked path shares; pads
    above the true length are masked by the ragged reads and overwritten
    before use)."""
    out = torch.zeros((1, -(-n // c) * c), dtype=torch.int32)
    out[0, :n] = torch.as_tensor(np.asarray(tokens, dtype=np.int32)[:n])
    return out


def lookup_draft(history: list, k: int, max_ngram: int) -> Optional[list]:
    """Prompt-lookup drafting: continue the most recent earlier occurrence
    of the longest tail n-gram (<= max_ngram) of the history. Within one
    n, a match with a FULL k-token continuation beats a more recent match
    whose continuation runs off the end of the history (on a periodic
    stream the most recent occurrence sits flush against the suffix and
    would propose one real token plus zero padding). Returns k tokens
    (zero-padded when only a partial match exists) or None when nothing
    matches. A host scan per tick over Python ints."""
    for n in range(min(max_ngram, len(history) - 1), 0, -1):
        tail = history[-n:]
        partial = None
        for i in range(len(history) - n - 1, -1, -1):
            if history[i:i + n] == tail:
                cont = history[i + n:i + n + k]
                if len(cont) == k:
                    return cont
                if cont and partial is None:
                    partial = cont + [0] * (k - len(cont))
        if partial is not None:
            return partial
    return None


def chunked_prefill_into_slot(params: Params, cfg: ModelConfig, cache: dict,
                              chunk: torch.Tensor, slot: int, offset: int, new_len: int,
                              kv_bucket: int = 0, block_ids: Optional[torch.Tensor] = None,
                              ffn_fn=None, mesh=None):
    """One [1, C] prompt chunk written into *slot* at positions
    offset..offset+C-1, through THE decode trunk (``spec_verify_loop``) at
    T = C: a chunk is a verify pass whose draft is known-correct prompt. One
    chunk size serves any prompt length, and a C-token chunk bounds how
    long one admission dispatch holds the decode loop's live streams.

    The trunk runs on a single-row DENSE view ``[L, 1, bucket]`` with no
    page table, so its attention is the plain ragged-mask route and a chunk
    never reaches a paged kernel (those take T <= 16). ``kv_bucket`` (0 =
    max_seq) bounds the view and the reads; it must cover offset + C.
    - Dense cache: the view is the slot's own row ``cache[:, slot:slot+1,
      :bucket]``, so the chunk's KV lands in the cache in place.
    - Paged pool (``block_ids``, [Wp = bucket // page] block ids, padded
      with the null block 0): the window's pages are gathered into the
      view, the trunk writes there, and only the pages the chunk writes
      scatter back (a chunk's pool traffic is O(C)), so no page before the
      chunk, a shared prefix page among them, is ever rewritten while
      another stream reads it. Padding and junk pages land on the null
      block. Passing the blocks explicitly is
      what lets a prefix build prefill fresh blocks with no slot: ``slot``
      may then be the slot count, and the length write is dropped.
    An int8 cache quantizes the chunk's KV into its scale planes. Pads in
    the final chunk write junk KV above ``new_len``, masked by the length
    and overwritten before any query reads them. ``new_len`` is the slot's
    length after this chunk. ``ffn_fn`` is the family's post-attention
    block in the trunk (the MoE's ``moe_decode_ffn``; None: the dense
    MLP). Under ``mesh`` params and cache are the rank's shards, as in
    ``batched_decode_step``. Every write is in place. Returns (logits
    [1, C, vocab] f32, cache)."""
    c = chunk.shape[1]
    bucket = kv_bucket or cfg.max_seq
    if offset + c > bucket:
        raise ValueError(f"chunk [{offset}, {offset + c}) runs past its read window {bucket}")
    keys = kv_keys(cache)
    dev = chunk.device
    if block_ids is not None:
        page = cache["k"].shape[2]
        wp = bucket // page
        ids = torch.as_tensor(block_ids, device=dev).long()
        view = {key: cache[key][:, ids].reshape(
            (cache[key].shape[0], 1, wp * page) + tuple(cache[key].shape[3:])) for key in keys}
    else:
        view = {key: cache[key][:, slot:slot + 1, :bucket] for key in keys}
    view["len"] = torch.full((1,), offset, dtype=torch.int32, device=dev)

    def write_kv(l, kv, k, v):
        store_kv(kv, l, (slice(None), slice(offset, offset + c)), k, v)
        return kv

    logits, new_view = spec_verify_loop(params, cfg, view, chunk, bucket, write_kv,
                                        ffn_fn=ffn_fn, mesh=mesh)
    if block_ids is not None:
        p0, p1 = offset // page, min(-(-(offset + c) // page), wp)
        for key in keys:
            pool = cache[key]
            pages = new_view[key].reshape((pool.shape[0], wp, page) + tuple(pool.shape[3:]))
            pool[:, ids[p0:p1]] = pages[:, p0:p1]
    if slot < cache["len"].shape[0]:
        # a fill, not an item assignment: the host never waits for it
        cache["len"][slot].fill_(new_len)
    return logits, cache


class ServingEngine:
    """Continuous-batching loop: admit -> prefill -> joint decode -> stream.

    ``start()`` runs the loop on a background thread; ``submit()`` is
    thread-safe and returns a Request whose ``stream()`` yields tokens as
    they are produced. Each loop pass: drain submissions into the waiting
    line, admit same-bucket prompts in batches into free slots (paged pools
    reserve prompt + budget pages first; a dry pool is backpressure), run
    one decode tick for the whole pool over the smallest read window that
    covers the longest live sequence, fetch the sampled tokens (and any
    admission first tokens) in ONE device-to-host copy, deliver, retire.

    Which loop runs is ``pipeline_decode`` resolved as the reference
    resolves it: None (auto) runs the pipelined loop when sampling is on
    the device and no speculation is active, the synchronous loop with a
    custom ``sample=`` callable or with ``spec_tokens``; True the pipelined
    loop (a custom sampler or active speculation raises), False the
    synchronous loop. ``decode_loop_k`` runs the multi-tick loop, and with
    ``spec_tokens`` the fused one. On one CUDA card (no mesh) every
    device-sampled loop replays its steps from CUDA graphs captured when
    the engine is built, one per kv bucket (``decode_graphs`` and its
    siblings); under a mesh and on the CPU the steps run eagerly, a flush
    one decode or verify step an inner tick.
    ``sample(row)`` is
    called with one fetched numpy [vocab] f32 logits row (the first token's
    at admission, then each decode tick's) and returns the token id; it
    runs on the loop thread, and an exception in it faults that request
    alone.

    Chunked admission (``prefill_chunk``): a prompt past the largest bucket
    or the suffix of a prefixed request parks in its slot and advances one
    [1, C] chunk a loop pass, sharing ``prefill_budget`` with bucketed
    admission, so live streams decode between chunks. Its first token is
    sampled on the device from the last chunk's logits (or fetched at once
    on the serial path). ``register_prefix`` prefills a shared prompt once:
    a paged pool maps its full pages read-only into every prefixed slot and
    copies only the partial boundary page; a dense cache copies the
    prefix's KV into the slot.

    KV overcommit (``kv_swap``): ``park`` and ``resume`` are
    commands the loop applies at its tick heads (``_process_lifecycle``),
    a park once the slot has no token in flight. Admissions, resumes and
    prefix builds allocate through ``_alloc_reclaim``, which evicts parked
    sessions' private pages when the free list is dry. Everything the
    overcommit state holds (the parked entries, the host tier's free
    list, the swap-outs in flight) is the loop thread's, as the pool is.

    Tensor-parallel serving (``mesh``, a vtpu_torch.parallel.TpMesh) is a
    leader/worker split over torch.distributed, one process per rank.
    Rank 0 builds this engine (``params`` its shard, ``shard_params``) and
    is the leader: its threads, queues, allocator, sampling generators,
    admission buffer and logits exist on rank 0 only. Every other rank
    runs ``vtpu_torch.parallel.launch.serve_worker`` with its own shard, the
    same config and ServingConfig: the same adapter on its shard, following
    rank 0. Each adapter call of rank 0 (every step, a flush's and a fused
    flush's inner ticks one by one, chunks, the copy-on-write block, dense
    prefix buffers, the host tier's swaps) first broadcasts its op, the
    paged route it runs on, its shapes and its tensor arguments, and with
    them rank 0's current page table and lengths, so the engine's direct
    state writes outside any adapter call (a reservation's, a resume's or
    a handoff's ``state["table"][slot]`` and ``state["len"][slot]``) reach
    every rank before the step that reads them. Then every rank runs the
    same op on its head shard, with the all-reduces in the trunk. Sampling,
    drafting, admission, eviction, the watchdog's rungs and the prefill
    workers' claims are rank 0's: the other ranks receive their outcome.
    Over gloo that broadcast stages rank 0's device tensors through host
    memory, one device->host copy per call, which waits for the stream:
    the pipelined loops then overlap nothing (it is not counted as a
    fetch). ``stop()`` sends the workers their stop.

    Model families (``model=``, the reference's ``engine.py:1185``): pass
    either (params, cfg) for the dense transformer, or a slot-model adapter
    (serving/adapters.py: ``TransformerSlotModel``, ``MoeSlotModel``,
    ``SsmSlotModel``), whose params, config and device the engine takes. The
    adapter owns the paged pool and its read route: a ``ServingConfig``
    whose ``kv_page`` or ``paged_attn`` differs from the adapter's raises.
    Every engine path reads the context cap, the read windows and the KV
    layout from the adapter (``max_context`` None and
    ``supports_kv_buckets`` False for the SSM: no read windows, one graph a
    step). An adapter without ``spec_step`` serves without speculation
    (``stats()["spec_disabled_reason"]``), one without
    ``prefill_chunk_into_slot`` without chunked admission. The MoE serves
    under a mesh (its adapter built with it); the SSM on one device only:
    with ``mesh=`` it raises."""

    def __init__(self, params: Params = None, cfg: ModelConfig = None,
                 serving: ServingConfig = ServingConfig(), device=None, sample=None,
                 mesh=None, model=None):
        if model is not None:
            if mesh is not None and mesh is not model.mesh:
                if not isinstance(model, TransformerSlotModel):
                    raise NotImplementedError(
                        f"the {model.family} family ({type(model).__name__}) under a "
                        "tensor-parallel mesh= is not ported to vtpu_torch (the reference's "
                        "adapter takes no mesh); serve it on one device")
                raise ValueError("mesh= is not the adapter's mesh: build the adapter with it")
            mesh = model.mesh
            params, cfg = model.params, model.cfg
            # the device is where the adapter's params live
            own = params["embed"].device
            if device is not None and torch.device(device).type != own.type:
                raise ValueError(f"device {device} is not the adapter's device {own}")
            device = own
        _check_ported(cfg)
        if mesh is not None:
            if mesh.rank != 0:
                raise ValueError(
                    f"rank {mesh.rank} does not build a ServingEngine: rank 0 drives, "
                    "every other rank runs vtpu_torch.parallel.launch.serve_worker")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serving = serving
        self.mesh = mesh
        if model is None:
            model = TransformerSlotModel(
                params, cfg, kv_page=serving.kv_page, kv_pool_blocks=serving.kv_pool_blocks,
                paged_attn=serving.paged_attn, device=self.device, mesh=mesh)
        self.model = model
        self.params = model.params
        b = serving.slots
        # the adapter is the one source of the page size and the paged route
        self._page = model.kv_page
        if serving.kv_page is not None and self._page != serving.kv_page:
            raise ValueError(
                f"ServingConfig.kv_page={serving.kv_page} but the provided model adapter was "
                f"built with kv_page={self._page}; pass kv_page/kv_pool_blocks to the adapter "
                "(or just params+cfg)")
        self._paged = self._page is not None
        self._paged_attn = model.paged_attn
        if serving.paged_attn is not None and self._paged_attn != serving.paged_attn:
            raise ValueError(
                f"ServingConfig.paged_attn={serving.paged_attn!r} but the provided model "
                f"adapter was built with paged_attn={self._paged_attn!r}; pass paged_attn to "
                "the adapter (or just params+cfg)")
        if serving.kv_swap is not None and not self._paged:
            raise ValueError("kv_swap requires the paged pool (set kv_page): the dense "
                             "ring has no block granularity to evict or swap")
        self.state = self.model.init_state(b)
        # one sampling stream per slot (admission first tokens draw from the
        # admitted slot's stream too); greedy never touches them
        self._gens = [torch.Generator(device=self.device).manual_seed(
            serving.sampling_seed * 65537 + i) for i in range(b)]
        # a custom sampler keeps the reference's host path: the tick returns
        # [B, vocab] logits, fetched once, and the callable runs per row
        self.sample = sample
        self._device_sampling = sample is None
        if not self._device_sampling and serving.logprobs:
            raise ValueError("logprobs=True requires the device sampler; it is not "
                             "available with a custom sample= callable")
        self._logprobs = bool(serving.logprobs)
        # speculation verifies against argmax, so it is sound only under
        # greedy device sampling; a verify tick returns ids only, so
        # logprobs streaming forces plain ticks; a model without spec_step
        # cannot speculate. Requested but dropped: the reason is a stats()
        # gauge and a one-time trace event
        self._spec_tokens = (serving.spec_tokens
                             if sample is None and serving.temperature <= 0.0
                             and not serving.logprobs and hasattr(self.model, "spec_step")
                             else 0)
        self._spec_disabled_reason: Optional[str] = None
        if serving.spec_tokens and not self._spec_tokens:
            if sample is not None:
                self._spec_disabled_reason = (
                    "custom sample= callable (verification is greedy-only)")
            elif serving.temperature > 0.0:
                self._spec_disabled_reason = (
                    f"temperature={serving.temperature} (verification is greedy-only)")
            elif serving.logprobs:
                self._spec_disabled_reason = (
                    "logprobs streaming (verify ticks return ids only)")
            else:
                self._spec_disabled_reason = (
                    f"model adapter {type(self.model).__name__} has no spec_step")
        if self._device_sampling:
            self._decode_sampled = sampled_decode_step(
                self.model, serving.temperature, serving.top_k, serving.top_p,
                self._logprobs)
            self._decode = None
        else:
            self._decode_sampled = None
            self._decode = self.model.decode_step
        self._admit_step = batched_admission_step(
            self.model, serving.temperature, serving.top_k, serving.top_p)
        # the reference's resolution: pipelining needs device sampling and
        # no active speculation (a spec tick drafts from the host history,
        # so it must see the previous token before dispatching). Auto
        # (None) pipelines when it can, an explicit True that cannot be
        # honoured raises, False is synchronous
        pipeline = serving.pipeline_decode
        if pipeline and (not self._device_sampling or self._spec_tokens):
            raise ValueError("pipeline_decode=True requires device sampling (no custom "
                             "sample= callable) and no active speculation")
        self._pipeline = ((True if pipeline is None else bool(pipeline))
                          and self._device_sampling and not self._spec_tokens)
        # the multi-tick device loop: k ticks a dispatch, refused only with
        # a custom sampler (it needs host logits every tick); k = 1 is the
        # classic loop, bit-identical to None
        loop_k = serving.decode_loop_k
        if loop_k is not None and loop_k < 1:
            raise ValueError(f"decode_loop_k must be >= 1 (or None), got {loop_k}")
        if loop_k is not None and loop_k > 1 and not self._device_sampling:
            raise ValueError(
                f"decode_loop_k={loop_k} requires device sampling: a custom sample= callable "
                "consumes host logits every tick, the per-token host round trip the device "
                "loop removes; drop sample= or set decode_loop_k=None")
        self._loop_k = loop_k if loop_k is not None and loop_k > 1 else None
        self._decode_loop = (multi_tick_decode_step(
            self.model, serving.temperature, serving.top_k, serving.top_p, self._logprobs,
            self._loop_k, serving.eos_token) if self._loop_k else None)
        # both knobs: draft and verify fuse into the flush; while the
        # acceptance EMA cools off the plain flush (_decode_loop) runs
        self._fused_spec = bool(self._loop_k and self._spec_tokens)
        if serving.loop_policy is not None and not self._fused_spec:
            raise ValueError(
                "loop_policy requires the fused device loop (decode_loop_k > 1 AND active "
                "spec_tokens): the policy sizes the fused flush window; got "
                f"decode_loop_k={serving.decode_loop_k}, spec_tokens={serving.spec_tokens}"
                + (f" (speculation disabled: {self._spec_disabled_reason})"
                   if self._spec_disabled_reason else ""))
        # resolved here: a bad "module:attr" fails the constructor, not the loop
        self._loop_policy = (load_loop_policy(serving.loop_policy)
                             if serving.loop_policy is not None else None)
        # the fused draft window: the deepest n-gram match plus its continuation
        self._hist_window = (max(32, 2 * serving.spec_ngram + serving.spec_tokens + 2)
                             if self._fused_spec else 0)
        self._decode_fused = (fused_spec_decode_step(
            self.model, self._loop_k, self._spec_tokens, serving.eos_token,
            serving.spec_ngram) if self._fused_spec else None)
        # the host-drafted verify tick of the synchronous loop (a fused
        # engine verifies inside its flush)
        self._verify = (verify_step(self.model) if self._spec_tokens and not self._fused_spec
                        else None)
        ctx = model.max_context
        if self._spec_tokens and self._paged:
            # a forced kernel route cannot read a verify chunk past 16 queries
            paged_attn_route(self._paged_attn, ctx, self.device, self._spec_tokens + 1)
        # monotonic_ns of the last flush delivery: the floor of the next
        # flush's interpolated per-token stamps
        self._last_flush_ns = 0
        self._init_failure_domains(serving)
        # batched admission samples first tokens on the device: a custom
        # sampler admits serially, one blocking first-token fetch each, and
        # so does speculation (its draft history needs the first token on
        # the host)
        can_async = self._device_sampling and not self._spec_tokens
        if serving.async_admission and not can_async:
            raise ValueError("async_admission=True requires device sampling (no custom "
                             "sample= callable) and no active speculation")
        self._async_admission = (can_async if serving.async_admission is None
                                 else bool(serving.async_admission))
        self._admit_sizes = tuple(sorted(
            {n for n in serving.prefill_batch_sizes if 1 <= n <= b} | {1}))
        # [B] device buffer of admission first tokens not yet fed to a tick,
        # plus the host mask of which slots hold one
        self._admit_buf = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self._admit_mask = [False] * b
        # a model without a context cap (the SSM) has no read windows
        self._kv_buckets = (tuple(sorted({min(bkt, ctx) for bkt in serving.prefill_buckets}
                                         | {ctx})) if ctx else (0,))
        self._use_kv_buckets = (serving.kv_read_buckets is not False
                                and model.supports_kv_buckets)
        self._prefill_buckets = tuple(bkt for bkt in serving.prefill_buckets
                                      if ctx is None or bkt <= ctx)
        if not self._prefill_buckets:
            raise ValueError(f"no prefill bucket fits max_context={ctx}: "
                             f"{serving.prefill_buckets}")
        chunk = serving.prefill_chunk
        if chunk and not hasattr(model, "prefill_chunk_into_slot"):
            chunk = None  # a family without a chunkable trunk (the SSM)
        if chunk and ctx and ctx % chunk:
            # a final chunk straddling the context wall would run past the cache
            raise ValueError(f"prefill_chunk {chunk} must divide max_context {ctx}")
        self._chunk = chunk or None
        self._prefill_chunk = self.model.prefill_chunk_into_slot if self._chunk else None
        if serving.prefill_budget:
            # every admission unit must fit one tick's budget: a prompt of
            # the largest bucket, and a prefill chunk
            floor = max(max(self._prefill_buckets), self._chunk or 0)
            if serving.prefill_budget < floor:
                raise ValueError(
                    f"prefill_budget {serving.prefill_budget} is below the largest "
                    f"admission unit {floor} (largest bucket"
                    + (f" / prefill chunk {self._chunk}" if self._chunk else "") + ")")
        if self._paged:
            for bkt in self._prefill_buckets:
                if bkt % self._page:
                    raise ValueError(f"kv_page {self._page} must divide every "
                                     f"prefill bucket (got {bkt})")
            self._n_blocks = self.model.n_kv_blocks
            self._max_pages = ctx // self._page
            self._alloc = BlockAllocator(self._n_blocks)
        else:
            self._n_blocks = 0
            self._alloc = None
        self._check_disagg(serving)
        self._slot_blocks: list[list[int]] = [[] for _ in range(b)]
        # leading blocks of each slot's table row that are shared prefix
        # mappings (their refcounts are held elsewhere too)
        self._slot_shared = [0] * b
        # slots mid-chunked-admission: slot -> {req, padded, n, off, base};
        # the loop advances one chunk per slot a pass, between decode ticks
        self._admitting: dict[int, dict] = {}
        # rotating lead among admitting slots under a prefill budget
        self._adm_rr = 0
        # registered prefixes: id -> {len, pad, last_logits, and blocks
        # (paged) or buffers (dense)}; the lock makes a lookup and
        # its block share atomic against unregister_prefix
        self._prefixes: dict[int, dict] = {}
        self._prefix_lock = threading.Lock()
        self._next_prefix_id = 0
        # paged prefix builds write the pool, so they run on the loop
        # thread: register_prefix parks a work item here and waits
        self._prefix_work: "queue.Queue[dict]" = queue.Queue()
        self._init_swap_tier(serving)
        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._waiting = WaitQueue()
        self._slot_req: list[Optional[Request]] = [None] * b
        self._slot_budget = [0] * b
        self._tokens = [0] * b    # next token per slot (host side)
        self._slot_len = [0] * b  # host mirror of the device length
        # admission first tokens awaiting the next fetch: device token
        # arrays plus the (slot, request, row) they belong to
        self._pending_firsts: list[dict] = []
        self._stats = {
            "generated_tokens": 0, "decode_ticks": 0, "admissions": 0,
            # every loop device->host read goes through _collect: tick_fetches
            # carry a decode tick (admission first tokens ride along),
            # admission_fetches are an idle engine's first-token fetches
            "device_gets": 0, "bytes_fetched": 0,
            "tick_fetches": 0, "admission_fetches": 0,
            # blocking per-admission first-token fetches: the serial path's
            # (async_admission=False or a custom sampler), none when batched
            "admission_syncs": 0,
            "prefill_chunks": 0,
            # prefix reuse: hits are admissions that reused a registered
            # prefix (a paged share or a dense install), misses prefixed
            # requests whose prefix was unregistered before admission;
            # install copies are dense per-slot copies, shared blocks the
            # pool blocks mapped read-only, cow copies the boundary blocks
            "prefix_hits": 0, "prefix_misses": 0, "prefix_install_copies": 0,
            "prefix_blocks_shared": 0, "prefix_cow_copies": 0,
            "faulted_requests": 0,
            "prefill_batch_hist": [0] * (max(self._admit_sizes) + 1),
            # decode ticks dispatched while the previous tick was in flight
            "pipelined_ticks": 0,
            "kv_bucket_hist": {},
            "paged_attn_kernel_ticks": 0, "paged_attn_gather_ticks": 0,
            "pool_blocked_admissions": 0,
            # speculation: verify ticks (inner ticks on the fused loop), the
            # slot participations and tokens they delivered, and the
            # histogram of delivered tokens per (slot, verify tick)
            "spec_ticks": 0, "spec_slot_ticks": 0, "spec_emitted": 0,
            "spec_emitted_hist": [0] * (serving.spec_tokens + 2),
            # the multi-tick loop: flushes (decode_ticks counts their inner
            # ticks, k a flush) and slots that froze inside one (budget or
            # eos); fused flushes (cooloff fallbacks are the difference) and
            # the depth each ran, as a histogram index
            "loop_flushes": 0, "loop_early_exits": 0, "fused_flushes": 0,
            "fused_k_hist": [0] * ((self._loop_k or 0) + 1),
            # overcommit: parks and resumes; pool blocks reclaimed from
            # parked sessions; host-tier traffic; resumes whose pages had
            # left the pool (swap_faults) and, of those, the ones rebuilt
            # through prefill (fault_recomputes); tick heads where a resume
            # waited for the pool
            "parks": 0, "resumes": 0, "evicted_blocks": 0,
            "swap_out_bytes": 0, "swap_in_bytes": 0,
            "swap_faults": 0, "fault_recomputes": 0, "pool_blocked_resumes": 0,
            # the paged read window per dispatched slot, in inner ticks: the
            # pages each slot maps (live) against the pages the window spans
            # for it, and a histogram of a dispatch's live pages
            "read_pages_live": 0, "read_pages_window": 0, "read_pages_hist": {},
            # failure domains: typed sheds, and the fetch watchdog's rungs
            # applied and lifted
            "shed_deadline": 0, "shed_overload": 0,
            "watchdog_degrades": 0, "watchdog_recoveries": 0,
            # dead prefill workers the loop restarted (disagg)
            "worker_restarts": 0,
            # live migration (serving/migrate.py): sessions extracted and
            # installed, the payload bytes each way, device copies beyond
            # the staging D2H/H2D pair (the contract: 0), installs rebuilt
            # through prefill, and installs that ended FAULTED
            "migrations_out": 0, "migrations_in": 0,
            "migrate_out_bytes": 0, "migrate_in_bytes": 0,
            "migration_copies": 0, "migrate_recomputes": 0, "migrate_failures": 0,
        }
        # per-slot token history (prefix + prompt + delivered tokens): the
        # prompt-lookup drafts' source and what a park saves and a
        # recompute rebuilds; kept only while speculation or overcommit is on
        self._history: list[list[int]] = [[] for _ in range(b)]
        self._track_history = bool(self._spec_tokens or self._swap_enabled)
        # False where a slot's history lacks prefix tokens (the prefix was
        # unregistered before admission): such a session may swap, but is
        # never rebuilt from its history
        self._slot_hist_exact = [True] * b
        # slots with a dispatched tick or flush not yet delivered (the
        # pipelined loops): a park waits until its slot leaves this set
        self._inflight_slots: set = set()
        # the acceptance EMA starts a little above breakeven, so a losing
        # probe cools off within a few ticks
        self._spec_ema = self._spec_probe_ema()
        self._spec_cooloff = 0
        # host-side observability (vtpu_torch/obs): the request-lifecycle
        # ring with the ITL/TTFT/queue-wait reservoirs, and the tick-phase
        # profiler that attributes host_ms_per_tick. Nothing here can add a
        # device sync. _itl_last[slot]: when the slot's last token was
        # delivered (None until its first token, whose gap is TTFT)
        self.trace = RequestTrace(capacity=serving.trace_events)
        if self._spec_disabled_reason is not None:
            # one event (val: the requested draft length): the trace shows
            # why the configured speculation never ran
            self.trace.record("spec_disabled", -1, -1, serving.spec_tokens)
        self._prof = TickProfiler()
        self._itl_last: list[Optional[float]] = [None] * b
        self._host_ms_ema: Optional[float] = None
        self._admission_ms_ema: Optional[float] = None
        self._req_ctr = itertools.count()
        # drain: admission closes while the engine evacuates its sessions
        # to a peer (ServingEngine.drain); submit() then raises
        self._draining = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # an exception that ended the loop (its streams were ended CANCELLED)
        self.loop_error: Optional[BaseException] = None
        # the stream the loop thread dispatches on (a card; set when the loop
        # starts), which prefill workers order their writes after
        self._main_stream = None
        self._disagg = (DisaggRuntime(self, serving.disagg)
                        if serving.disagg is not None else None)
        # CUDA graphs of the steps this engine's loop dispatches (one card,
        # no mesh), every one captured here and none while serving: the
        # single tick (pipelined loop; the fallback tick of unfused
        # speculation), the k-tick flush (device loop; the cooloff flush of
        # fused speculation), the verify tick, and the fused flush at each
        # depth the LoopPolicy may pick (only decode_loop_k without one).
        # With the fetch watchdog on, also the one-token flush of its first
        # rung (loop1_graphs, and the fused flush at depth 1) and, where its
        # second rung applies, every set again on the gather route
        # (route_graphs["gather"]); a rung switches which set replays
        self.decode_graphs: Optional[DecodeGraphs] = None
        self.loop_graphs: Optional[DecodeGraphs] = None
        self.loop1_graphs: Optional[DecodeGraphs] = None
        self.spec_graphs: Optional[DecodeGraphs] = None
        self.fused_graphs: dict[int, DecodeGraphs] = {}
        self.route_graphs: dict = {}
        fused_ks = set((range(1, self._loop_k + 1) if self._loop_policy is not None
                        else (self._loop_k,)) if self._fused_spec else ())
        if self._fused_spec and self._watchdog:
            fused_ks.add(1)
        self._fused_ks = tuple(sorted(fused_ks))
        if self.device.type == "cuda":
            # build the kernels now, not at their first use inside the loop
            _build.build_all()
            if mesh is None:
                self._capture_graphs()
        self._select_steps()

    def _check_disagg(self, serving: ServingConfig) -> None:
        """What disaggregation needs, refused as the reference refuses it:
        a DisaggConfig, the paged pool (workers prefill into slot-less
        blocks), prefill_chunk (the explicit-block_ids chunk path), device
        sampling without speculation, and batched admission."""
        if serving.disagg is None:
            return
        if not isinstance(serving.disagg, DisaggConfig):
            raise ValueError("ServingConfig.disagg must be a DisaggConfig, got "
                             f"{type(serving.disagg).__name__}")
        if not self._paged:
            raise ValueError("disagg requires the paged pool (set kv_page): prefill workers "
                             "build KV into slot-less pool blocks")
        if not self._chunk:
            raise ValueError("disagg requires prefill_chunk: the worker prefills through the "
                             "explicit-block_ids chunked path")
        if not self._device_sampling or self._spec_tokens:
            raise ValueError("disagg requires device sampling (no custom sample= callable) "
                             "and no active speculation")
        if not self._async_admission:
            raise ValueError("disagg requires batched/async admission (the on-device "
                             "first-token samplers)")

    def _init_failure_domains(self, serving: ServingConfig) -> None:
        """Deadlines, overload shedding, the fault plan, the fetch
        watchdog's ladder and the duty supplier, each validated here (a bad
        policy string fails the constructor, not the loop). The ladder's
        rungs are those that apply to this engine's shape: ``loop_k1``
        (one-token flushes) where decode_loop_k > 1, ``paged_gather`` where
        the paged route is not already gather."""
        if serving.faults is not None and not isinstance(serving.faults, FaultPlan):
            raise ValueError("ServingConfig.faults must be a vtpu_torch.serving.faults."
                             f"FaultPlan, got {type(serving.faults).__name__}")
        self._faults = serving.faults
        if serving.shed_queue_depth < 0:
            raise ValueError(f"shed_queue_depth must be >= 0, got {serving.shed_queue_depth}")
        self._shed_policy = load_shed_policy(serving.shed_policy)
        self._shed_signals = accepts_signals(self._shed_policy)
        if serving.duty_supplier is not None and not callable(serving.duty_supplier):
            raise ValueError("ServingConfig.duty_supplier must be a zero-arg callable returning "
                             "a duty fraction (or None), got "
                             f"{type(serving.duty_supplier).__name__}")
        # one-way latch set by the first submit(deadline_ms=): a
        # deadline-free engine's tick head never scans for deadlines
        self._deadlines_seen = False
        self._watchdog = serving.fetch_watchdog_ms > 0
        self._loop_cap = self._loop_k  # 1 while rung loop_k1 holds
        self._degrade_rungs: list[str] = []
        if self._loop_k:
            self._degrade_rungs.append("loop_k1")
        if self._paged and self._paged_attn != "gather":
            self._degrade_rungs.append("paged_gather")
        self._degrade_level = 0
        # the rungs applied (lifted last first), the route to restore, and
        # the start of the current healthy-fetch streak (None: no streak)
        self._applied_rungs: list[str] = []
        self._paged_attn_orig = self._paged_attn
        self._healthy_since: Optional[float] = None
        # rung 1's one-token flush: the k-tick flush's body at k = 1, so its
        # token is the one a flush capped at 1 would deliver
        self._decode_loop1 = (multi_tick_decode_step(
            self.model, serving.temperature, serving.top_k, serving.top_p, self._logprobs, 1,
            serving.eos_token) if self._loop_k and self._watchdog else None)
        # the loop's heartbeat, stamped at every tick head (0 before the
        # first); _died: the engine_death seam fired and the loop thread
        # exited without its cleanup
        self._beat_ns = 0
        self._died = False

    def _init_swap_tier(self, serving: ServingConfig) -> None:
        """Overcommit state (``kv_swap``): the lifecycle queue of park and
        resume commands, the parked sessions in park order (the LRU axis),
        and the host tier: one preallocated plane per KV plane, scale
        planes included, [kv_swap, L, page, ...] block-major (each host
        block one contiguous run), pinned on a card, with its free list, and
        the side stream its swap-outs copy on (the adapter holds the
        tier: under a mesh every rank has one of its head shard). On a card
        with a host tier the staging pair runs once here (the null block to
        host block 0 and back), so no first use of its kernels or copies
        stalls the loop."""
        self._swap_enabled = serving.kv_swap is not None
        self._lifecycle_q: "queue.Queue[tuple[str, Request]]" = queue.Queue()
        self._want_park: set = set()
        # park commands whose request was nowhere for one pass: it may
        # still sit in _pending (one pass of grace)
        self._park_unseen: set = set()
        self._want_resume: list[Request] = []
        self._parked: "collections.OrderedDict[Request, dict]" = collections.OrderedDict()
        self._park_seq = 0
        self._swap_pending: list[dict] = []  # entries whose swap-out is in flight
        self._swap_stage = max(int(serving.kv_swap_stage_blocks), 1)
        self._swap_host_blocks = int(serving.kv_swap or 0)
        self._host_pool: dict[str, torch.Tensor] = {}
        self._copy_stream = None
        self._block_bytes = 0
        # the KV planes a block spans (scale planes included): what a swap
        # and a migration payload carry
        self._swap_planes = tuple(kv_keys(self.state)) if self._paged else ()
        if self._swap_enabled:
            pin = self.device.type == "cuda"
            for key in self._swap_planes:
                plane = self.state[key]
                self._block_bytes += plane[:, 0].numel() * plane.element_size()
            if self._swap_host_blocks:
                self._host_pool = self.model.init_host_tier(self.state, self._swap_host_blocks,
                                                            pin)
            if pin:
                self._copy_stream = torch.cuda.Stream(self.device)
                if self._swap_host_blocks:
                    torch.cuda.current_stream(self.device).wait_event(self._spill([0], [0]))
                    self._restore_pages([0], [0])
                    torch.cuda.synchronize(self.device)
        # popped from the end: host blocks go out in ascending runs
        self._host_free = list(range(self._swap_host_blocks - 1, -1, -1))

    def _capture_graphs(self) -> None:
        """Capture the graph set of the engine's paged route and, where the
        watchdog's second rung applies, the same set on the gather route
        (``route_graphs``, keyed by route override)."""
        self.route_graphs[self._paged_attn] = self._capture_set(self._paged_attn)
        if self._watchdog and "paged_gather" in self._degrade_rungs:
            self.route_graphs["gather"] = self._capture_set("gather")
        g = self.route_graphs[self._paged_attn]
        self.decode_graphs, self.loop_graphs = g["step"], g["flush"]
        self.loop1_graphs, self.spec_graphs = g["flush1"], g["spec"]
        self.fused_graphs = g["fused"]

    def _capture_set(self, route: Optional[str]) -> dict:
        """Capture every step the selected loop dispatches on the paged
        ``route``, one graph per kv bucket each. The steps read the route
        from the model when they run, so it is set there for the capture.
        The step's input tensors become the graphs' static buffers: tokens
        and the active mask, plus the caps of a flush, the [B, K+1] draft
        of a verify tick, the [B, W] draft window and its lengths of a
        fused flush."""
        b = self.serving.slots
        buckets = self._kv_buckets if self._use_kv_buckets else (0,)
        common = dict(paged_attn=route)
        row = ((b,), torch.int32)
        tick = (row, ((b,), torch.bool))
        sampled = self.serving.temperature > 0.0
        t = self._spec_tokens + 1
        g = {"step": None, "flush": None, "flush1": None, "spec": None, "fused": {}}
        kept, self.model.paged_attn = self.model.paged_attn, route
        try:
            if (self._pipeline and not self._loop_k) or self._verify is not None:
                g["step"] = DecodeGraphs(self._decode_sampled, self.params, self.state,
                                         self._gens, buckets, sampled=sampled, **common)
            for key, step in (("flush", self._decode_loop), ("flush1", self._decode_loop1)):
                if step is not None:
                    g[key] = DecodeGraphs(step, self.params, self.state, self._gens, buckets,
                                          sampled=sampled, inputs=tick + (row,), **common)
            if self._verify is not None:
                g["spec"] = DecodeGraphs(self._verify, self.params, self.state, self._gens,
                                         buckets, inputs=(((b, t), torch.int32),) + tick[1:]
                                         + (row,), t=t, **common)
            for k in self._fused_ks:
                g["fused"][k] = DecodeGraphs(
                    functools.partial(self._decode_fused, k_dyn=k), self.params, self.state,
                    self._gens, buckets, t=t,
                    inputs=tick + (row, ((b, self._hist_window), torch.int32), row), **common)
        finally:
            self.model.paged_attn = kept
        return g

    def _select_steps(self) -> None:
        """Point what each loop dispatches at the current paged route: a
        graph's replay on a card, the eager step elsewhere (which reads the
        route from the model). _step is the sampled tick (None on the
        host-sampler path, which calls _decode), _flush the k-tick flush,
        _flush1 rung 1's one-token flush, _spec the verify tick, _fused[k]
        the fused flush of depth k."""
        g = self.route_graphs.get(self._paged_attn) or {}
        fused = g.get("fused", {})
        self._step = g.get("step") or self._decode_sampled
        self._flush = g.get("flush") or self._decode_loop
        self._flush1 = g.get("flush1") or self._decode_loop1
        self._spec = g.get("spec") or self._verify
        self._fused = {k: fused.get(k) or functools.partial(self._decode_fused, k_dyn=k)
                       for k in self._fused_ks}

    def _graph_sets(self) -> list:
        """Every DecodeGraphs the engine captured, on every route."""
        return [dg for g in self.route_graphs.values()
                for dg in (g["step"], g["flush"], g["flush1"], g["spec"], *g["fused"].values())
                if dg is not None]

    # ------------------------------------------------------------------ API

    def register_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix ONCE and return its id; a submit
        with ``prefix=id`` passes only the suffix, which admits in chunks
        from the prefix's offset, so the prefix's prefill is paid at
        registration, not per request. Requires ``prefill_chunk``.

        Paged: the prefix chunk-prefills into fresh pool blocks, which
        admissions map read-only; the build writes the pool, so once the
        loop runs it runs there (this call waits for it), and before
        ``start()`` it runs here. Dense: the adapter builds it into a cache
        of its own and keeps the KV of its padded length, [L, ceil(n/C)*C,
        H, Dh] a plane (under a mesh on every rank, its head shard), which
        admissions copy into their slot."""
        if not self._chunk:
            raise ValueError("register_prefix requires prefill_chunk")
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n, c = int(tokens.shape[0]), self._chunk
        if n < 1 or n > self.model.max_context - c:
            # at least one suffix chunk must fit after the prefix
            raise ValueError(f"prefix length {n} leaves no room for a suffix")
        padded = pad_to_chunks(tokens, n, c)
        if self._paged:
            if self._thread is not None and self._thread.is_alive():
                item = {"padded": padded, "n": n, "done": threading.Event(),
                        "entry": None, "error": None}
                self._prefix_work.put(item)
                self._wake.set()
                while not item["done"].wait(0.1):
                    if self._stop.is_set() or not self._thread.is_alive():
                        # flagged first: a build still running releases its
                        # blocks itself; one that finished just now is
                        # released here
                        item["abandoned"] = True
                        if item["done"].is_set() and item["entry"] is not None:
                            self._alloc.release(item["entry"]["blocks"])
                            item["entry"] = None
                        raise RuntimeError("engine stopped during register_prefix")
                if item["error"] is not None:
                    raise item["error"]
                entry = item["entry"]
            else:
                entry = self._build_prefix_paged(padded, n)
        else:
            entry = self._build_prefix_dense(padded, n)
        with self._prefix_lock:
            pid = self._next_prefix_id
            self._next_prefix_id += 1
            self._prefixes[pid] = entry
        return pid

    def _build_prefix_paged(self, padded: torch.Tensor, n: int) -> dict:
        """Chunk-prefill a prefix into freshly allocated pool blocks (its
        one compute and write; admissions map them, never copy). Runs on
        the thread that owns the pool: the loop, or the caller before
        ``start()``. The slot count as the slot drops the length write."""
        pad = padded.shape[1]
        pages = -(-pad // self._page)
        # runs on the pool owner's thread, so it may evict parked sessions
        blocks = self._alloc_reclaim(pages)
        if blocks is None:
            # an admin op fails loudly rather than wait behind tenant traffic
            raise RuntimeError(f"kv pool exhausted: prefix needs {pages} blocks, "
                               f"{self._alloc.free_blocks} free")
        c = self._chunk
        try:
            for off in range(0, pad, c):
                kv_bucket = self._chunk_bucket(off + c)
                row = np.zeros((kv_bucket // self._page,), np.int32)
                m = min(len(blocks), row.shape[0])
                row[:m] = blocks[:m]
                logits, self.state = self._prefill_chunk(
                    self.params, self.state, self._upload(padded[:, off:off + c], torch.int32),
                    self.serving.slots, off, min(off + c, n), kv_bucket=kv_bucket,
                    block_ids=self._upload(row, torch.int32))
            last = logits[0, (n - 1) - (pad - c)]
        except Exception:
            self._alloc.release(blocks)  # no entry will ever reference them
            raise
        return {"blocks": blocks, "len": n, "pad": pad, "last_logits": last,
                "tokens": padded[0, :n].tolist()}

    def _build_prefix_dense(self, padded: torch.Tensor, n: int) -> dict:
        """The adapter chunk-prefills a prefix into a one-row cache of its
        own (never the serving state, so any thread may build) and keeps its
        padded length's KV under the entry's ``buf`` key."""
        c, pad = self._chunk, padded.shape[1]
        key, last = self.model.build_prefix(
            self.params, self.state, self._upload(padded, torch.int32), n, c,
            [self._chunk_bucket(off + c) for off in range(0, pad, c)])
        return {"buf": key, "len": n, "pad": pad, "last_logits": last,
                "tokens": padded[0, :n].tolist()}

    def _drain_prefix_work(self) -> None:
        """Run queued paged prefix builds on the loop thread, the pool's
        one writer. Each stalls live streams for its ceil(pad / C) chunks."""
        while True:
            try:
                item = self._prefix_work.get_nowait()
            except queue.Empty:
                return
            try:
                item["entry"] = self._build_prefix_paged(item["padded"], item["n"])
            except Exception as exc:  # raised on the registering caller's thread
                item["error"] = exc
            if item.get("abandoned") and item["entry"] is not None:
                self._alloc.release(item["entry"]["blocks"])
                item["entry"] = None
            item["done"].set()

    def unregister_prefix(self, pid: int) -> None:
        """Drop a registered prefix. Paged: the registry's hold on its
        blocks is released under the prefix lock (an admission's lookup and
        share run under it too); blocks mapped into live slots stay until
        those slots retire. A request submitted against ``pid`` but not yet
        admitted ends FAULTED; the loop keeps serving."""
        with self._prefix_lock:
            entry = self._prefixes.pop(pid, None)
            if entry is None:
                raise ValueError(f"unknown prefix id {pid}")
            if self._paged:
                self._alloc.release(entry["blocks"])
            else:
                self.model.drop_prefix(self.state, entry["buf"])

    def submit(self, tokens, max_new_tokens: int = 0, prefix: Optional[int] = None,
               priority: int = 0, deadline_ms: Optional[float] = None) -> Request:
        """Queue a prompt (with ``prefix``: the suffix after a registered
        prefix, possibly empty). ``priority`` is the request's QoS tier for
        overcommit eviction and overload shedding (``Request.priority``).
        ``deadline_ms`` bounds the request's whole service time from this
        call: past it the request is shed from the waiting line before
        admission, or aborted mid-stream at the next tick head, with a
        SHED_DEADLINE terminal (None: no deadline; 0 sheds at the first
        tick head). A prompt nothing can admit raises here, to its
        submitter."""
        if deadline_ms is not None and deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is stopped")
        if self._draining:
            # drain() closed admission: a new stream here would never be
            # served, so the submitter retargets it
            raise RuntimeError("ServingEngine is draining (admission closed); submit to the "
                               "drain destination instead")
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n = int(tokens.shape[0])
        if n == 0 and prefix is None:
            raise ValueError("empty prompt requires a prefix")
        budget = max_new_tokens or self.serving.max_new_tokens
        ctx = self.model.max_context
        if prefix is not None:
            entry = self._prefixes.get(prefix)
            if entry is None:
                raise ValueError(f"unknown prefix id {prefix}")
            end = entry["len"] + (-(-n // self._chunk) * self._chunk if n else 0)
            if end > ctx:
                raise ValueError(f"prefix {entry['len']} + padded suffix exceeds "
                                 f"max_context {ctx}")
        else:
            self._bucket(n)  # oversized prompts raise to the submitter
        if self._paged:
            # worst-case private pages: a request that could never admit
            # would block the head of the line forever
            base = pinned = 0
            if prefix is not None:
                base = entry["len"]
                # while it waits its prefix stays registered, so the
                # prefix's pages are never free for it
                pinned = -(-entry["pad"] // self._page)
            total = base + n
            need = -(-max(total + min(budget, max(ctx - total, 0)), 1) // self._page)
            need -= base // self._page
            if need > self._n_blocks - 1 - pinned:
                raise ValueError(
                    f"request needs {need} private KV blocks at worst case but the pool "
                    f"only has {self._n_blocks - 1}"
                    + (f" ({pinned} pinned by its prefix)" if pinned else "")
                    + "; raise kv_pool_blocks or lower max_new_tokens")
        req = Request(tokens=tokens, max_new_tokens=budget, prefix=prefix, priority=priority)
        req.rid = next(self._req_ctr)
        req.t_submit_ns = time.monotonic_ns()
        if deadline_ms is not None:
            req.deadline_ns = req.t_submit_ns + int(deadline_ms * 1e6)
            self._deadlines_seen = True
        self.trace.record("submit", req.rid, -1, n)
        self._pending.put(req)
        self._wake.set()
        if self._disagg is not None:
            # a waiting worker finds it once the next tick head drains it
            self._disagg.notify_work()
        if self._stop.is_set():
            # raced with stop(): an extra terminal is harmless, a missing one
            # hangs the client
            self._end_stream(req, Status.CANCELLED)
        return req

    def park(self, req: Request) -> None:
        """Take a live request out of the decode batch without ending its
        stream: the slot frees for other traffic and the session's pages
        stay in the pool until admission pressure evicts them (to the host
        tier, or dropped for a rebuild through prefill). Thread-safe and
        asynchronous: the loop parks the session at the first tick head
        where its slot has no token in flight (on the multi-tick loops, a
        flush boundary), so no stream token is lost or reordered. Parking a
        request still waiting for admission defers it (resume re-queues
        it); parking a finished or unknown request does nothing. Requires
        ``kv_swap``."""
        if not self._swap_enabled:
            raise ValueError("park() requires ServingConfig.kv_swap")
        self._lifecycle_q.put(("park", req))
        self._wake.set()

    def resume(self, req: Request) -> None:
        """Bring a parked request back into the decode batch: its pages are
        remapped (still in the pool), swapped in from the host tier, or
        rebuilt through prefill (dropped, or under
        ``kv_swap_recompute_tokens``), and its stream continues with the
        token after the last one delivered. Thread-safe; resuming a request
        that is not parked does nothing. Requires ``kv_swap``."""
        if not self._swap_enabled:
            raise ValueError("resume() requires ServingConfig.kv_swap")
        self._lifecycle_q.put(("resume", req))
        self._wake.set()

    def drain(self, dst: "ServingEngine", timeout: float = 120.0) -> dict:
        """Evacuate EVERY session this engine holds (live, parked, waiting,
        mid-admission) onto *dst* by live migration, so the engine can be
        redeployed without dropping a stream. Admission closes first
        (submit() raises for the rest of this engine's life); each session
        parks at its flush boundary, moves as a parked entry (one staged
        D2H and H2D, no other copy) and resumes on the destination at
        exactly its next token. Sessions the caller cancelled retire here
        with their typed terminal: drain never ends a stream. Returns the
        report ({"migrated", "completed", "faulted", "ms"}); raises
        MigrationError if the evacuation cannot finish inside *timeout*.
        Call it from a client thread, never from a token's delivery."""
        from vtpu_torch.serving.migrate import drain_engine

        return drain_engine(self, dst, timeout=timeout)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        if self._disagg is not None:
            # they wait for the loop to start before touching the device
            self._disagg.start()

    def stop(self) -> None:
        """End the loop (a pipelined tick still in flight is delivered
        first), end every stream, and under a mesh stop the workers (after
        the loop's last step, which holds the adapter)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                log.warning("serving loop still running 30s after stop; its "
                            "exit path will retire remaining requests")
        else:
            self._drain_all()
        self.model.stop_workers()

    @property
    def tick_profile(self) -> TickProfiler:
        """The tick-phase profiler (vtpu_torch/obs/tickprof): the per-phase
        histograms behind stats()['tick_phase_ms']."""
        return self._prof

    def stats(self) -> dict:
        s = dict(self._stats)
        s["prefill_batch_hist"] = list(s["prefill_batch_hist"])
        s["kv_bucket_hist"] = dict(s["kv_bucket_hist"])
        s["read_pages_hist"] = dict(s["read_pages_hist"])
        s["spec_emitted_hist"] = list(s["spec_emitted_hist"])
        s["fused_k_hist"] = list(s["fused_k_hist"])
        # acceptance per (slot, verify tick): delivered tokens over slot
        # participations, comparable with spec_min_mean
        s["mean_emitted_per_spec_tick"] = (round(s["spec_emitted"] / s["spec_slot_ticks"], 3)
                                           if s["spec_slot_ticks"] else None)
        s["spec_ema"] = round(self._spec_ema, 3)
        s["spec_cooling_off"] = self._spec_cooloff > 0
        s["spec_disabled_reason"] = self._spec_disabled_reason
        s["fused_spec"] = self._fused_spec
        s["loop_policy"] = (type(self._loop_policy).__name__
                            if self._loop_policy is not None else None)
        # a decode tick and a verify tick each count; a flush counts its
        # inner ticks, so one fetch a k-tick flush reads 1/k a tick
        ticks = s["decode_ticks"] + s["spec_ticks"]
        s["device_gets_per_tick"] = round(s["tick_fetches"] / ticks, 4) if ticks else None
        s["bytes_fetched_per_tick"] = round(s["bytes_fetched"] / ticks, 1) if ticks else None
        # host ms per tick (EMA of dispatch + delivery host work, one
        # sample a delivery) and per tick head (admission), as the
        # reference reports them; per token amortizes a delivery over the
        # k tokens a flush carries for a slot
        s["host_ms_per_tick"] = (round(self._host_ms_ema, 4)
                                 if self._host_ms_ema is not None else None)
        k_eff = self._loop_k or 1
        s["decode_loop_k"] = k_eff
        s["device_gets_per_token"] = s["device_gets_per_tick"]
        s["host_ms_per_token"] = (round(self._host_ms_ema / k_eff, 4)
                                  if self._host_ms_ema is not None else None)
        # CUDA graphs captured when the engine was built (none on the CPU
        # or under a mesh)
        s["graphs_captured"] = sum(len(g.keys()) for g in self._graph_sets())
        s["admission_stall_ms"] = (round(self._admission_ms_ema, 4)
                                   if self._admission_ms_ema is not None else None)
        # span telemetry is a view over the trace's reservoirs
        for samples, keys in (
                (self.trace.itl_gaps(), ((0.5, "itl_p50_ms"), (0.99, "itl_p99_ms"))),
                (self.trace.ttft_samples(), ((0.5, "ttft_p50_ms"), (0.95, "ttft_p95_ms"),
                                             (0.99, "ttft_p99_ms"))),
                (self.trace.queue_wait_samples(), ((0.5, "queue_wait_p50_ms"),
                                                   (0.99, "queue_wait_p99_ms"))),
                (self.trace.prefill_exec_samples(), ((0.5, "prefill_exec_p50_ms"),
                                                     (0.99, "prefill_exec_p99_ms")))):
            vals = sorted(samples)
            for q, key in keys:
                v = pct(vals, q)
                s[key] = round(v * 1e3, 3) if v is not None else None
        s["trace_enabled"] = self.trace.enabled
        s["trace_events_recorded"] = self.trace.events_recorded
        s["trace_events_dropped"] = self.trace.events_dropped
        s["trace_ring_capacity"] = self.trace.capacity if self.trace.enabled else 0
        s["trace_ring_utilization"] = (
            round(min(self.trace.events_recorded, self.trace.capacity) / self.trace.capacity, 4)
            if self.trace.enabled else None)
        # where host_ms_per_tick goes: admission head, dispatch, fetch,
        # deliver, and the tick head's polling of swap-outs (swap_drain)
        s["tick_phase_ms"] = self._prof.snapshot()
        s["device_sampling"] = self._device_sampling
        s["pipelined"] = self._pipeline
        s["batched_admission"] = self._async_admission
        s["active_slots"] = sum(r is not None for r in self._slot_req)
        s["admitting_slots"] = len(self._admitting)
        s["queued"] = self._pending.qsize() + len(self._waiting)
        s["registered_prefixes"] = len(self._prefixes)
        # pool blocks live slots map as shared prefix pages (a gauge from
        # the slots' own bookkeeping)
        s["prefix_shared_blocks"] = sum(self._slot_shared)
        s["paged"] = self._paged
        s["kv_page"] = self._page
        # under a mesh every rank holds n_heads / tp heads of the cache or
        # pool, so the bytes a card holds (what a per-card memory cap is
        # sized against) are the global bytes / tp; one device: the same
        tp = 1 if self.mesh is None else self.mesh.size
        s["tp"] = tp
        # a model without a KV cache (the SSM) has no KV bytes to count
        ctx = self.model.max_context
        bpt = kv_bytes_per_token(self.cfg) if ctx else None
        s["kv_hbm_bytes"] = {
            "dense": self.serving.slots * ctx * bpt // tp if ctx else None,
            "paged": self._n_blocks * self._page * bpt // tp if self._paged else None,
        }
        s["kv_hbm_bytes_per_chip"] = dict(s["kv_hbm_bytes"])
        # overcommit: the parked population and the host tier (blocks)
        s["kv_swap"] = self.serving.kv_swap if self._swap_enabled else None
        s["parked_sessions"] = len(self._parked)
        s["swap_host_blocks"] = self._swap_host_blocks if self._swap_enabled else None
        s["swap_host_free"] = len(self._host_free) if self._swap_enabled else None
        # live migration: whether admission is closed for a drain (the flow
        # counters ride the _stats copy above)
        s["draining"] = self._draining
        if self._paged:
            usable = self._n_blocks - 1
            free = self._alloc.free_blocks
            s["kv_pool_blocks"] = usable
            s["kv_pool_free"] = free
            s["kv_pool_used"] = usable - free
            s["kv_pool_occupancy"] = round((usable - free) / usable, 4) if usable else None
            # live pages over the pages the read windows spanned
            s["read_pages_ratio"] = (round(s["read_pages_live"] / s["read_pages_window"], 4)
                                     if s["read_pages_window"] else None)
            s["kv_pool_used_hwm"] = self._alloc.used_hwm
        else:
            s["kv_pool_blocks"] = s["kv_pool_free"] = None
            s["kv_pool_used"] = s["kv_pool_used_hwm"] = None
            s["kv_pool_occupancy"] = s["read_pages_ratio"] = None
        # disaggregation: the handoff counters (handoff_copies is the
        # zero-copy contract), the backlog and share the controller works
        # on, and the workers' flow counters merged into the engine's
        # totals so both modes read alike; worker fetches count as
        # admission fetches, never tick fetches
        rt = self._disagg
        s["disagg"] = rt is not None
        if rt is not None:
            rtc = rt.counters_snapshot()
            s["handoffs"] = rtc["handoffs"]
            s["handoff_copies"] = rtc["handoff_copies"]
            s["repartitions"] = rt.controller.repartitions
            s["prefill_backlog"] = rt.backlog()
            s["prefill_share_tokens"] = rt.controller.prefill_share
            s["generated_tokens"] += rtc["first_tokens"]
            s["admissions"] += rtc["worker_retired"]
            s["queued"] += rt.owned()
            s["prefill_chunks"] += rtc["prefill_chunks"]
            s["device_gets"] += rtc["fetches"]
            s["admission_fetches"] += rtc["fetches"]
            s["bytes_fetched"] += rtc["bytes_fetched"]
            s["prefix_blocks_shared"] += rtc["prefix_blocks_shared"]
            s["prefix_cow_copies"] += rtc["prefix_cow_copies"]
            s["pool_blocked_admissions"] += rtc["pool_blocked_prefills"]
            s["shed_deadline"] += rtc["shed_deadline"]
            s["faulted_requests"] += rtc["faulted_requests"]
        else:
            s["handoffs"] = s["handoff_copies"] = s["repartitions"] = s["prefill_backlog"] = 0
            s["prefill_share_tokens"] = None
        # failure domains: the FaultPlan's own injection count
        s["faults_injected"] = self._faults.injected_total if self._faults is not None else 0
        # process-wide kernel launch counts (the wrappers' counters; a graph
        # replay adds the launches its capture recorded)
        s["flash_launches"] = _build.LAUNCHES["flash_attention"]
        s["paged_attn_launches"] = _build.LAUNCHES["paged_decode_attention"]
        s["paged_attn_int8kv_launches"] = _build.LAUNCHES["paged_decode_attention_int8kv"]
        s["decode_attn_launches"] = _build.LAUNCHES["decode_attention"]
        s["decode_attn_int8kv_launches"] = _build.LAUNCHES["decode_attention_int8kv"]
        s["paged_attn_tp_launches"] = _build.LAUNCHES["paged_decode_attention_tp"]
        s["paged_attn_int8kv_tp_launches"] = _build.LAUNCHES["paged_decode_attention_int8kv_tp"]
        s["paged_attn_tp_verify_launches"] = _build.LAUNCHES["paged_decode_attention_tp_verify"]
        s["paged_attn_int8kv_tp_verify_launches"] = \
            _build.LAUNCHES["paged_decode_attention_int8kv_tp_verify"]
        return s

    def signals(self) -> EngineSignals:
        """The engine's pressure snapshot (serving/shed.py): what a
        ShedPolicy reads at an overload shed and a LoopPolicy at a fused
        flush head. Every field is one read of a counter or gauge; ``duty``
        is ``ServingConfig.duty_supplier``'s reading (None without one, and
        None, logged, when it raises); ``prefill_backlog`` is the prefill
        workers' backlog under disaggregation, the chunked admissions in
        flight otherwise; ``draining`` once drain() closed admission."""
        duty = None
        sup = self.serving.duty_supplier
        if sup is not None:
            try:
                duty = sup()
            except Exception:
                log.exception("duty_supplier raised; reporting duty=None")
        return EngineSignals(
            queue_depth=self._pending.qsize() + len(self._waiting),
            active_slots=sum(r is not None for r in self._slot_req),
            pool_free=self._alloc.free_blocks if self._paged else None,
            pool_used_hwm=self._alloc.used_hwm if self._paged else None,
            parked_sessions=len(self._parked),
            prefill_backlog=(self._disagg.backlog() if self._disagg is not None
                             else len(self._admitting)),
            now_ns=time.monotonic_ns(),
            pool_blocks=(self._n_blocks - 1) if self._paged else None,
            draining=self._draining,
            duty=duty,
            spec_mean_accepted=(round(self._spec_ema, 3) if self._spec_tokens else None))

    # ----------------------------------------------------------- lifecycle

    def _end_stream(self, req: Request, status: str, slot: int = -1) -> None:
        """Deliver *req*'s typed terminal exactly once, with one trace
        retire carrying the terminal code."""
        if req.finish(status):
            self.trace.record("retire", req.rid, slot, TERMINAL_CODES.get(status, 0))

    def _drain_all(self) -> None:
        """Terminal for everyone still holding a Request: occupied slots
        (CANCELLED — the engine abandoned them), admissions and rebuilds
        mid-chunk, parked sessions (whatever they hold goes back),
        waiters and submissions; a caller waiting in register_prefix gets
        an error. Handoffs never installed, and requests the prefill workers
        held or were to retry, end first."""
        if self._disagg is not None:
            self._disagg.drain()
        for slot in range(len(self._slot_req)):
            self._retire(slot, status=Status.CANCELLED)
        for slot, adm in list(self._admitting.items()):
            self._end_stream(adm["req"], adm["req"]._abort or Status.CANCELLED, slot)
            self._free_slot_blocks(slot)
        self._admitting.clear()
        for req in list(self._parked):
            self._release_parked(self._parked.pop(req))
            self._end_stream(req, req._abort or Status.CANCELLED)
        self._want_park.clear()
        self._park_unseen.clear()
        self._want_resume.clear()
        while True:
            try:
                item = self._prefix_work.get_nowait()
            except queue.Empty:
                break
            item["error"] = RuntimeError("engine stopped")
            item["done"].set()
        for req in self._waiting:
            self._end_stream(req, req._abort or Status.CANCELLED)
        self._waiting.clear()
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            self._end_stream(req, req._abort or Status.CANCELLED)
        # unserved lifecycle commands die with the engine, but a migrate
        # ticket has a caller blocked on it: fail it, so migrate() and
        # drain() see the stop instead of waiting out their timeout
        while True:
            try:
                kind, item = self._lifecycle_q.get_nowait()
            except queue.Empty:
                break
            if kind in ("migrate_out", "migrate_in"):
                item.fail(RuntimeError("engine stopped mid-migration"))

    def _retire(self, slot: int, status: Optional[str] = None) -> None:
        req = self._slot_req[slot]
        if req is not None:
            self._end_stream(req, status or req._abort or Status.OK, slot)
        self._slot_req[slot] = None
        self._slot_budget[slot] = 0
        self._slot_len[slot] = 0
        self._itl_last[slot] = None
        self._admit_mask[slot] = False
        self._history[slot] = []
        self._slot_hist_exact[slot] = True
        # the device table row stays stale: inactive reads are masked and
        # writes are dropped, and the next reservation overwrites it
        self._free_slot_blocks(slot)

    def _free_slot_blocks(self, slot: int) -> None:
        """Drop the slot's mappings (shared prefix blocks free only when the
        registry and every other slot have let go too)."""
        if self._paged and self._slot_blocks[slot]:
            self._alloc.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self._slot_shared[slot] = 0

    def _contain_fault(self, slot: int) -> None:
        """An exception escaped ONE request's path (a custom sampler, a
        delivery): retire that slot FAULTED and release what it held; the
        loop and every other stream go on."""
        req = self._slot_req[slot]
        self._stats["faulted_requests"] += 1
        if req is not None:
            self.trace.record("fault", req.rid, slot)
        log.exception("request %s faulted in slot %d; containing",
                      getattr(req, "rid", None), slot)
        self._retire(slot, status=Status.FAULTED)

    # ------------------------------------------------------ failure domains

    def _fire_fault(self, seam: str):
        """The configured FaultPlan's answer at ``seam``: the FaultSpec to
        inject (truthy) or None; one attribute check without a plan."""
        plan = self._faults
        if plan is None:
            return None
        return plan.fire(seam)

    def _maybe_inject_dispatch(self) -> None:
        """The dispatch_exc seam, first thing in one slot's delivery: the
        raise takes the containment path an organic bug would."""
        if self._fire_fault("dispatch_exc"):
            raise FaultInjected("injected dispatch_exc")

    def _trip_watchdog(self, stalled_s: float) -> None:
        """A fetch waited past fetch_watchdog_ms: apply the next rung of
        the ladder. ``loop_k1`` makes every flush a one-token flush (the
        host sees each token again); ``paged_gather`` moves every dispatch
        to the gather route (on a card, to the gather graphs captured when
        the engine was built: nothing is captured while serving). Both
        deliver the same tokens. An exhausted ladder logs and goes on."""
        if not self._degrade_rungs:
            log.warning("fetch watchdog: fetch stalled %.0f ms with the degradation ladder "
                        "exhausted", stalled_s * 1e3)
            return
        rung = self._degrade_rungs.pop(0)
        self._applied_rungs.append(rung)
        self._healthy_since = None  # a stall ends a recovery streak
        self._degrade_level += 1
        self._stats["watchdog_degrades"] += 1
        self.trace.record("degrade", -1, -1, self._degrade_level)
        if rung == "loop_k1":
            self._loop_cap = 1
            log.warning("fetch watchdog: fetch stalled %.0f ms; degrading decode_loop_k=%d to "
                        "one-token flushes", stalled_s * 1e3, self._loop_k)
        else:
            self._set_route("gather")
            log.warning("fetch watchdog: fetch stalled %.0f ms; degrading paged_attn to the "
                        "gather route", stalled_s * 1e3)

    def _recover_watchdog(self) -> None:
        """Lift ONE rung after fetches stayed under the threshold for
        fetch_watchdog_recover_ms, the last applied first; it goes back to
        the head of the ladder, so a relapse trips it again first."""
        if not self._applied_rungs:
            return
        rung = self._applied_rungs.pop()
        self._degrade_rungs.insert(0, rung)
        self._degrade_level -= 1
        self._stats["watchdog_recoveries"] += 1
        self.trace.record("recover", -1, -1, self._degrade_level)
        if rung == "loop_k1":
            self._loop_cap = self._loop_k
            log.warning("fetch watchdog: latency recovered; restoring decode_loop_k=%d flushes",
                        self._loop_k)
        else:
            self._set_route(self._paged_attn_orig)
            log.warning("fetch watchdog: latency recovered; restoring paged_attn=%r",
                        self._paged_attn_orig)

    def _set_route(self, route: Optional[str]) -> None:
        """Switch the paged read route of every later dispatch: the model's
        override (what an eager step reads) and the graph set replayed."""
        self._paged_attn = route
        self.model.paged_attn = route
        self._select_steps()

    # ---------------------------------------------------------- overcommit

    def _alloc_reclaim(self, n: int, exclude: Optional[Request] = None) -> Optional[list[int]]:
        """``BlockAllocator.alloc`` under overcommit: when the free list
        cannot cover ``n`` but the free and the reclaimable blocks (parked
        sessions' evictable private pages) together can, evict until it
        fits and allocate. ``exclude`` keeps a resuming entry from evicting
        itself. The blocks, or None with nothing reserved. The
        alloc_exhaust seam reports a dry free list here, so the caller's
        backpressure runs as under a full pool."""
        if self._fire_fault("alloc_exhaust"):
            return None
        got = self._alloc.alloc(n)
        if got is not None or not self._swap_enabled:
            return got
        if self._alloc.free_blocks + self._reclaimable(exclude) < n:
            return None
        self._reclaim(n, exclude)
        return self._alloc.alloc(n)

    def _reclaimable(self, exclude: Optional[Request] = None) -> int:
        return sum(len(e["priv"]) for r, e in self._parked.items()
                   if r is not exclude and e["priv"] and self._evictable(e))

    def _evictable(self, e: dict) -> bool:
        """Can a parked entry's private pages leave the pool: the host
        tier has room for them, or the sequence can be rebuilt through
        prefill. Shared prefix blocks never leave: their refcounts pin
        them."""
        return len(e["priv"]) <= len(self._host_free) or e["recompute_ok"]

    def _reclaim(self, need: int, exclude: Optional[Request] = None) -> None:
        """Evict parked sessions until the free list covers ``need`` blocks
        or nothing evictable is left: lowest ``Request.priority`` first,
        least recently parked within a priority."""
        order = sorted((r for r, e in self._parked.items()
                        if r is not exclude and e["priv"] and self._evictable(e)),
                       key=lambda r: (self._parked[r]["priority"], self._parked[r]["seq"]))
        for req in order:
            if self._alloc.free_blocks >= need:
                return
            e = self._parked[req]
            if self._evictable(e):  # earlier spills may have filled the host tier
                self._evict_entry(e)

    def _evict_entry(self, e: dict) -> None:
        """Reclaim one parked session's private pages. With room in the
        host tier they spill (``_spill``: nothing waits) and the pool
        blocks are released at once: the snapshot, not the pool, feeds the
        host copy, so an admission may overwrite the blocks this very tick.
        Without room they are dropped, and resume rebuilds them (the
        ``_evictable`` gate made sure it can); an entry that can do neither
        stays resident. The swap_d2h_loss seam loses the spill of an entry
        that can be rebuilt: its pages drop (one that cannot ignores it)."""
        priv = e["priv"]
        m = len(priv)
        d2h_lost = e["recompute_ok"] and self._fire_fault("swap_d2h_loss") is not None
        if not d2h_lost and self._swap_host_blocks and m <= len(self._host_free):
            e["host"] = [self._host_free.pop() for _ in range(m)]
            e["pend"] = self._spill(priv, e["host"])
            self._swap_pending.append(e)
            self._stats["swap_out_bytes"] += m * self._block_bytes
        elif e["recompute_ok"]:
            e["dropped"] = True
        else:
            return
        self._stats["evicted_blocks"] += m
        self.trace.record("evict", e["req"].rid, -1, m)
        if e["host"] is not None:
            self.trace.record("swap_out", e["req"].rid, -1, m * self._block_bytes)
        self._alloc.release(priv)
        e["priv"] = []

    def _spill(self, blocks: list[int], host: list[int]) -> Optional[torch.cuda.Event]:
        """Enqueue the swap-out of pool ``blocks`` into host-tier blocks
        ``host`` (same order): the adapter's staging gathers run on the main
        stream, up to ``kv_swap_stage_blocks`` blocks each (under a mesh
        every other rank gathers and copies its own shard), and the copies
        of their snapshots into the pinned host tier on the side stream
        behind them, non-blocking, one copy a plane for each run of
        consecutive host blocks. Returns the event that marks the copies
        done (None on the CPU, where they have run). The side stream holds
        each snapshot (``record_stream``) until its copy has read it."""
        w = self._swap_stage
        snaps = self.model.swap_out(self.state, blocks, host, w)
        cs = self._copy_stream
        if cs is None:
            for i, snap in snaps:
                to_host(self._host_pool, snap, host[i:i + w], non_blocking=False)
            return None
        cs.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(cs):
            for i, snap in snaps:
                to_host(self._host_pool, snap, host[i:i + w], non_blocking=True)
                for x in snap.values():
                    x.record_stream(cs)
            done = torch.cuda.Event()
            done.record(cs)
        return done

    def _drain_swap_outs(self) -> None:
        """Retire the swap-outs whose copies are done (an event query, never
        a wait: the tick path does not block on a swap). A resume that
        needs its pages first orders its swap-in behind their event
        (``_finalize_swap_out``)."""
        for e in list(self._swap_pending):
            if e["pend"] is None or e["pend"].query():
                self._finalize_swap_out(e)

    def _finalize_swap_out(self, e: dict) -> None:
        """Land an entry's swap-out: the host tier holds its pages once the
        event has completed. A swap-in racing its own swap-out makes the
        main stream wait for the event (a device-side wait: the host goes
        on)."""
        if e["pend"] is not None and not e["pend"].query():
            torch.cuda.current_stream(self.device).wait_event(e["pend"])
        e["pend"] = None
        self._swap_pending.remove(e)

    def _release_parked(self, e: dict) -> None:
        """Return everything a parked entry holds: its prefix shares, its
        private blocks still in the pool, its host blocks and a swap-out in
        flight. A host block freed under a copy in flight is next written
        by a later swap-out on the same side stream, after it."""
        if e in self._swap_pending:
            e["pend"] = None
            self._swap_pending.remove(e)
        if e["shared"]:
            self._alloc.release(e["shared"])
            e["shared"] = []
        if e["priv"]:
            self._alloc.release(e["priv"])
            e["priv"] = []
        if e["host"] is not None:
            self._host_free.extend(e["host"])
            e["host"] = None

    def _can_recompute(self, seq_len: int) -> bool:
        """Rebuildable through prefill: a bucket covers the sequence, or
        chunked prefill is configured (any length up to the context)."""
        return any(bkt >= seq_len for bkt in self._prefill_buckets) or self._chunk is not None

    def _parkable(self, slot: int) -> bool:
        """A slot parks once a token has been delivered for it (its history
        holds the cache contents plus exactly the one delivered token whose
        KV is not yet written) and none is in flight for it (the pipelined
        loops exclude it from dispatch until then)."""
        return (slot not in self._inflight_slots
                and len(self._history[slot]) == self._slot_len[slot] + 1)

    def _do_park(self, slot: int) -> None:
        """Move a settled slot's session into a parked entry. Its pending
        token is the last DELIVERED one, from the host's history: on the
        pipelined loops the next input may sit on the device, and nothing
        here reads the device. The entry takes over the slot's blocks; the
        slot's table row goes stale as a retire's does (its reads are
        masked, its writes go to the null block)."""
        req = self._slot_req[slot]
        nshared = self._slot_shared[slot]
        blocks = self._slot_blocks[slot]
        n = self._slot_len[slot]
        exact = self._slot_hist_exact[slot]
        self._parked[req] = {
            "req": req, "tokens": list(self._history[slot][:-1]),
            "pending": self._history[slot][-1], "budget": self._slot_budget[slot],
            "seq_len": n, "n_pages": len(blocks),
            "shared": blocks[:nshared],  # refcount holds kept while parked
            "priv": blocks[nshared:],    # this session's own KV: evictable
            "host": None, "pend": None, "dropped": False,
            "recompute_ok": self._can_recompute(n) and exact, "hist_exact": exact,
            "priority": req.priority, "seq": self._park_seq}
        self._park_seq += 1
        self._slot_req[slot] = None
        self._slot_budget[slot] = 0
        self._slot_len[slot] = 0
        self._slot_blocks[slot] = []
        self._slot_shared[slot] = 0
        self._history[slot] = []
        self._slot_hist_exact[slot] = True
        self._itl_last[slot] = None
        self._admit_mask[slot] = False
        self._stats["parks"] += 1
        self.trace.record("park", req.rid, slot, len(blocks))

    def _process_lifecycle(self) -> None:
        """Take the park and resume commands of client threads and the
        migrate tickets, apply the parks whose slots have settled, and
        release cancelled parked sessions (everything they hold goes back,
        as a live slot's cancel does)."""
        while True:
            try:
                kind, req = self._lifecycle_q.get_nowait()
            except queue.Empty:
                break
            if kind in ("migrate_out", "migrate_in"):
                # a live migration's extract or install (serving/migrate.py),
                # served here on the loop thread, the owner of the parked
                # set, the allocator and the state; ``req`` is the ticket,
                # and the handler answers it without raising
                from vtpu_torch.serving.migrate import handle_migrate_command

                handle_migrate_command(self, kind, req)
                continue
            if kind == "park":
                if req in self._parked and req in self._want_resume:
                    # a park overtook a queued resume: the session stays parked
                    self._want_resume.remove(req)
                else:
                    self._want_park.add(req)
            elif req in self._want_park:
                # a resume overtook a park that never settled: both cancel
                self._want_park.discard(req)
            elif req in self._parked and req not in self._want_resume:
                # the resume-latency span starts here
                self.trace.record("resume", req.rid)
                self._want_resume.append(req)
        for req in list(self._want_park):
            if req.cancelled or req in self._parked:
                self._want_park.discard(req)
                self._park_unseen.discard(req)
                continue
            if self._waiting.take(req):
                # not admitted yet: parked unstarted, with no pages; resume
                # puts it back in the waiting line
                self._park_unseen.discard(req)
                self._want_park.discard(req)
                self._parked[req] = {
                    "req": req, "unstarted": True, "tokens": [], "pending": None,
                    "budget": 0, "seq_len": 0, "n_pages": 0, "shared": [], "priv": [],
                    "host": None, "pend": None, "dropped": False, "recompute_ok": True,
                    "hist_exact": True, "priority": req.priority, "seq": self._park_seq}
                self._park_seq += 1
                self._stats["parks"] += 1
                self.trace.record("park", req.rid)
                continue
            try:
                slot = self._slot_req.index(req)
            except ValueError:
                # mid-chunked-admission: it parks once admitted. Nowhere at
                # all: its submit may still sit in _pending (put there after
                # this pass drained it), so the command is dropped only on
                # the second pass in a row that finds it nowhere. A request a
                # prefill worker holds, or a handoff awaiting a slot, parks
                # once it reaches a slot, as a chunked admission does
                if self._disagg is not None and self._disagg.owns(req):
                    self._park_unseen.discard(req)
                elif not any(adm["req"] is req for adm in self._admitting.values()):
                    if req in self._park_unseen:
                        self._want_park.discard(req)
                        self._park_unseen.discard(req)
                    else:
                        self._park_unseen.add(req)
                continue
            self._park_unseen.discard(req)
            if self._parkable(slot):
                self._want_park.discard(req)
                self._do_park(slot)
        for req in [r for r in self._parked if r.cancelled]:
            self._release_parked(self._parked.pop(req))
            self._end_stream(req, req._abort or Status.CANCELLED)

    def _advance_resumes(self, budget: float) -> float:
        """Bring resumed sessions back into free slots, in resume order and
        ahead of new admissions (older traffic). Pages still in the pool
        remap; dropped pages, or a sequence under the recompute crossover,
        rebuild through prefill (a bucketed rebuild spends its bucket from
        the tick's prompt budget as an admission would; a longer one rides
        the chunked admissions); swapped pages come back from the host
        tier. No free slot, a dry pool or a spent budget leaves the entry
        queued for the next tick head. Returns the remaining budget."""
        while self._want_resume:
            req = self._want_resume[0]
            e = self._parked.get(req)
            if e is None or req.cancelled:
                # the parked sweep releases a cancelled session
                self._want_resume.pop(0)
                continue
            if e.get("unstarted"):
                self._want_resume.pop(0)
                del self._parked[req]
                self._waiting.append(req)
                self._stats["resumes"] += 1
                continue
            slot = next((i for i in range(self.serving.slots)
                         if self._slot_req[i] is None and i not in self._admitting), None)
            if slot is None:
                break
            if e["priv"]:
                # still in the pool: a table-row remap beats both restores
                # (and a rebuild here would strand the resident blocks)
                self._finish_resume_slot(slot, e)
            elif e["dropped"] or (e["seq_len"] <= self.serving.kv_swap_recompute_tokens
                                  and e["recompute_ok"]):
                bkt = next((b for b in self._prefill_buckets if b >= e["seq_len"]), None)
                if bkt is not None and bkt > budget:
                    break
                if not self._begin_recompute(slot, e):
                    break
                if bkt is not None:
                    budget -= bkt
            elif not self._swap_in(slot, e):
                break
            self._want_resume.pop(0)
        return budget

    def _swap_in(self, slot: int, e: dict) -> bool:
        """Restore a swapped session: allocate its private blocks (evicting
        others if the free list is dry, never itself), bring its pages back
        (``_restore_pages``), then remap the slot. The host blocks go back
        to the free list at once: the next write to them is a swap-out on
        the side stream, which waits for the main stream first. The
        swap_h2d_loss seam loses the restore of an entry that can be
        rebuilt: it drops its host pages and rebuilds through prefill (one
        that cannot ignores it)."""
        if e["recompute_ok"] and self._fire_fault("swap_h2d_loss"):
            e["dropped"] = True
            return self._begin_recompute(slot, e)
        need = e["n_pages"] - len(e["shared"])
        priv = self._alloc_reclaim(need, exclude=e["req"])
        if priv is None:
            self._stats["pool_blocked_resumes"] += 1
            return False
        if e in self._swap_pending:
            self._finalize_swap_out(e)  # rare: the resume raced its own swap-out
        self._restore_pages(priv, e["host"])
        self._host_free.extend(e["host"])
        e["host"] = None
        e["priv"] = priv
        self._stats["swap_in_bytes"] += need * self._block_bytes
        self._stats["swap_faults"] += 1
        self.trace.record("swap_in", e["req"].rid, slot, need * self._block_bytes)
        self._finish_resume_slot(slot, e)
        return True

    def _restore_pages(self, blocks: list[int], host: list[int]) -> None:
        """Enqueue the swap-in of host-tier blocks ``host`` into pool
        ``blocks`` (same order) on the main stream, ahead of the tick that
        reads them (the adapter's ``swap_in``, on every rank under a mesh:
        up to ``kv_swap_stage_blocks`` blocks at a time, staged and
        scattered into the pool in place)."""
        self.state = self.model.swap_in(self.state, blocks, host, self._swap_stage)

    def _set_row(self, slot: int, blocks: list[int], length: int) -> None:
        """The slot's device table row and length, in place."""
        row = np.zeros((self._max_pages,), np.int32)
        row[:len(blocks)] = blocks
        self.state["table"][slot].copy_(self._upload(row, torch.int32))
        self.state["len"][slot].fill_(length)

    def _finish_resume_slot(self, slot: int, e: dict) -> None:
        """Remap a restored entry's table row and put the session back in
        the slot: the next tick feeds its pending token as if it had never
        parked."""
        blocks = e["shared"] + e["priv"]
        self._slot_blocks[slot] = blocks
        self._slot_shared[slot] = len(e["shared"])
        e["shared"], e["priv"] = [], []
        self._set_row(slot, blocks, e["seq_len"])
        self._restore_slot(slot, e)

    def _restore_slot(self, slot: int, e: dict) -> None:
        """Slot bookkeeping of a restored session (a parked entry, or a
        chunked rebuild's ``resume`` record). Its pending token goes up
        from the host at the next dispatch: the slot is not fed from a
        tick in flight."""
        req = e["req"]
        self._slot_req[slot] = req
        self._slot_budget[slot] = e["budget"]
        self._tokens[slot] = e["pending"]
        self._slot_len[slot] = e["seq_len"]
        self._history[slot] = list(e["tokens"]) + [e["pending"]]
        self._slot_hist_exact[slot] = e.get("hist_exact", True)
        self._itl_last[slot] = None  # the resume gap is no ITL sample
        self._admit_mask[slot] = False
        if req in self._parked:
            del self._parked[req]
            self._stats["resumes"] += 1

    def _begin_recompute(self, slot: int, e: dict) -> bool:
        """Rebuild a dropped (or crossover-short) session's KV through
        prefill. The whole sequence goes private: prefix shares are
        released and their positions recomputed with the rest. A sequence a
        bucket covers takes one [1, bucket] prefill dispatch (its logits
        are discarded: the pending token is on the host already, so no
        first-token buffer or mask is touched); a longer one rides the
        chunked admissions, one chunk a loop pass under the prompt budget,
        and its final chunk restores the slot."""
        req = e["req"]
        n = e["seq_len"]
        need = e["n_pages"]
        priv = self._alloc_reclaim(need, exclude=req)
        if priv is None:
            self._stats["pool_blocked_resumes"] += 1
            return False
        self._release_parked(e)  # its prefix shares, and host pages left unread
        self._slot_blocks[slot] = priv
        self._slot_shared[slot] = 0
        self._set_row(slot, priv, 0)
        self._stats["swap_faults"] += 1
        self._stats["fault_recomputes"] += 1
        self.trace.record("fault_recompute", req.rid, slot, n)
        toks = e["tokens"]
        bucket = next((b for b in self._prefill_buckets if b >= n), None)
        if bucket is not None:
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = toks
            _, self.state = self.model.prefill_into_slot(
                self.params, self.state, self._upload(padded, torch.int32), slot, n)
            self._restore_slot(slot, e)
            return True
        self._admitting[slot] = {
            "req": req, "padded": pad_to_chunks(toks, n, self._chunk), "n": n, "off": 0,
            "base": 0, "resume": {"req": req, "pending": e["pending"], "budget": e["budget"],
                                  "seq_len": n, "tokens": toks}}
        del self._parked[req]
        self._stats["resumes"] += 1
        return True

    def _install_handoffs(self) -> bool:
        """Map each finished handoff's filled blocks into a free slot: the
        entry is shaped as a parked one, so the resume remap is the install
        (one table-row and length write, ``_finish_resume_slot``) and no KV
        byte moves. The worker delivered the first token; the next tick
        feeds it. A cancelled entry releases its blocks and its slot takes
        the next entry at once. Returns whether any was installed."""
        rt = self._disagg
        installed = False
        for slot in range(self.serving.slots):
            if self._slot_req[slot] is not None or slot in self._admitting:
                continue
            while True:
                e = rt.pop_ready()
                if e is None:
                    return installed
                req = e["req"]
                if not req.cancelled:
                    break
                # its first token was delivered: it began service
                self._alloc.release(e["shared"] + e["priv"])
                self._stats["admissions"] += 1
                self._end_stream(req, req._abort or Status.CANCELLED)
            self._finish_resume_slot(slot, e)
            # the next token's gap counts from the worker's delivery
            self._itl_last[slot] = e["t_first"]
            self._stats["admissions"] += 1
            self.trace.record("pool_install", req.rid, slot, e["n_pages"])
            self.trace.record("admit", req.rid, slot, e["seq_len"])
            installed = True
        return installed

    # ----------------------------------------------------------- admission

    def _bucket(self, n: int) -> Optional[int]:
        """Smallest prefill bucket covering *n*, or None when the prompt
        admits in chunks instead (past every bucket, chunking on). Raises
        for a prompt nothing can admit."""
        for bkt in self._prefill_buckets:
            if n <= bkt:
                return bkt
        ctx = self.model.max_context
        if self._chunk and (ctx is None or n <= ctx):
            return None
        raise ValueError(f"prompt length {n} exceeds the largest usable bucket "
                         f"{self._prefill_buckets[-1]}"
                         + (f" (chunked prefill caps at max_context {ctx})"
                            if self._chunk else ""))

    def _chunk_bucket(self, need: int) -> int:
        """The read window of a chunk ending at ``need``: the smallest kv
        bucket covering it (buckets on or off)."""
        return next((bkt for bkt in self._kv_buckets if bkt >= need), self.model.max_context)

    def _upload(self, values, dtype: torch.dtype) -> torch.Tensor:
        """Host values (a list or numpy array) as a tensor on the engine's
        device, without a host wait: on CUDA through pinned memory and a
        non-blocking copy, which the caching host allocator keeps alive
        until the copy is done."""
        x = torch.as_tensor(values, dtype=dtype)
        if self.device.type != "cuda":
            return x.to(self.device)
        return x.pin_memory().to(self.device, non_blocking=True)

    def _reserve_paged(self, slot: int, req: Request) -> bool:
        """Map every page this request can touch (prefix + prompt + its token
        budget) and set the slot's device table row and base length. A
        prefixed request maps the prefix's full pages read-only (``share``,
        no device copy) and copies only a partial boundary page into a
        private block, which its suffix and decode writes would otherwise
        scribble into pages other slots read. False with nothing reserved
        when the free list can't cover the private pages: the request stays
        waiting and a later retire unblocks it (backpressure, never an
        error)."""
        if req.prefix is None:
            return self._reserve_paged_locked(slot, req, None)
        # the lookup, the share and the copy-on-write source read are
        # atomic against unregister_prefix, whose release takes this lock
        with self._prefix_lock:
            entry = self._prefixes.get(req.prefix)
            if entry is None:
                return True  # unregistered: _admit faults it, no pages
            ok = self._reserve_paged_locked(slot, req, entry)
        if ok:
            self._stats["prefix_hits"] += 1  # a paged hit is the share itself
        return ok

    def _reserve_plan(self, req: Request, entry: Optional[dict]) -> tuple[int, int, int, int]:
        """The page arithmetic slot admission and the prefill workers share:
        (base, budget, whole prefix pages, private pages to allocate)."""
        page = self._page
        base = entry["len"] if entry is not None else 0
        total = base + int(req.tokens.shape[0])
        budget = min(req.max_new_tokens, self.model.max_context - total)
        full = base // page  # whole prefix pages, shared as they are
        return base, budget, full, -(-max(total + max(budget, 0), 1) // page) - full

    def _reserve_paged_locked(self, slot: int, req: Request, entry: Optional[dict]) -> bool:
        # the share / copy-on-write sequence is mirrored by the prefill
        # worker's _reserve_locked (serving/disagg.py)
        base, _, full, need_priv = self._reserve_plan(req, entry)
        shared = entry["blocks"][:full] if entry is not None else []
        # overcommit: a dry free list first evicts parked sessions' private
        # pages before the admission waits
        priv = self._alloc_reclaim(need_priv) if need_priv > 0 else []
        if priv is None:
            self._stats["pool_blocked_admissions"] += 1
            return False
        if shared:
            self._alloc.share(shared)
            self._stats["prefix_blocks_shared"] += len(shared)
        if base % self._page:
            # copy-on-write: logical page `full` starts as a copy of the
            # prefix's boundary block, every layer and plane, in place
            self.state = self.model.copy_blocks(self.state, [entry["blocks"][full]], [priv[0]])
            self._stats["prefix_cow_copies"] += 1
        blocks = list(shared) + priv
        self._slot_blocks[slot] = blocks
        self._slot_shared[slot] = len(shared)
        self._set_row(slot, blocks, base)
        return True

    def _admit_waiting(self, budget: float) -> tuple[bool, float]:
        """Fill free slots from the waiting line under the per-tick prompt
        budget. FIFO at the head; same-bucket prompts coalesce from anywhere
        in the line into one [N, bucket] dispatch, N the largest admission
        size that fits (batched admission). Prefixed and chunked requests
        take their slot and pay the budget chunk by chunk
        (``_advance_admissions``); the serial path admits one bucketed
        prompt at a time. Nothing younger jumps a head blocked on budget or
        pool. Returns (any admission happened, remaining budget)."""
        admitted = False
        free = [i for i in range(self.serving.slots)
                if self._slot_req[i] is None and i not in self._admitting]
        while self._waiting and free:
            head = self._waiting.head()
            if head.cancelled:
                self._waiting.popleft()
                self._end_stream(head, head._abort or Status.CANCELLED)
                continue
            bucket = (None if head.prefix is not None
                      else self._bucket(int(head.tokens.shape[0])))
            if bucket is None or not self._async_admission:
                if bucket is not None and bucket > budget:
                    break
                if self._paged and not self._reserve_paged(free[0], head):
                    break  # pool exhausted: the head waits (backpressure)
                self._waiting.popleft()
                head.t_depart_ns = time.monotonic_ns()
                self.trace.record("queue_depart", head.rid, free[0])
                self._admit(free.pop(0), head)
                if bucket is not None:
                    budget -= bucket
                admitted = True
                continue
            cap = min(len(free), max(self._admit_sizes))
            group = [head]
            for req in self._waiting:
                if len(group) >= cap:
                    break
                if (req is not head and not req.cancelled and req.prefix is None
                        and self._bucket(int(req.tokens.shape[0])) == bucket):
                    group.append(req)
            fit = [s for s in self._admit_sizes if s <= len(group) and s * bucket <= budget]
            if not fit:
                break
            batch = group[:max(fit)]
            if self._paged:
                ok = 0
                for j, req in enumerate(batch):
                    if not self._reserve_paged(free[j], req):
                        break
                    ok += 1
                if ok == 0:
                    break  # head blocked on the pool: it keeps waiting
                m = max(s for s in self._admit_sizes if s <= ok)
                for j in range(m, ok):
                    self._free_slot_blocks(free[j])
                batch = batch[:m]
            for req in batch:
                self._waiting.remove(req)
                req.t_depart_ns = time.monotonic_ns()
                self.trace.record("queue_depart", req.rid)
            slots = [free.pop(0) for _ in batch]
            self._admit_batch(slots, batch, bucket)
            budget -= len(batch) * bucket
            admitted = True
        return admitted, budget

    def _admit(self, slot: int, req: Request) -> None:
        """Admit ONE request into *slot*: a prefixed or chunked prompt parks
        in ``_admitting`` (its chunks advance one a loop pass); a bucketed
        prompt here is the serial path, one [1, bucket] prefill dispatch
        and a blocking first-token fetch."""
        n = int(req.tokens.shape[0])
        if req.prefix is not None:
            with self._prefix_lock:
                entry = self._prefixes.get(req.prefix)
                if entry is not None and not self._paged:
                    # dense: the prefix's KV copied into the slot's leading
                    # positions, under the lock, so unregister_prefix cannot
                    # drop the adapter's buffers first (paged slots mapped
                    # the prefix at reservation: no copy)
                    self.state = self.model.install_prefix(self.state, entry["buf"], slot)
            if entry is None:
                # unregister_prefix raced this submit: fault this request
                # alone (pages reserved for it go straight back)
                log.warning("request %s references unregistered prefix %s; retiring it "
                            "unserved", req.rid, req.prefix)
                self._free_slot_blocks(slot)
                self._stats["prefix_misses"] += 1
                self._stats["faulted_requests"] += 1
                self.trace.record("fault", req.rid, slot)
                self._end_stream(req, Status.FAULTED, slot)
                return
            if not self._paged:
                self._stats["prefix_install_copies"] += 1
                self._stats["prefix_hits"] += 1
            base = entry["len"]
            if n == 0:
                # no suffix: the first token comes from the prefix's logits
                self._first_from(slot, req, entry["last_logits"], base)
                return
            self._admitting[slot] = {"req": req, "padded": pad_to_chunks(req.tokens, n, self._chunk),
                                     "n": base + n, "off": 0, "base": base}
            return
        bucket = self._bucket(n)
        if bucket is None:
            # chunked prefill is incremental: live streams decode between
            # this prompt's chunks
            self._admitting[slot] = {"req": req, "padded": pad_to_chunks(req.tokens, n, self._chunk),
                                     "n": n, "off": 0, "base": 0}
            return
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = req.tokens
        logits, self.state = self.model.prefill_into_slot(
            self.params, self.state, self._upload(padded, torch.int32), slot, n)
        self._stats["prefill_batch_hist"][1] += 1
        self._finish_admit(slot, req, self._sample_first(logits, slot), n)

    def _first_from(self, slot: int, req: Request, logits_row: torch.Tensor, n: int) -> None:
        """The first token of a single-row admission (a prefix's stored
        logits, a final chunk's last row): sampled on the device into the
        first-token buffer (batched admission), or fetched at once (the
        serial path)."""
        if not self._async_admission:
            self._finish_admit(slot, req, self._sample_first(logits_row, slot), n)
            return
        tok = self._sample_row(logits_row, slot)
        self._begin_slot(slot, req, n)
        self._admit_buf[slot:slot + 1].copy_(tok)
        self._admit_mask[slot] = True
        self._pending_firsts.append({"tokens": tok, "rows": [(slot, req, 0)]})

    def _advance_admissions(self, budget: float) -> float:
        """One prefill chunk per mid-admission slot, then back to the decode
        tick, sharing the per-tick prompt budget with bucketed admission;
        the lead rotates so no admitting slot starves under the budget. The
        final chunk completes the admission, or restores the slot of a
        chunked rebuild (overcommit). An exception faults that request
        alone."""
        order = sorted(self._admitting)
        if len(order) > 1:
            lead = self._adm_rr % len(order)
            order = order[lead:] + order[:lead]
        self._adm_rr += 1
        c = self._chunk
        for slot in order:
            adm = self._admitting[slot]
            req, n, off, base = adm["req"], adm["n"], adm["off"], adm["base"]
            if req.cancelled:
                del self._admitting[slot]
                self._free_slot_blocks(slot)
                self._end_stream(req, req._abort or Status.CANCELLED, slot)
                continue
            if c > budget:
                break  # the rest advance next pass
            try:
                # off indexes the (suffix-)padded prompt; the cache offset
                # is past the prefix
                kv_bucket = self._chunk_bucket(base + off + c)
                ids = None
                if self._paged:
                    row = np.zeros((kv_bucket // self._page,), np.int32)
                    blocks = self._slot_blocks[slot]
                    m = min(len(blocks), row.shape[0])
                    row[:m] = blocks[:m]
                    ids = self._upload(row, torch.int32)
                logits, self.state = self._prefill_chunk(
                    self.params, self.state, self._upload(adm["padded"][:, off:off + c], torch.int32),
                    slot, base + off, min(base + off + c, n), kv_bucket=kv_bucket, block_ids=ids)
                adm["off"] = off + c
                budget -= c
                self._stats["prefill_chunks"] += 1
                self.trace.record("prefill_chunk", req.rid, slot, c)
                pad = adm["padded"].shape[1]
                if adm["off"] >= pad:
                    del self._admitting[slot]
                    if adm.get("resume") is not None:
                        # a chunked rebuild: the pending token was delivered
                        # before the park, so the slot is restored and
                        # nothing is sampled
                        self._restore_slot(slot, adm["resume"])
                        continue
                    self._first_from(slot, req, logits[0, (n - base - 1) - (pad - c)], n)
            except Exception:
                self._admitting.pop(slot, None)
                self._stats["faulted_requests"] += 1
                self.trace.record("fault", req.rid, slot)
                log.exception("request %s faulted mid-admission in slot %d; containing",
                              req.rid, slot)
                self._free_slot_blocks(slot)
                self._slot_req[slot] = None
                self._end_stream(req, Status.FAULTED, slot)
        return budget

    def _sample_first(self, logits_row: torch.Tensor, slot: int) -> int:
        """The serial path's first token: the custom sampler on the fetched
        [vocab] row, or the device sampler on the slot's generator, then a
        blocking one-row fetch. Counted as an admission sync (batched
        admission exists to keep this at zero)."""
        self._stats["admission_syncs"] += 1
        if not self._device_sampling:
            return int(self.sample(logits_row.float().cpu().numpy()))
        return int(self._sample_row(logits_row, slot).cpu()[0])

    def _sample_row(self, logits_row: torch.Tensor, slot: int) -> torch.Tensor:
        """One admission's first token from its [vocab] logits, sampled on
        the device from the slot's generator: a [1] int32 tensor."""
        return sample_tokens(logits_row[None], [self._gens[slot]], self.serving.temperature,
                             self.serving.top_k, self.serving.top_p)

    def _finish_admit(self, slot: int, req: Request, first: int, n: int) -> None:
        """Slot bookkeeping and delivery of a serial admission's first
        token, already on the host."""
        self._begin_slot(slot, req, n)
        self._tokens[slot] = first
        if self._track_history:
            self._history[slot].append(first)
        self._itl_last[slot] = time.perf_counter()
        self._note_first_token(req, slot)
        req.delivered += 1
        req.out.put(first)
        self._stats["generated_tokens"] += 1
        if self._slot_budget[slot] <= 0 or first == self.serving.eos_token:
            self._retire(slot)

    def _admit_batch(self, slots: list[int], reqs: list[Request], bucket: int) -> None:
        """One [N, bucket] prefill dispatch that installs N prompts' KV and
        samples their first tokens on the device. Nothing here waits for
        the device: the tokens are fed to the next decode tick from
        ``_admit_buf`` and reach the clients through the tick's fetch."""
        lens = [int(r.tokens.shape[0]) for r in reqs]
        padded = np.zeros((len(reqs), bucket), np.int32)
        for i, req in enumerate(reqs):
            padded[i, :lens[i]] = req.tokens
        tok, self._admit_buf, self.state = self._admit_step(
            self.params, self.state, self._admit_buf, self._upload(padded, torch.int32),
            self._upload(slots, torch.long), self._upload(lens, torch.long),
            [self._gens[s] for s in slots])
        rows = []
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            self._begin_slot(slot, req, lens[i])
            self._admit_mask[slot] = True
            rows.append((slot, req, i))
        self._pending_firsts.append({"tokens": tok, "rows": rows})
        self._stats["prefill_batch_hist"][len(reqs)] += 1

    def _begin_slot(self, slot: int, req: Request, n: int) -> None:
        """Slot bookkeeping for an admission whose first token is still on
        the device; its budget slice is reserved here."""
        self._slot_req[slot] = req
        ctx = self.model.max_context
        self._slot_budget[slot] = (min(req.max_new_tokens, ctx - n) if ctx
                                   else req.max_new_tokens) - 1
        self._slot_len[slot] = n
        self._itl_last[slot] = None
        if self._track_history:
            # what the slot's cache holds: prefix + prompt (the first
            # token joins when it is delivered)
            self._seed_history(slot, req, n)
        self._stats["admissions"] += 1
        self._note_admit(req, slot, n)

    def _seed_history(self, slot: int, req: Request, n: int) -> None:
        """A slot's history at admission, mirroring the ``n`` positions its
        cache holds: the prefix's tokens and the prompt. A prefix
        unregistered meanwhile leaves its tokens out: drafts only lose
        them, and under overcommit placeholders keep the length (a park
        needs it) with the history flagged inexact, so the session may
        swap but is never rebuilt from it."""
        entry = self._prefixes.get(req.prefix) if req.prefix is not None else None
        pre = list(entry["tokens"]) if entry else []
        toks = [int(x) for x in req.tokens.tolist()]
        miss = n - len(pre) - len(toks)
        self._slot_hist_exact[slot] = miss <= 0
        if miss > 0 and self._swap_enabled:
            pre += [0] * miss
        self._history[slot] = pre + toks

    # ------------------------------------------------------------ delivery

    def _stage(self, arrays: list, kind: str = "tick") -> dict:
        """Enqueue the one device->host copy of ``arrays`` (int32, joined
        into one buffer) without waiting for it: on CUDA into pinned memory
        with an event behind it. Staged right after the work that produces
        the arrays, the copy waits for that work only, not for what the
        stream runs after it."""
        flat = torch.cat([a.reshape(-1) for a in arrays])
        done = None
        if flat.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            flat = host
        return {"host": flat, "done": done, "sizes": [a.numel() for a in arrays],
                "kind": kind}

    def _collect(self, staged: dict, ticks: int = 1) -> list[np.ndarray]:
        """The loop's ONLY device->host read: wait for a staged copy and
        split it. Counted so stats() can show device_gets_per_tick == 1.0
        (1/k on the multi-tick loop); the wait is the tick's fetch phase
        (on the pipelined loop, the time the host waits for the tick in
        flight), over ``ticks`` inner ticks for a flush.

        The fetch watchdog reads the same wait: past fetch_watchdog_ms it
        trips a rung; under it, on a degraded engine, it extends a
        healthy streak, and a streak of fetch_watchdog_recover_ms lifts a
        rung (each further rung needs a streak of its own). The
        delayed_fetch seam stalls here for its ``arg`` seconds."""
        self._stats["device_gets"] += 1
        self._stats["tick_fetches" if staged["kind"] == "tick" else "admission_fetches"] += 1
        t0 = time.perf_counter()
        spec = self._fire_fault("delayed_fetch")
        if spec is not None:
            time.sleep(spec.arg or 0.05)
        if staged["done"] is not None:
            staged["done"].synchronize()
        flat = staged["host"].numpy()
        dt = time.perf_counter() - t0
        self._prof.note("fetch", dt, ticks=ticks)
        wd = self.serving.fetch_watchdog_ms
        if wd:
            if dt * 1e3 > wd:
                self._trip_watchdog(dt)
            elif self._applied_rungs and self.serving.fetch_watchdog_recover_ms:
                now = time.perf_counter()
                if self._healthy_since is None:
                    self._healthy_since = now
                elif (now - self._healthy_since) * 1e3 >= self.serving.fetch_watchdog_recover_ms:
                    self._recover_watchdog()
                    self._healthy_since = now
        self._stats["bytes_fetched"] += flat.nbytes
        out, at = [], 0
        for n in staged["sizes"]:
            out.append(flat[at:at + n])
            at += n
        return out

    def _note_host_ms(self, seconds: float) -> None:
        ms = seconds * 1e3
        self._host_ms_ema = ms if self._host_ms_ema is None else 0.9 * self._host_ms_ema + 0.1 * ms

    def _note_admission_ms(self, seconds: float) -> None:
        ms = seconds * 1e3
        self._admission_ms_ema = (ms if self._admission_ms_ema is None
                                  else 0.9 * self._admission_ms_ema + 0.1 * ms)

    def _note_itl(self, slot: int, now: float) -> None:
        """One inter-token gap for *slot* into the trace's reservoir (the
        first token after admission only stamps the clock: that interval
        is TTFT)."""
        last = self._itl_last[slot]
        if last is not None:
            self.trace.note_itl(now - last)
        self._itl_last[slot] = now

    def _note_admit(self, req: Request, slot: int, n: int) -> None:
        """The 'admit' event plus the queue-wait sample (submit -> slot)."""
        now_ns = time.monotonic_ns()
        self.trace.record("admit", req.rid, slot, n)
        if req.t_submit_ns:
            self.trace.note_queue_wait((now_ns - req.t_submit_ns) / 1e9)

    def _note_first_token(self, req: Request, slot: int) -> None:
        """The 'first_token' event, its TTFT sample and the prefill
        execution part of it (queue departure -> first token)."""
        now_ns = time.monotonic_ns()
        self.trace.record("first_token", req.rid, slot)
        if req.t_submit_ns:
            self.trace.note_ttft((now_ns - req.t_submit_ns) / 1e9)
        dep = req.t_depart_ns or req.t_submit_ns
        if dep:
            self.trace.note_prefill_exec((now_ns - dep) / 1e9)

    def _deliver_firsts(self, firsts: list[dict], fetched: Optional[list] = None) -> None:
        """Deliver admission first tokens; with ``fetched`` None this is an
        idle engine's own batched fetch."""
        if fetched is None:
            fetched = self._collect(self._stage([f["tokens"] for f in firsts], "admission"))
        for f, arr in zip(firsts, fetched):
            for slot, req, idx in f["rows"]:
                if req is not self._slot_req[slot]:
                    continue  # retired between dispatch and delivery
                if req.cancelled:
                    self._retire(slot)
                    continue
                self._emit_first(slot, int(arr[idx]))

    def _emit_first(self, slot: int, tok: int) -> None:
        req = self._slot_req[slot]
        self._tokens[slot] = tok
        if self._track_history:
            self._history[slot].append(tok)
        self._itl_last[slot] = time.perf_counter()
        self._note_first_token(req, slot)
        req.delivered += 1
        req.out.put(tok)
        self._stats["generated_tokens"] += 1
        if self._slot_budget[slot] <= 0 or tok == self.serving.eos_token:
            self._retire(slot)

    def _tick_arrays(self, tick: dict) -> list:
        """A tick's arrays for the one staged copy: its tokens, and with
        logprobs the [B] f32 logprobs bit-cast to int32 so they join the
        same buffer."""
        if tick["logprobs"] is None:
            return [tick["tokens"]]
        return [tick["tokens"], tick["logprobs"].view(torch.int32)]

    def _deliver(self, tick: dict, extra_host_s: float = 0.0,
                 firsts: Optional[list] = None) -> None:
        """One fetch for the tick's tokens (and logprobs) and this pass's
        first tokens (staged by the loop, or here), then host bookkeeping.
        ``extra_host_s`` is the pass's dispatch-side host time, folded into
        the same host_ms_per_tick sample. ``tick["reqs"]`` snapshots each
        slot's request at dispatch; a slot whose occupant changed since
        (retired, cancelled or recycled) drops its token: that is what makes
        the pipelined loop's one-tick lookahead safe."""
        firsts = firsts or []
        staged = tick.get("staged") or self._stage(
            self._tick_arrays(tick) + [f["tokens"] for f in firsts])
        toks, *rest = self._collect(staged)
        lps = rest.pop(0).view(np.float32) if tick["logprobs"] is not None else None
        t0 = time.perf_counter()
        if firsts:
            self._deliver_firsts(firsts, fetched=rest)
        now = time.perf_counter()
        for slot, req in enumerate(tick["reqs"]):
            if req is None or req is not self._slot_req[slot]:
                continue
            try:
                self._emit(slot, int(toks[slot]), None if lps is None else float(lps[slot]), now)
            except Exception:
                # one request's delivery failed: that slot alone retires
                self._contain_fault(slot)
        self._prof.note("deliver", time.perf_counter() - t0)
        self._note_host_ms(extra_host_s + time.perf_counter() - t0)

    def _emit(self, slot: int, tok: int, lp: Optional[float] = None,
              now: Optional[float] = None) -> None:
        """One delivered decode token: the one implementation behind the
        device-sampled delivery and the host-sampler path."""
        self._maybe_inject_dispatch()
        req = self._slot_req[slot]
        self._tokens[slot] = tok
        self._slot_len[slot] += 1  # the device length advanced at dispatch
        self._note_itl(slot, now if now is not None else time.perf_counter())
        self.trace.record("token", req.rid, slot)
        # the logprob goes in before the token: the put wakes the client,
        # which may read logprobs[-1] for this token at once
        if lp is not None:
            req.logprobs.append(lp)
        req.delivered += 1
        req.out.put(tok)
        self._stats["generated_tokens"] += 1
        self._slot_budget[slot] -= 1
        if self._track_history:
            self._history[slot].append(tok)
        if self._slot_budget[slot] <= 0 or tok == self.serving.eos_token:
            self._retire(slot)

    def _note_kv_window(self, kv_bucket: int, lens: list, t: int = 1, ticks: int = 1) -> None:
        """Read-window and route accounting of one dispatch of ``ticks``
        inner ticks of ``t`` queries a row (k for a flush, K+1 for a
        verify chunk), counted in inner ticks. ``lens`` is each dispatched
        slot's device length the dispatch reads up to (before its own
        write): on a paged pool the pages each slot maps against the pages
        the window spans, at the dispatch's lengths for all its inner ticks
        (a flush undercounts by at most a page a slot), as the reference
        counts them."""
        key = int(kv_bucket) or int(self.model.max_context or 0)
        hist = self._stats["kv_bucket_hist"]
        hist[key] = hist.get(key, 0) + ticks
        if self._paged and lens:
            page = self._page
            live = sum(-(-(n + 1) // page) for n in lens)
            self._stats["read_pages_live"] += live * ticks
            self._stats["read_pages_window"] += (key // page) * len(lens) * ticks
            rh = self._stats["read_pages_hist"]
            rh[live] = rh.get(live, 0) + ticks
            # the trunk resolves the route from the same inputs
            route = paged_attn_route(self._paged_attn, key, self.device, t)
            self._stats["paged_attn_kernel_ticks" if route == "kernel"
                        else "paged_attn_gather_ticks"] += ticks

    def _kv_bucket(self, need: int) -> int:
        """The read window of a tick whose longest row needs ``need`` keys:
        the smallest kv bucket covering it (0 = max_seq with buckets off)."""
        if not self._use_kv_buckets:
            return 0
        return next((bkt for bkt in self._kv_buckets if bkt >= need), self.model.max_context)

    # ---------------------------------------------------------------- loop

    def _loop(self) -> None:
        if self.device.type == "cuda":
            self._main_stream = torch.cuda.current_stream(self.device)
        if self._disagg is not None:
            # the graphs were captured at construction: workers may start
            self._disagg.started.set()
        try:
            if self._fused_spec:
                self._loop_fused()
            elif self._loop_k:
                self._loop_device()
            elif self._pipeline:
                self._loop_pipelined()
            else:
                self._loop_sync()
        except EngineDeath:
            # the engine_death seam: the thread exits without its shutdown
            # sweep (no terminals, no releases), as a killed process would
            return
        except Exception as exc:  # the loop thread's boundary: report, end streams
            self.loop_error = exc
            log.exception("serving loop failed; ending every stream")
        finally:
            if not self._died:
                if self._disagg is not None:
                    # workers first: the sweep owns what they leave (their
                    # exits release blocks and end streams)
                    self._stop.set()
                    self._disagg.join()
                self._drain_all()

    def _tick_head(self) -> bool:
        """Stamp the heartbeat (then the engine_death seam), run queued
        paged prefix builds, drain submissions into the waiting line, shed
        requests past their deadlines; under overcommit apply park and
        resume commands and retire finished swap-outs (no wait: the
        swap_drain phase); advance chunked admissions and rebuilds, bring
        resumed sessions back, then admit into free slots, all under one
        prompt budget (bypassed while nothing decodes; chunks in flight
        spend first, resumes before new admissions); shed the waiting
        line's overflow, and retire cancelled and deadline-aborted slots.
        Under disaggregation the prefill workers own the waiting line: the
        tick head reclaims the blocks a worker asked for (eviction runs on
        this thread only), restarts dead workers and re-queues what they
        held (``DisaggRuntime.watch``), and installs finished handoffs into
        free slots in place of admitting. Returns whether anything was
        admitted or installed."""
        t0 = time.perf_counter()
        self._beat_ns = time.monotonic_ns()
        if self._fire_fault("engine_death"):
            self._died = True
            raise EngineDeath("injected engine_death at the flush boundary")
        if self._paged:
            self._drain_prefix_work()
        while True:
            try:
                self._waiting.append(self._pending.get_nowait())
            except queue.Empty:
                break
        self._shed_deadlines()
        swap_s = 0.0
        if self._swap_enabled:
            self._process_lifecycle()
            t_sw = time.perf_counter()
            self._drain_swap_outs()
            swap_s = time.perf_counter() - t_sw
            self._prof.note("swap_drain", swap_s)
        if self._disagg is not None and self._swap_enabled:
            need = self._disagg.take_needed_blocks()
            if need:
                self._reclaim(need)
        decoding = any(r is not None for r in self._slot_req)
        budget = (float(self.serving.prefill_budget)
                  if self.serving.prefill_budget and decoding else float("inf"))
        budget = self._advance_admissions(budget)
        if self._swap_enabled:
            budget = self._advance_resumes(budget)
        if self._disagg is not None:
            self._disagg.watch()
            admitted = self._install_handoffs()
            if len(self._waiting):
                self._disagg.notify_work()
        else:
            admitted, _ = self._admit_waiting(budget)
        self._shed_overload()
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.cancelled:
                self._retire(slot)
        dt = time.perf_counter() - t0
        self._note_admission_ms(dt)
        self._prof.note("admission", dt - swap_s)
        return admitted

    def _shed_deadlines(self) -> None:
        """Deadlines at the tick head. A waiting request past its deadline
        is taken from the line atomically and ends SHED_DEADLINE before
        admission; a live or mid-chunk one is marked for abort, and the
        cancel sweeps of this tick head retire it with that terminal,
        the path a client cancel rides (a token in flight for it is
        dropped at delivery). Nothing runs until a submit carries a
        deadline."""
        if not self._deadlines_seen:
            return
        now = time.monotonic_ns()
        shed = TERMINAL_CODES[Status.SHED_DEADLINE]
        for req in self._waiting:
            if req.deadline_ns is not None and now > req.deadline_ns and not req.cancelled:
                if self._waiting.take(req):
                    self._stats["shed_deadline"] += 1
                    self.trace.record("shed", req.rid, -1, shed)
                    self._end_stream(req, Status.SHED_DEADLINE)
        live = [r for r in self._slot_req if r is not None]
        live += [adm["req"] for adm in self._admitting.values()]
        for req in live:
            if req.deadline_ns is not None and now > req.deadline_ns and req._abort is None:
                req._abort = Status.SHED_DEADLINE
                self._stats["shed_deadline"] += 1
                self.trace.record("shed", req.rid, -1, shed)

    def _shed_overload(self) -> None:
        """Overload shedding after the tick head's admissions: what still
        overflows shed_queue_depth is real excess, and the ShedPolicy picks
        the victims, given the pressure snapshot with queue_depth pinned to
        its own waiter snapshot where it takes one. A victim claimed or
        cancelled meanwhile loses the atomic take and is skipped. A policy
        that raises is logged and this tick sheds nothing."""
        depth = self.serving.shed_queue_depth
        if not depth:
            return
        excess = len(self._waiting) - depth
        if excess <= 0:
            return
        try:
            waiters = list(self._waiting)
            if self._shed_signals:
                signals = dataclasses.replace(self.signals(), queue_depth=len(waiters))
                victims = list(self._shed_policy.select(waiters, excess, signals))[:excess]
            else:
                victims = list(self._shed_policy.select(waiters, excess))[:excess]
        except Exception:
            log.exception("shed policy %r raised; skipping this tick's overload shed",
                          type(self._shed_policy).__name__)
            return
        for req in victims:
            if self._waiting.take(req):
                self._stats["shed_overload"] += 1
                self.trace.record("shed", req.rid, -1, TERMINAL_CODES[Status.SHED_OVERLOAD])
                self._end_stream(req, Status.SHED_OVERLOAD)

    def _on_ticks(self, k: int) -> None:
        """``k`` decode ticks were dispatched: the disaggregation
        controller refills its prefill allowance once for each."""
        if self._disagg is not None:
            for _ in range(k):
                self._disagg.on_tick()

    def _idle_wait(self, admitted: bool) -> None:
        """Nothing to decode or deliver: wait briefly for a submission,
        unless admissions are mid-chunk or one just landed."""
        if admitted or self._admitting:
            return
        if self._wake.wait(timeout=0.05):
            self._wake.clear()

    def _spec_probe_ema(self) -> float:
        """The acceptance EMA of a fresh probe: a little above breakeven,
        so a losing probe sinks below the gate within a few ticks."""
        return (self.serving.spec_min_mean or 1.0) + 0.25

    def _spec_allowed(self) -> bool:
        """The adaptive gate: drafting pauses while the emitted-per-slot
        EMA sits below spec_min_mean, and re-probes after the cooloff."""
        if not self.serving.spec_min_mean:
            return True
        if self._spec_cooloff > 0:
            self._spec_cooloff -= 1
            if self._spec_cooloff == 0:
                self._spec_ema = self._spec_probe_ema()
            return False
        return True

    def _note_spec_ema(self, emitted: int, participations: int) -> None:
        """Move the acceptance EMA toward this dispatch's delivered tokens
        per slot participation; below spec_min_mean, start a cooloff."""
        self._spec_ema = 0.9 * self._spec_ema + 0.1 * emitted / max(participations, 1)
        if self.serving.spec_min_mean and self._spec_ema < self.serving.spec_min_mean:
            self._spec_cooloff = self.serving.spec_cooloff_ticks

    def _loop_sync(self) -> None:
        """Synchronous tick loop: tick head, one decode dispatch, one fetch,
        delivery, repeat. Still one device->host read per tick; only the
        overlap of the pipelined loop is missing. With a custom sampler the
        tick returns [B, vocab] logits: that fetch is the tick's one, and
        the callable runs on each live row. With speculation a tick where
        some slot finds a draft in its history is a verify tick
        (``_spec_tick``); the others are plain ticks."""
        b = self.serving.slots
        while not self._stop.is_set():
            admitted = self._tick_head()
            firsts, self._pending_firsts = self._pending_firsts, []
            active_slots = [i for i in range(b) if self._slot_req[i] is not None]
            if not active_slots:
                if firsts:
                    self._deliver_firsts(firsts)
                else:
                    self._idle_wait(admitted)
                continue
            t_disp = time.perf_counter()
            tokens = self._upload(self._tokens, torch.int32)
            fresh = [self._admit_mask[i] for i in range(b)]
            if any(fresh):
                # freshly admitted slots feed their device-resident first token
                tokens = torch.where(self._upload(fresh, torch.bool), self._admit_buf, tokens)
                self._admit_mask = [False] * b
            active = self._upload([r is not None for r in self._slot_req], torch.bool)
            drafts = None
            if self._spec_tokens and self._spec_allowed():
                drafts = [lookup_draft(self._history[i], self._spec_tokens,
                                       self.serving.spec_ngram) if i in active_slots else None
                          for i in range(b)]
                if not any(d is not None for d in drafts):
                    drafts = None  # nothing to verify: a plain tick
            chunk = self._spec_tokens + 1 if drafts is not None else 1
            kv_bucket = self._kv_bucket(chunk + max(self._slot_len[i] for i in active_slots))
            self._note_kv_window(kv_bucket, [self._slot_len[i] + chunk - 1 for i in active_slots],
                                 t=chunk)
            if drafts is not None:
                self._spec_tick(drafts, active, kv_bucket, active_slots, t_disp)
                continue
            if not self._device_sampling:
                self._host_sampled_tick(tokens, active, kv_bucket, active_slots, t_disp)
                continue
            out, self.state = self._step(
                self.params, self.state, tokens, active, self._gens, kv_bucket)
            self._stats["decode_ticks"] += 1
            self._on_ticks(1)
            tick = self._tick(out, list(self._slot_req))
            tick["staged"] = self._stage(self._tick_arrays(tick) + [f["tokens"] for f in firsts])
            disp_s = time.perf_counter() - t_disp
            self._prof.note("dispatch", disp_s)
            self._deliver(tick, extra_host_s=disp_s, firsts=firsts)

    def _spec_tick(self, drafts: list, active, kv_bucket: int, active_slots: list,
                   t_disp: float) -> None:
        """One verify tick of the synchronous loop: the [B, K+1] draft
        (each slot's pending token, then its draft or zeros), one fetch of
        (pred, count), each slot's accepted run truncated at an eos and
        delivered, and the acceptance accounting. The device length grew
        by count; the host mirror follows it before any truncation."""
        k = self._spec_tokens
        b = self.serving.slots
        draft = self._upload([[self._tokens[i]] + (drafts[i] or [0] * k) for i in range(b)],
                             torch.int32)
        cap = self._upload([max(self._slot_budget[i], 0) for i in range(b)], torch.int32)
        (pred, count), self.state = self._spec(self.params, self.state, draft, active, cap,
                                               self._gens, kv_bucket)
        staged = self._stage([pred, count])
        disp_s = time.perf_counter() - t_disp
        self._prof.note("dispatch", disp_s)
        pred, count = self._collect(staged)
        pred = pred.reshape(b, k + 1)
        t0 = time.perf_counter()
        eos = self.serving.eos_token
        hist = self._stats["spec_emitted_hist"]
        emitted_total = 0
        for slot in active_slots:
            try:
                self._maybe_inject_dispatch()
                emitted = [int(x) for x in pred[slot, :int(count[slot])]]
                self._slot_len[slot] += int(count[slot])
                if eos in emitted:
                    emitted = emitted[:emitted.index(eos) + 1]
                req = self._slot_req[slot]
                for tok in emitted:
                    self.trace.record("token", req.rid, slot)
                    req.delivered += 1
                    req.out.put(tok)
                # acceptance counts DELIVERED tokens (after the eos cut)
                emitted_total += len(emitted)
                hist[min(len(emitted), len(hist) - 1)] += 1
                self._stats["generated_tokens"] += len(emitted)
                self._slot_budget[slot] -= len(emitted)
                self._history[slot].extend(emitted)
                if emitted:
                    self._tokens[slot] = emitted[-1]
                    # one gap per (slot, verify tick): the burst reaches
                    # the client at once
                    self._note_itl(slot, t0)
                if self._slot_budget[slot] <= 0 or (emitted and emitted[-1] == eos):
                    self._retire(slot)
            except Exception:
                self._contain_fault(slot)
        self._stats["spec_ticks"] += 1
        self._stats["spec_slot_ticks"] += len(active_slots)
        self._stats["spec_emitted"] += emitted_total
        self._note_spec_ema(emitted_total, len(active_slots))
        self._prof.note("deliver", time.perf_counter() - t0)
        self._note_host_ms(disp_s + time.perf_counter() - t0)

    def _tick(self, out, reqs: list) -> dict:
        """A dispatched tick: the sampled step's output (the tokens, or the
        tokens and their logprobs) and each slot's request at dispatch."""
        tok, lp = out if self._logprobs else (out, None)
        return {"tokens": tok, "logprobs": lp, "reqs": reqs}

    def _host_sampled_tick(self, tokens, active, kv_bucket: int, active_slots: list,
                           t_disp: float) -> None:
        """The host-sampler tick: the decode step's [B, vocab] f32 logits,
        fetched in the tick's one staged copy, and the custom sampler on
        each live row (an exception in it faults that request alone)."""
        logits, self.state = self._decode(self.params, self.state, tokens, active, kv_bucket)
        self._stats["decode_ticks"] += 1
        staged = self._stage([logits.float()])
        disp_s = time.perf_counter() - t_disp
        self._prof.note("dispatch", disp_s)
        (flat,) = self._collect(staged)
        rows = flat.reshape(len(self._slot_req), -1)
        t0 = time.perf_counter()
        for slot in active_slots:
            try:
                self._emit(slot, int(self.sample(rows[slot])))
            except Exception:
                self._contain_fault(slot)
        self._prof.note("deliver", time.perf_counter() - t0)
        self._note_host_ms(disp_s + time.perf_counter() - t0)

    def _loop_pipelined(self) -> None:
        """One-tick-deep decode pipeline (the reference's
        ``_loop_pipelined``):

            dispatch tick t+1 -> the device starts on it behind tick t
            deliver tick t    -> ONE wait for t's staged copy, then Python
                                 bookkeeping, WHILE the device runs t+1

        Tick t+1's token inputs are tick t's sampled tokens, still on the
        device: no host round-trip sits between consecutive ticks. The host
        runs one tick behind, so slot lifecycle needs care:

        - budget exhaustion is PREDICTED at dispatch: a slot whose in-flight
          token spends its last budget is left out of the new tick (it
          retires at delivery), so the device length never runs past the
          budget wall;
        - eos is not predictable: an eos at t wastes one slot-tick of
          device work at t+1, and _deliver's identity check drops the
          orphaned token (the slot's next admission overwrites the
          over-advanced cache row and length);
        - a slot admitted after t's dispatch joins at t+1, its first token
          merged in from ``_admit_buf`` on the device;
        - a slot wanted for a park is left out of t+1, so the park settles
          at the next tick head once t's token has landed;
        - the read window covers the DEVICE length (the host mirror lags
          one tick for slots fed from the tick in flight);
        - on stop, a tick still in flight is delivered.

        The copy of tick t's tokens (with this pass's admission first
        tokens) is staged before tick t+1 is dispatched, so delivering t
        waits for t and not for t+1."""
        b = self.serving.slots
        inflight: Optional[dict] = None
        # the [B] active mask changes only on admit/retire: cache the device
        # tensor keyed on the dispatch set
        active = None
        active_key: Optional[tuple] = None
        while not self._stop.is_set():
            admitted = self._tick_head()
            firsts, self._pending_firsts = self._pending_firsts, []
            t_disp = time.perf_counter()
            # fed[i]: slot i's next token is the in-flight tick's sample for
            # the same request
            fed = [inflight is not None and inflight["reqs"][i] is not None
                   and inflight["reqs"][i] is self._slot_req[i] for i in range(b)]
            # a slot wanted for a park is left out, so its in-flight token
            # lands and the park settles at the next tick head
            dispatch = [i for i in range(b) if self._slot_req[i] is not None
                        and self._slot_req[i] not in self._want_park
                        and self._slot_budget[i] - (1 if fed[i] else 0) > 0]
            staged_firsts = None
            if inflight is not None:
                inflight["staged"] = self._stage(
                    self._tick_arrays(inflight) + [f["tokens"] for f in firsts])
            elif firsts:
                staged_firsts = self._stage([f["tokens"] for f in firsts], kind="admission")
            new_inflight = None
            disp_s = 0.0
            if dispatch:
                live = set(dispatch)
                if inflight is not None and all(fed[i] for i in dispatch):
                    # steady state: feed the in-flight tokens straight back
                    tokens = inflight["tokens"]
                elif inflight is None:
                    tokens = self._upload(self._tokens, torch.int32)
                else:
                    tokens = torch.where(self._upload(fed, torch.bool), inflight["tokens"],
                                         self._upload(self._tokens, torch.int32))
                over = [i for i in dispatch if self._admit_mask[i]]
                if over:
                    # freshly admitted slots: first tokens still on the device
                    tokens = torch.where(self._upload([i in over for i in range(b)], torch.bool),
                                         self._admit_buf, tokens)
                    for i in over:
                        self._admit_mask[i] = False
                if active_key != tuple(dispatch):
                    active = self._upload([i in live for i in range(b)], torch.bool)
                    active_key = tuple(dispatch)
                lens = [self._slot_len[i] + (1 if fed[i] else 0) for i in dispatch]
                kv_bucket = self._kv_bucket(1 + max(lens))
                self._note_kv_window(kv_bucket, lens)
                out, self.state = self._step(
                    self.params, self.state, tokens, active, self._gens, kv_bucket)
                self._stats["decode_ticks"] += 1
                self._on_ticks(1)
                if inflight is not None:
                    self._stats["pipelined_ticks"] += 1
                new_inflight = self._tick(out, [self._slot_req[i] if i in live else None
                                                for i in range(b)])
                disp_s = time.perf_counter() - t_disp
                self._prof.note("dispatch", disp_s)
            if not dispatch and inflight is None:
                if firsts:
                    # admissions whose every request spends its whole budget
                    # on the first token: deliver (and retire) them now
                    self._deliver_firsts(firsts, fetched=self._collect(staged_firsts))
                else:
                    self._idle_wait(admitted)
                continue
            if inflight is not None:
                self._deliver(inflight, extra_host_s=disp_s, firsts=firsts)
            elif firsts:
                # no tick in flight to ride on (the engine was idle): the
                # first tokens' own fetch, staged ahead of the new tick
                self._deliver_firsts(firsts, fetched=self._collect(staged_firsts))
            inflight = new_inflight
            self._inflight_slots = self._slots_of(inflight)
        if inflight is not None:
            # stop() landed between dispatch and delivery: the tick's tokens
            # are computed, so deliver them (and device_gets stays equal to
            # decode_ticks)
            self._deliver(inflight)

    @staticmethod
    def _slots_of(inflight: Optional[dict]) -> set:
        """Slots with a token in flight: what the next tick head's parks
        must wait for."""
        if inflight is None:
            return set()
        return {i for i, r in enumerate(inflight["reqs"]) if r is not None}

    def _flush_arrays(self, flush: dict) -> list:
        """A flush's arrays for its one staged copy: the [B, k] tokens, the
        counts ([B], or [B, k] for a fused flush), and for a logprobs
        engine the [B, k] logprobs bit-cast to int32."""
        arrays = [flush["tokens"], flush["counts"]]
        if flush.get("logprobs") is not None:
            arrays.append(flush["logprobs"].view(torch.int32))
        return arrays

    def _loop_device(self) -> None:
        """The multi-tick device loop (``decode_loop_k`` = k > 1, the
        reference's ``_loop_device``): every dispatch is a k-tick flush
        (one graph replay on a card) with the sampled token fed back on
        the device and per-slot early exit, and the host makes ONE fetch
        of the [B, k] tokens and the counts a flush. Admission, retirement
        and cancellation happen at flush boundaries (``_tick_head``, 1/k as
        often), so a request that arrives mid-flush waits up to k ticks.

        Pipelining is flush-deep: flush t+1 is dispatched from flush t's
        ``carry`` (still on the device) before flush t is delivered, so:
        - each slot's cap is its remaining budget minus the in-flight
          flush's predicted emissions, and a slot whose cap reaches zero is
          left out (it retires at delivery): the device length never runs
          past the budget wall or the pages reserved for it;
        - an eos inside a flush freezes the slot on the device for the rest
          of it and costs at most one slot-flush at t+1, whose column the
          delivery's identity check drops;
        - freshly admitted slots join with their first token merged in
          from ``_admit_buf`` on the device;
        - a slot wanted for a park is left out, so the park settles at the
          next boundary with the host's length equal to the device's;
        - the read window covers the device length at the END of the
          flush: the host mirror plus the in-flight predictions plus k.
        ``pipeline_decode=False`` is the synchronous flush loop (dispatch,
        deliver, repeat: still one fetch a flush). While the watchdog's
        first rung holds, each dispatch is a one-token flush (``_flush1``)."""
        b = self.serving.slots
        inflight: Optional[dict] = None
        active = None
        active_key: Optional[tuple] = None
        while not self._stop.is_set():
            admitted = self._tick_head()
            firsts, self._pending_firsts = self._pending_firsts, []
            t_disp = time.perf_counter()
            fed = [inflight is not None and inflight["reqs"][i] is not None
                   and inflight["reqs"][i] is self._slot_req[i] for i in range(b)]
            # budget left after the in-flight flush's predicted emissions
            # (exact unless the slot hit an eos in flight, and such a slot
            # retires at delivery anyway)
            rem = [self._slot_budget[i] - (inflight["pred"][i] if fed[i] else 0)
                   for i in range(b)]
            dispatch = [i for i in range(b) if self._slot_req[i] is not None
                        and self._slot_req[i] not in self._want_park and rem[i] > 0]
            staged_firsts = None
            if self._pipeline:
                if inflight is not None:
                    inflight["staged"] = self._stage(
                        self._flush_arrays(inflight) + [f["tokens"] for f in firsts])
                elif firsts:
                    staged_firsts = self._stage([f["tokens"] for f in firsts], kind="admission")
            new_inflight = None
            disp_s = 0.0
            if dispatch:
                live = set(dispatch)
                if inflight is not None and all(fed[i] for i in dispatch):
                    # steady state: the in-flight flush's last tokens feed back
                    tokens = inflight["carry"]
                elif inflight is None:
                    tokens = self._upload(self._tokens, torch.int32)
                else:
                    tokens = torch.where(self._upload(fed, torch.bool), inflight["carry"],
                                         self._upload(self._tokens, torch.int32))
                over = [i for i in dispatch if self._admit_mask[i]]
                if over:
                    tokens = torch.where(self._upload([i in over for i in range(b)], torch.bool),
                                         self._admit_buf, tokens)
                    for i in over:
                        self._admit_mask[i] = False
                if active_key != tuple(dispatch):
                    active = self._upload([i in live for i in range(b)], torch.bool)
                    active_key = tuple(dispatch)
                k = self._loop_cap
                flush = self._flush1 if k == 1 else self._flush
                # per-slot early-exit caps: a flush never overdraws a budget
                pred = [min(rem[i], k) if i in live else 0 for i in range(b)]
                lens = [self._slot_len[i] + (inflight["pred"][i] if fed[i] else 0)
                        for i in dispatch]
                kv_bucket = self._kv_bucket(k + max(lens))
                self._note_kv_window(kv_bucket, lens, ticks=k)
                out, self.state = flush(self.params, self.state, tokens, active,
                                        self._upload(pred, torch.int32), self._gens, kv_bucket)
                self._stats["decode_ticks"] += k
                self._stats["loop_flushes"] += 1
                self._on_ticks(k)
                if inflight is not None:
                    self._stats["pipelined_ticks"] += k
                toks, counts, carry, lps = out
                new_inflight = {"tokens": toks, "counts": counts, "carry": carry,
                                "logprobs": lps, "pred": pred, "k": k,
                                "t_disp_ns": time.monotonic_ns(),
                                "reqs": [self._slot_req[i] if i in live else None
                                         for i in range(b)]}
                disp_s = time.perf_counter() - t_disp
                self._prof.note("dispatch", disp_s, ticks=k)
            if not dispatch and inflight is None:
                if firsts:
                    self._deliver_firsts(firsts, fetched=(
                        self._collect(staged_firsts) if staged_firsts is not None else None))
                else:
                    self._idle_wait(admitted)
                continue
            if not self._pipeline:
                # the synchronous flush loop: deliver what was just dispatched
                if new_inflight is not None:
                    self._deliver_flush(new_inflight, extra_host_s=disp_s, firsts=firsts)
                elif firsts:
                    self._deliver_firsts(firsts)
                continue
            if inflight is not None:
                self._deliver_flush(inflight, extra_host_s=disp_s, firsts=firsts)
            elif firsts:
                # no flush in flight to ride on (the engine was idle): the
                # first tokens' own fetch, staged ahead of the new flush
                self._deliver_firsts(firsts, fetched=self._collect(staged_firsts))
            inflight = new_inflight
            self._inflight_slots = self._slots_of(inflight)
        if inflight is not None:
            # stop() landed between dispatch and delivery: the flush is
            # computed, so deliver it
            self._deliver_flush(inflight)

    def _deliver_flush(self, flush: dict, extra_host_s: float = 0.0,
                       firsts: Optional[list] = None) -> None:
        """Deliver one k-tick flush: ONE fetch of the [B, k] tokens, the
        counts (and the [B, k] logprobs) with this pass's first tokens,
        then the budget/eos/retire bookkeeping over up to k tokens a slot.
        A slot whose request changed since dispatch (retired, cancelled,
        recycled) drops its whole column. The host length mirror advances
        by the device's count, so the host's table rows and lengths agree
        with the device at every flush boundary.

        The k tokens of a slot share one host observation: their trace
        events get timestamps interpolated over the flush (dispatch ->
        delivery, floored at the previous delivery) and val=1, after one
        ``loop_flush`` event (val: k); the ITL reservoir takes one gap per
        (slot, flush), the burst the client sees."""
        k = flush["k"]
        b = self.serving.slots
        firsts = firsts or []
        staged = flush.get("staged") or self._stage(
            self._flush_arrays(flush) + [f["tokens"] for f in firsts])
        toks, counts, *rest = self._collect(staged, ticks=k)
        toks = toks.reshape(b, k)
        lps = rest.pop(0).view(np.float32).reshape(b, k) if flush["logprobs"] is not None else None
        t0 = time.perf_counter()
        if firsts:
            self._deliver_firsts(firsts, fetched=rest)
        now = time.perf_counter()
        now_ns = time.monotonic_ns()
        start_ns = max(flush["t_disp_ns"], self._last_flush_ns)
        self.trace.record("loop_flush", -1, -1, k)
        eos = self.serving.eos_token
        for slot, req in enumerate(flush["reqs"]):
            if req is None or req is not self._slot_req[slot]:
                continue
            try:
                self._maybe_inject_dispatch()
                cnt = int(counts[slot])
                if cnt < k:
                    # froze inside the flush: budget wall or eos
                    self._stats["loop_early_exits"] += 1
                if cnt == 0:
                    continue
                emitted = [int(t) for t in toks[slot, :cnt]]
                self._slot_len[slot] += cnt
                self._slot_budget[slot] -= cnt
                span = max(now_ns - start_ns, 0)
                for j, tok in enumerate(emitted):
                    self.trace.record_at(start_ns + ((j + 1) * span) // cnt, "token", req.rid,
                                         slot, 1)
                    # the logprob goes in before the token (see _emit)
                    if lps is not None:
                        req.logprobs.append(float(lps[slot, j]))
                    req.delivered += 1
                    req.out.put(tok)
                self._stats["generated_tokens"] += cnt
                if self._track_history:
                    self._history[slot].extend(emitted)
                self._tokens[slot] = emitted[-1]
                self._note_itl(slot, now)
                if self._slot_budget[slot] <= 0 or emitted[-1] == eos:
                    self._retire(slot)
            except Exception:
                # one request's column dies with its slot; the rest go on
                self._contain_fault(slot)
        self._last_flush_ns = now_ns
        self._prof.note("deliver", time.perf_counter() - t0, ticks=k)
        self._note_host_ms(extra_host_s + time.perf_counter() - t0)

    def _loop_fused(self) -> None:
        """Fused speculation (``decode_loop_k`` > 1 with active
        ``spec_tokens``, the reference's ``_loop_fused``): draft and verify
        run inside the flush, so a flush is up to k verify ticks of up to
        K+1 tokens each against ONE fetch of the [B, k, K+1] tokens and
        [B, k] counts. Synchronous: the device drafts from a window the
        host uploads at each flush head from the slots' histories, which
        needs the previous flush delivered.

        At each flush head: the tick head (admission and retirement); the
        LoopPolicy's pick of this flush's depth from ``signals()``, clamped
        to [1, decode_loop_k] (a raising policy logs and takes the
        ceiling); and the cooloff gate: while the acceptance EMA sits
        below spec_min_mean the plain k-tick flush runs instead. On a card
        each depth replays its own graph, all captured at construction.
        While the watchdog's first rung holds, every flush has depth 1 (a
        one-token flush in cooloff)."""
        b = self.serving.slots
        chunk = self._spec_tokens + 1
        w = self._hist_window
        while not self._stop.is_set():
            admitted = self._tick_head()
            firsts, self._pending_firsts = self._pending_firsts, []
            active_slots = [i for i in range(b) if self._slot_req[i] is not None]
            if not active_slots:
                if firsts:
                    self._deliver_firsts(firsts)
                else:
                    self._idle_wait(admitted)
                continue
            t_disp = time.perf_counter()
            tokens = self._upload(self._tokens, torch.int32)
            active = self._upload([self._slot_req[i] is not None for i in range(b)], torch.bool)
            # the watchdog's ceiling, then the policy's pick within it
            k_cap = self._loop_cap
            k = k_cap
            if self._loop_policy is not None:
                try:
                    k = int(self._loop_policy.pick_k(k_cap, self.signals()))
                except Exception:
                    log.exception("loop_policy.pick_k raised; using k=%d", k_cap)
                    k = k_cap
                k = max(1, min(k, k_cap))
            if not self._spec_allowed():
                # cooloff: the plain k-tick flush, token-equal by contract
                flush = self._flush1 if k_cap == 1 else self._flush
                pred = [min(self._slot_budget[i], k_cap) if i in active_slots else 0
                        for i in range(b)]
                kv_bucket = self._kv_bucket(k_cap + max(self._slot_len[i] for i in active_slots))
                self._note_kv_window(kv_bucket, [self._slot_len[i] for i in active_slots],
                                     ticks=k_cap)
                out, self.state = flush(self.params, self.state, tokens, active,
                                        self._upload(pred, torch.int32), self._gens, kv_bucket)
                self._stats["decode_ticks"] += k_cap
                self._stats["loop_flushes"] += 1
                disp_s = time.perf_counter() - t_disp
                self._prof.note("dispatch", disp_s, ticks=k_cap)
                toks, counts, _, lps = out
                self._deliver_flush({"tokens": toks, "counts": counts, "logprobs": lps,
                                     "pred": pred, "k": k_cap, "t_disp_ns": time.monotonic_ns(),
                                     "reqs": [self._slot_req[i] if i in active_slots else None
                                              for i in range(b)]},
                                    extra_host_s=disp_s, firsts=firsts)
                continue
            # each live slot's recent tokens, right-aligned into [B, W]; the
            # device shifts accepted runs in as the flush goes
            hist = np.zeros((b, w), np.int32)
            hlen = np.zeros((b,), np.int32)
            for i in active_slots:
                h = self._history[i][-w:]
                if h:
                    hist[i, w - len(h):] = h
                    hlen[i] = len(h)
            cap = self._upload([max(self._slot_budget[i], 0) if i in active_slots else 0
                                for i in range(b)], torch.int32)
            # the window covers the deepest advance: k ticks of K+1 tokens
            kv_bucket = self._kv_bucket(k * chunk + max(self._slot_len[i] for i in active_slots))
            self._note_kv_window(kv_bucket, [self._slot_len[i] + k * chunk - 1
                                             for i in active_slots], t=chunk, ticks=k)
            (toks, counts, _), self.state = self._fused[k](
                self.params, self.state, tokens, active, cap, self._upload(hist, torch.int32),
                self._upload(hlen, torch.int32), self._gens, kv_bucket)
            self._stats["spec_ticks"] += k
            self._stats["loop_flushes"] += 1
            self._stats["fused_flushes"] += 1
            self._stats["fused_k_hist"][k] += 1
            disp_s = time.perf_counter() - t_disp
            self._prof.note("dispatch", disp_s, ticks=k)
            self._deliver_fused_flush({"tokens": toks, "counts": counts, "k": k,
                                       "t_disp_ns": time.monotonic_ns(),
                                       "reqs": [self._slot_req[i] if i in active_slots else None
                                                for i in range(b)]},
                                      extra_host_s=disp_s, firsts=firsts)

    def _deliver_fused_flush(self, flush: dict, extra_host_s: float = 0.0,
                             firsts: Optional[list] = None) -> None:
        """Deliver one fused flush: ONE fetch of the [B, kmax, K+1] tokens
        and [B, kmax] counts, then the spec path's bookkeeping with a
        variable advance: slot b emitted the sum of its counts. The host
        length mirror advances by that sum before the eos cut (as the
        synchronous verify tick does), a changed slot drops its whole
        column, and the acceptance accounting counts delivered tokens per
        (slot, inner tick); the cooloff EMA moves once a flush."""
        k = flush["k"]
        b = self.serving.slots
        kmax, t = self._loop_k, self._spec_tokens + 1
        firsts = firsts or []
        toks, counts, *rest = self._collect(self._stage(
            [flush["tokens"], flush["counts"]] + [f["tokens"] for f in firsts]), ticks=k)
        toks = toks.reshape(b, kmax, t)
        counts = counts.reshape(b, kmax)
        t0 = time.perf_counter()
        if firsts:
            self._deliver_firsts(firsts, fetched=rest)
        now = time.perf_counter()
        now_ns = time.monotonic_ns()
        start_ns = max(flush["t_disp_ns"], self._last_flush_ns)
        self.trace.record("loop_flush", -1, -1, k)
        eos = self.serving.eos_token
        hist_stats = self._stats["spec_emitted_hist"]
        emitted_total = participations = 0
        for slot, req in enumerate(flush["reqs"]):
            if req is None or req is not self._slot_req[slot]:
                continue
            try:
                self._maybe_inject_dispatch()
                per_tick = [[int(x) for x in toks[slot, i, :int(c)]]
                            for i, c in enumerate(counts[slot]) if int(c) > 0]
                if len(per_tick) < k:
                    # froze inside the flush: budget wall or eos
                    self._stats["loop_early_exits"] += 1
                if not per_tick:
                    continue
                emitted = [x for run in per_tick for x in run]
                self._slot_len[slot] += len(emitted)
                if eos in emitted:
                    emitted = emitted[:emitted.index(eos) + 1]
                left = len(emitted)
                for run in per_tick:
                    d = min(len(run), max(left, 0))
                    hist_stats[min(d, len(hist_stats) - 1)] += 1
                    left -= d
                participations += len(per_tick)
                emitted_total += len(emitted)
                span = max(now_ns - start_ns, 0)
                cnt = len(emitted)
                for j, tok in enumerate(emitted):
                    self.trace.record_at(start_ns + ((j + 1) * span) // cnt, "token", req.rid,
                                         slot, 1)
                    req.delivered += 1
                    req.out.put(tok)
                self._stats["generated_tokens"] += cnt
                self._slot_budget[slot] -= cnt
                self._history[slot].extend(emitted)
                self._tokens[slot] = emitted[-1]
                self._note_itl(slot, now)
                if self._slot_budget[slot] <= 0 or emitted[-1] == eos:
                    self._retire(slot)
            except Exception:
                self._contain_fault(slot)
        self._stats["spec_slot_ticks"] += participations
        self._stats["spec_emitted"] += emitted_total
        if participations:
            self._note_spec_ema(emitted_total, participations)
        self._last_flush_ns = now_ns
        self._prof.note("deliver", time.perf_counter() - t0, ticks=k)
        self._note_host_ms(extra_host_s + time.perf_counter() - t0)
