"""Continuous-batching serving engine over the dense transformer.

Counterpart of vtpu/serving/engine.py: a fixed pool of B cache slots
(dense ring or paged block pool), bucketed batched admission with the first
tokens sampled on the device, and the sampled decode tick with ONE
device->host fetch per tick, on one of the reference's two device-sampled
loops: the one-tick-deep pipelined loop (the default, as in the reference)
or the synchronous loop (``pipeline_decode=False``). On one CUDA card the
pipelined loop replays its decode step from CUDA graphs (serving/graphs.py).
Requests join and leave slots without any shape changing; inactive slots
compute but their writes are dropped. The request trace and the tick-phase
profiler (vtpu_torch/obs) record what the loop does, host-side only.

What the port has not reached raises instead of being ignored: every
``ServingConfig`` field named in ``_UNPORTED`` must stay at its default, and
``async_admission=False``, ``ModelConfig.kv_int8="auto"`` and a custom
``sample=`` callable are refused. Prefix registration is a later slice.
``kv_int8=True`` serves int8 KV: dense or paged int8 planes with f32 scale
planes beside them, written quantized at every KV write site here.
``mesh=`` (a vtpu_torch.parallel.TpMesh) serves tensor-parallel over
torch.distributed: see ``ServingEngine`` for how the ranks split the work.

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
"""

from __future__ import annotations

import collections
import dataclasses
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
    ModelConfig, Params, decode_layer_loop, kv_bytes_per_token, kv_keys, prefill, store_kv,
)
from vtpu_torch.obs import RequestTrace, TickProfiler, pct
from vtpu_torch.obs.trace import TERMINAL_CODES
from vtpu_torch.ops import _build
from vtpu_torch.ops.decode_attn import paged_attn_route
from vtpu_torch.serving.adapters import (
    TransformerSlotModel, batched_admission_step, sampled_decode_step,
)
from vtpu_torch.serving.graphs import DecodeGraphs

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The reference's serving knobs, field for field. Fields in
    ``_UNPORTED`` exist so a config carries over unchanged, and must stay
    at their defaults in this port until their slice lands. Ported beside
    these fields: int8 KV (``ModelConfig.kv_int8=True``) and
    tensor-parallel serving (``ServingEngine(..., mesh=)``), dense or
    paged, on either paged route."""

    slots: int = 4  # concurrent sequences (the decode batch)
    prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024)
    max_new_tokens: int = 64
    eos_token: int = -1  # -1: never stops early
    # bounded KV read window per tick: None (auto) and True bucket the
    # window to the longest live sequence; False reads max_seq every tick
    kv_read_buckets: Optional[bool] = None
    decode_unroll: Optional[bool] = None
    spec_tokens: int = 0
    spec_ngram: int = 3
    spec_min_mean: float = 1.25
    spec_cooloff_ticks: int = 64
    prefill_chunk: Optional[int] = None
    # on-device sampling: temperature 0 is greedy; otherwise Gumbel-max over
    # the temperature/top-k/top-p filtered logits, one generator per slot
    # seeded from sampling_seed
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    sampling_seed: int = 0
    logprobs: bool = False
    # None (auto) and True: the one-tick-deep pipelined loop (device sampling
    # is always on here and speculation is not ported); False: synchronous
    pipeline_decode: Optional[bool] = None
    # same-bucket prompts coalesce into one [N, bucket] admission dispatch,
    # N the largest size here that fits the free slots (1 always included)
    prefill_batch_sizes: tuple[int, ...] = (1, 2, 4, 8)
    # None/True: batched admission (the only admission path of this slice)
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
    kv_swap: Optional[int] = None
    kv_swap_stage_blocks: int = 8
    kv_swap_recompute_tokens: int = 0
    # request-trace ring capacity in events; 0 turns the ring off (the
    # latency percentiles in stats() stay live)
    trace_events: int = 16384
    disagg: Optional[Any] = None
    decode_loop_k: Optional[int] = None
    loop_policy: Optional[Any] = None
    shed_queue_depth: int = 0
    shed_policy: Optional[Any] = None
    fetch_watchdog_ms: float = 0.0
    fetch_watchdog_recover_ms: float = 0.0
    worker_retry_limit: int = 2
    worker_retry_backoff_ms: float = 10.0
    faults: Optional[Any] = None
    duty_supplier: Optional[Any] = None


# fields whose features are later slices of the port: a non-default value
# raises NotImplementedError naming the field
_UNPORTED = (
    "decode_unroll", "spec_tokens", "spec_ngram", "spec_min_mean",
    "spec_cooloff_ticks", "prefill_chunk", "logprobs", "kv_swap",
    "kv_swap_stage_blocks", "kv_swap_recompute_tokens", "disagg", "decode_loop_k",
    "loop_policy", "shed_queue_depth", "shed_policy", "fetch_watchdog_ms",
    "fetch_watchdog_recover_ms", "worker_retry_limit", "worker_retry_backoff_ms",
    "faults", "duty_supplier",
)


def _check_ported(serving: ServingConfig, cfg: ModelConfig, sample) -> None:
    """Refuse what this port has not reached. Every other combination is
    ported, under a tensor-parallel ``mesh`` as on one device: the mesh
    itself is checked by the adapter (``_validate_serving_mesh``)."""
    for f in dataclasses.fields(ServingConfig):
        if f.name in _UNPORTED and getattr(serving, f.name) != f.default:
            raise NotImplementedError(
                f"ServingConfig.{f.name}={getattr(serving, f.name)!r} is not "
                "ported to vtpu_torch yet; leave it at its default")
    if serving.async_admission is False:
        raise NotImplementedError(
            "ServingConfig.async_admission=False (the serial admission path) "
            "is not ported to vtpu_torch")
    if isinstance(getattr(cfg, "kv_int8", False), str):
        raise NotImplementedError(
            f"ModelConfig.kv_int8={cfg.kv_int8!r} is not ported to vtpu_torch: the "
            "reference resolves 'auto' with a router measured on a TPU (v5e), and "
            "an H100 router needs an H100 measurement; pass True or False")
    if sample is not None:
        raise NotImplementedError(
            "a custom sample= callable is not ported to vtpu_torch yet")


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
    tokens: Any  # [S] int32 numpy prompt
    max_new_tokens: int = 0
    rid: int = -1  # engine-unique id assigned by submit()
    t_submit_ns: int = 0
    t_depart_ns: int = 0  # left the waiting line (admitted)
    out: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    status: Optional[str] = None
    delivered: int = 0  # tokens put on the stream
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
    resolves it: None (auto) and True run the pipelined loop, since
    sampling is always on the device here and speculation is not ported;
    False runs the synchronous loop. On one CUDA card (no mesh) the
    pipelined loop replays the decode step from CUDA graphs captured when
    the engine is built, one per kv bucket (``decode_graphs``); under a
    mesh and on the CPU it runs the step eagerly.

    Tensor-parallel serving (``mesh``, a vtpu_torch.parallel.TpMesh) is a
    leader/worker split over torch.distributed, one process per rank.
    Rank 0 builds this engine (``params`` its shard, ``shard_params``) and
    is the leader: its threads, queues, allocator, sampling generators,
    admission buffer and logits exist on rank 0 only. Every other rank
    runs ``vtpu_torch.parallel.launch.serve_worker`` with its own shard, the
    same config and ServingConfig: the same adapter on its shard, following
    rank 0. Each adapter call of rank 0 (``init_state``,
    ``prefill_into_slots``, ``decode_step``) first broadcasts its op, its
    shapes and its tensor arguments, and with them rank 0's current page
    table and lengths, so the engine's direct state writes outside any
    adapter call (the reservation's ``state["table"][slot]`` and
    ``state["len"][slot]``) reach every rank before the step that reads
    them. Then every rank runs the same step on its head shard, with the
    all-reduces in the trunk. Over gloo that broadcast stages rank 0's
    device tensors through host memory, one device->host copy per call,
    which waits for the stream: the pipelined loop then overlaps nothing
    (it is not counted as a fetch). ``stop()`` sends the workers their
    stop."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 serving: ServingConfig = ServingConfig(), device=None, sample=None,
                 mesh=None):
        _check_ported(serving, cfg, sample)
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
        self.model = TransformerSlotModel(
            params, cfg, kv_page=serving.kv_page, kv_pool_blocks=serving.kv_pool_blocks,
            paged_attn=serving.paged_attn, device=self.device, mesh=mesh)
        self.params = self.model.params
        b = serving.slots
        self._page = serving.kv_page
        self._paged = self._page is not None
        self._paged_attn = serving.paged_attn
        self.state = self.model.init_state(b)
        # one sampling stream per slot (admission first tokens draw from the
        # admitted slot's stream too); greedy never touches them
        self._gens = [torch.Generator(device=self.device).manual_seed(
            serving.sampling_seed * 65537 + i) for i in range(b)]
        self._decode_sampled = sampled_decode_step(
            self.model, serving.temperature, serving.top_k, serving.top_p)
        self._admit_step = batched_admission_step(
            self.model, serving.temperature, serving.top_k, serving.top_p)
        # the reference's resolution (engine.py: pipelining needs device
        # sampling, always on here, and no speculation, not ported): auto
        # (None) pipelines, an explicit True is served, False is synchronous
        pipeline = serving.pipeline_decode
        self._pipeline = True if pipeline is None else bool(pipeline)
        self._admit_sizes = tuple(sorted(
            {n for n in serving.prefill_batch_sizes if 1 <= n <= b} | {1}))
        # [B] device buffer of admission first tokens not yet fed to a tick,
        # plus the host mask of which slots hold one
        self._admit_buf = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self._admit_mask = [False] * b
        ctx = cfg.max_seq
        self._kv_buckets = tuple(sorted({min(bkt, ctx) for bkt in serving.prefill_buckets}
                                        | {ctx}))
        self._use_kv_buckets = serving.kv_read_buckets is not False
        self._prefill_buckets = tuple(bkt for bkt in serving.prefill_buckets if bkt <= ctx)
        if not self._prefill_buckets:
            raise ValueError(f"no prefill bucket fits max_seq={ctx}: "
                             f"{serving.prefill_buckets}")
        if serving.prefill_budget and serving.prefill_budget < max(self._prefill_buckets):
            raise ValueError(
                f"prefill_budget {serving.prefill_budget} is below the largest "
                f"admission unit {max(self._prefill_buckets)} (largest bucket)")
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
        self._slot_blocks: list[list[int]] = [[] for _ in range(b)]
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
            # blocking per-admission syncs: none on the batched admission
            # path, the only one ported
            "admission_syncs": 0,
            "prefill_batch_hist": [0] * (max(self._admit_sizes) + 1),
            # decode ticks dispatched while the previous tick was in flight
            "pipelined_ticks": 0,
            "kv_bucket_hist": {},
            "paged_attn_kernel_ticks": 0, "paged_attn_gather_ticks": 0,
            "pool_blocked_admissions": 0,
        }
        # host-side observability (vtpu_torch/obs): the request-lifecycle
        # ring with the ITL/TTFT/queue-wait reservoirs, and the tick-phase
        # profiler that attributes host_ms_per_tick. Nothing here can add a
        # device sync. _itl_last[slot]: when the slot's last token was
        # delivered (None until its first token, whose gap is TTFT)
        self.trace = RequestTrace(capacity=serving.trace_events)
        self._prof = TickProfiler()
        self._itl_last: list[Optional[float]] = [None] * b
        self._host_ms_ema: Optional[float] = None
        self._admission_ms_ema: Optional[float] = None
        self._req_ctr = itertools.count()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # an exception that ended the loop (its streams were ended CANCELLED)
        self.loop_error: Optional[BaseException] = None
        self.decode_graphs: Optional[DecodeGraphs] = None
        if self.device.type == "cuda":
            # build the kernels now, not at their first use inside the loop
            _build.build_all()
            if self._pipeline and mesh is None:
                self.decode_graphs = DecodeGraphs(
                    self._decode_sampled, self.params, self.state, self._gens,
                    self._kv_buckets if self._use_kv_buckets else (0,),
                    paged_attn=self._paged_attn, sampled=serving.temperature > 0.0)
        # the decode step both loops dispatch: graph replays or the eager step
        self._step = self.decode_graphs or self._decode_sampled

    # ------------------------------------------------------------------ API

    def submit(self, tokens, max_new_tokens: int = 0) -> Request:
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is stopped")
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n = int(tokens.shape[0])
        if n == 0:
            raise ValueError("empty prompt (prefix registration is not ported)")
        self._bucket(n)  # oversized prompts raise to the submitter
        budget = max_new_tokens or self.serving.max_new_tokens
        if self._paged:
            need = -(-max(n + min(budget, max(self.cfg.max_seq - n, 0)), 1) // self._page)
            if need > self._n_blocks - 1:
                raise ValueError(
                    f"request needs {need} KV blocks at worst case but the pool "
                    f"only has {self._n_blocks - 1}; raise kv_pool_blocks or "
                    "lower max_new_tokens")
        req = Request(tokens=tokens, max_new_tokens=budget)
        req.rid = next(self._req_ctr)
        req.t_submit_ns = time.monotonic_ns()
        self.trace.record("submit", req.rid, -1, n)
        self._pending.put(req)
        self._wake.set()
        if self._stop.is_set():
            # raced with stop(): an extra terminal is harmless, a missing one
            # hangs the client
            self._end_stream(req, Status.CANCELLED)
        return req

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

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
        ticks = s["decode_ticks"]
        s["device_gets_per_tick"] = round(s["tick_fetches"] / ticks, 4) if ticks else None
        s["bytes_fetched_per_tick"] = round(s["bytes_fetched"] / ticks, 1) if ticks else None
        # host ms per tick (EMA of dispatch + delivery host work) and per
        # tick head (admission), as the reference reports them
        s["host_ms_per_tick"] = (round(self._host_ms_ema, 4)
                                 if self._host_ms_ema is not None else None)
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
        # deliver (swap_drain stays empty: the port has no swap tier)
        s["tick_phase_ms"] = self._prof.snapshot()
        s["device_sampling"] = True
        s["pipelined"] = self._pipeline
        s["batched_admission"] = True
        s["active_slots"] = sum(r is not None for r in self._slot_req)
        s["queued"] = self._pending.qsize() + len(self._waiting)
        s["paged"] = self._paged
        s["kv_page"] = self._page
        # under a mesh every rank holds n_heads / tp heads of the cache or
        # pool, so the bytes a card holds (what a per-card memory cap is
        # sized against) are the global bytes / tp; one device: the same
        tp = 1 if self.mesh is None else self.mesh.size
        s["tp"] = tp
        bpt = kv_bytes_per_token(self.cfg)
        s["kv_hbm_bytes"] = {
            "dense": self.serving.slots * self.cfg.max_seq * bpt // tp,
            "paged": self._n_blocks * self._page * bpt // tp if self._paged else None,
        }
        s["kv_hbm_bytes_per_chip"] = dict(s["kv_hbm_bytes"])
        if self._paged:
            usable = self._n_blocks - 1
            free = self._alloc.free_blocks
            s["kv_pool_blocks"] = usable
            s["kv_pool_free"] = free
            s["kv_pool_used"] = usable - free
            s["kv_pool_used_hwm"] = self._alloc.used_hwm
        else:
            s["kv_pool_blocks"] = s["kv_pool_free"] = None
            s["kv_pool_used"] = s["kv_pool_used_hwm"] = None
        # process-wide kernel launch counts (the wrappers' counters; a graph
        # replay adds the launches its capture recorded)
        s["flash_launches"] = _build.LAUNCHES["flash_attention"]
        s["paged_attn_launches"] = _build.LAUNCHES["paged_decode_attention"]
        s["paged_attn_int8kv_launches"] = _build.LAUNCHES["paged_decode_attention_int8kv"]
        s["decode_attn_launches"] = _build.LAUNCHES["decode_attention"]
        s["decode_attn_int8kv_launches"] = _build.LAUNCHES["decode_attention_int8kv"]
        s["paged_attn_tp_launches"] = _build.LAUNCHES["paged_decode_attention_tp"]
        s["paged_attn_int8kv_tp_launches"] = _build.LAUNCHES["paged_decode_attention_int8kv_tp"]
        return s

    # ----------------------------------------------------------- lifecycle

    def _end_stream(self, req: Request, status: str, slot: int = -1) -> None:
        """Deliver *req*'s typed terminal exactly once, with one trace
        retire carrying the terminal code."""
        if req.finish(status):
            self.trace.record("retire", req.rid, slot, TERMINAL_CODES.get(status, 0))

    def _drain_all(self) -> None:
        """Terminal for everyone still holding a Request: occupied slots
        (CANCELLED — the engine abandoned them), waiters and submissions."""
        for slot in range(len(self._slot_req)):
            self._retire(slot, status=Status.CANCELLED)
        for req in self._waiting:
            self._end_stream(req, req._abort or Status.CANCELLED)
        self._waiting.clear()
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            self._end_stream(req, req._abort or Status.CANCELLED)

    def _retire(self, slot: int, status: Optional[str] = None) -> None:
        req = self._slot_req[slot]
        if req is not None:
            self._end_stream(req, status or req._abort or Status.OK, slot)
        self._slot_req[slot] = None
        self._slot_budget[slot] = 0
        self._slot_len[slot] = 0
        self._itl_last[slot] = None
        self._admit_mask[slot] = False
        # the device table row stays stale: inactive reads are masked and
        # writes are dropped, and the next reservation overwrites it
        self._free_slot_blocks(slot)

    def _free_slot_blocks(self, slot: int) -> None:
        if self._paged and self._slot_blocks[slot]:
            self._alloc.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []

    # ----------------------------------------------------------- admission

    def _bucket(self, n: int) -> int:
        """Smallest prefill bucket covering *n*; raises past the largest."""
        for bkt in self._prefill_buckets:
            if n <= bkt:
                return bkt
        raise ValueError(f"prompt length {n} exceeds the largest usable bucket "
                         f"{self._prefill_buckets[-1]}")

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
        """Map every page this request can touch (prompt + its token budget)
        and set the slot's device table row. False with nothing reserved
        when the free list can't cover it: the request stays waiting and a
        later retire unblocks it (backpressure, never an error)."""
        n = int(req.tokens.shape[0])
        budget = min(req.max_new_tokens, self.cfg.max_seq - n)
        need = -(-max(n + max(budget, 0), 1) // self._page)
        blocks = self._alloc.alloc(need)
        if blocks is None:
            self._stats["pool_blocked_admissions"] += 1
            return False
        self._slot_blocks[slot] = blocks
        row = np.zeros((self._max_pages,), np.int32)
        row[:len(blocks)] = blocks
        self.state["table"][slot] = self._upload(row, torch.int32)
        self.state["len"][slot] = 0
        return True

    def _admit_waiting(self, budget: float) -> tuple[bool, float]:
        """Fill free slots from the waiting line under the per-tick prompt
        budget. FIFO at the head; same-bucket prompts coalesce from anywhere
        in the line into one [N, bucket] dispatch, N the largest admission
        size that fits. Nothing younger jumps a head blocked on budget or
        pool. Returns (any admission happened, remaining budget)."""
        admitted = False
        free = [i for i in range(self.serving.slots) if self._slot_req[i] is None]
        while self._waiting and free:
            head = self._waiting.head()
            if head.cancelled:
                self._waiting.popleft()
                self._end_stream(head, head._abort or Status.CANCELLED)
                continue
            bucket = self._bucket(int(head.tokens.shape[0]))
            cap = min(len(free), max(self._admit_sizes))
            group = [head]
            for req in self._waiting:
                if len(group) >= cap:
                    break
                if (req is not head and not req.cancelled
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
        self._slot_budget[slot] = min(req.max_new_tokens, self.cfg.max_seq - n) - 1
        self._slot_len[slot] = n
        self._itl_last[slot] = None
        self._stats["admissions"] += 1
        self._note_admit(req, slot, n)

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

    def _collect(self, staged: dict) -> list[np.ndarray]:
        """The loop's ONLY device->host read: wait for a staged copy and
        split it. Counted so stats() can show device_gets_per_tick == 1.0;
        the wait is the tick's fetch phase (on the pipelined loop, the time
        the host waits for the tick in flight)."""
        self._stats["device_gets"] += 1
        self._stats["tick_fetches" if staged["kind"] == "tick" else "admission_fetches"] += 1
        t0 = time.perf_counter()
        if staged["done"] is not None:
            staged["done"].synchronize()
        flat = staged["host"].numpy()
        self._prof.note("fetch", time.perf_counter() - t0)
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
        self._itl_last[slot] = time.perf_counter()
        self._note_first_token(req, slot)
        req.delivered += 1
        req.out.put(tok)
        self._stats["generated_tokens"] += 1
        if self._slot_budget[slot] <= 0 or tok == self.serving.eos_token:
            self._retire(slot)

    def _deliver(self, tick: dict, extra_host_s: float = 0.0,
                 firsts: Optional[list] = None) -> None:
        """One fetch for the tick's tokens and this pass's first tokens
        (staged by the loop, or here), then host bookkeeping.
        ``extra_host_s`` is the pass's dispatch-side host time, folded into
        the same host_ms_per_tick sample. ``tick["reqs"]`` snapshots each
        slot's request at dispatch; a slot whose occupant changed since
        (retired, cancelled or recycled) drops its token: that is what makes
        the pipelined loop's one-tick lookahead safe."""
        firsts = firsts or []
        staged = tick.get("staged") or self._stage(
            [tick["tokens"]] + [f["tokens"] for f in firsts])
        toks, *first_arrs = self._collect(staged)
        t0 = time.perf_counter()
        if firsts:
            self._deliver_firsts(firsts, fetched=first_arrs)
        now = time.perf_counter()
        for slot, req in enumerate(tick["reqs"]):
            if req is None or req is not self._slot_req[slot]:
                continue
            self._emit(slot, int(toks[slot]), now)
        self._prof.note("deliver", time.perf_counter() - t0)
        self._note_host_ms(extra_host_s + time.perf_counter() - t0)

    def _emit(self, slot: int, tok: int, now: Optional[float] = None) -> None:
        req = self._slot_req[slot]
        self._tokens[slot] = tok
        self._slot_len[slot] += 1  # the device length advanced at dispatch
        self._note_itl(slot, now if now is not None else time.perf_counter())
        self.trace.record("token", req.rid, slot)
        req.delivered += 1
        req.out.put(tok)
        self._stats["generated_tokens"] += 1
        self._slot_budget[slot] -= 1
        if self._slot_budget[slot] <= 0 or tok == self.serving.eos_token:
            self._retire(slot)

    def _note_kv_window(self, kv_bucket: int) -> None:
        key = int(kv_bucket) or self.cfg.max_seq
        hist = self._stats["kv_bucket_hist"]
        hist[key] = hist.get(key, 0) + 1
        if self._paged:
            # the trunk resolves the route from the same inputs
            route = paged_attn_route(self._paged_attn, key, self.device)
            self._stats["paged_attn_kernel_ticks" if route == "kernel"
                        else "paged_attn_gather_ticks"] += 1

    def _kv_bucket(self, need: int) -> int:
        """The read window of a tick whose longest row needs ``need`` keys:
        the smallest kv bucket covering it (0 = max_seq with buckets off)."""
        if not self._use_kv_buckets:
            return 0
        return next((bkt for bkt in self._kv_buckets if bkt >= need), self.cfg.max_seq)

    # ---------------------------------------------------------------- loop

    def _loop(self) -> None:
        try:
            if self._pipeline:
                self._loop_pipelined()
            else:
                self._loop_sync()
        except Exception as exc:  # the loop thread's boundary: report, end streams
            self.loop_error = exc
            log.exception("serving loop failed; ending every stream")
        finally:
            self._drain_all()

    def _tick_head(self) -> bool:
        """Drain submissions into the waiting line, admit into free slots
        under the prompt budget (bypassed while nothing decodes), retire
        cancelled slots. Returns whether anything was admitted."""
        t0 = time.perf_counter()
        while True:
            try:
                self._waiting.append(self._pending.get_nowait())
            except queue.Empty:
                break
        decoding = any(r is not None for r in self._slot_req)
        budget = (float(self.serving.prefill_budget)
                  if self.serving.prefill_budget and decoding else float("inf"))
        admitted, _ = self._admit_waiting(budget)
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.cancelled:
                self._retire(slot)
        dt = time.perf_counter() - t0
        self._note_admission_ms(dt)
        self._prof.note("admission", dt)
        return admitted

    def _idle_wait(self, admitted: bool) -> None:
        if admitted:
            return
        if self._wake.wait(timeout=0.05):
            self._wake.clear()

    def _loop_sync(self) -> None:
        """Synchronous tick loop: tick head, one decode dispatch, one fetch,
        delivery, repeat. Still one device->host read per tick; only the
        overlap of the pipelined loop is missing."""
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
            kv_bucket = self._kv_bucket(1 + max(self._slot_len[i] for i in active_slots))
            self._note_kv_window(kv_bucket)
            tok_d, self.state = self._step(
                self.params, self.state, tokens, active, self._gens, kv_bucket)
            self._stats["decode_ticks"] += 1
            tick = {"tokens": tok_d, "reqs": list(self._slot_req),
                    "staged": self._stage([tok_d] + [f["tokens"] for f in firsts])}
            disp_s = time.perf_counter() - t_disp
            self._prof.note("dispatch", disp_s)
            self._deliver(tick, extra_host_s=disp_s, firsts=firsts)

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
            dispatch = [i for i in range(b) if self._slot_req[i] is not None
                        and self._slot_budget[i] - (1 if fed[i] else 0) > 0]
            staged_firsts = None
            if inflight is not None:
                inflight["staged"] = self._stage(
                    [inflight["tokens"]] + [f["tokens"] for f in firsts])
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
                kv_bucket = self._kv_bucket(
                    1 + max(self._slot_len[i] + (1 if fed[i] else 0) for i in dispatch))
                self._note_kv_window(kv_bucket)
                tok_d, self.state = self._step(
                    self.params, self.state, tokens, active, self._gens, kv_bucket)
                self._stats["decode_ticks"] += 1
                if inflight is not None:
                    self._stats["pipelined_ticks"] += 1
                new_inflight = {"tokens": tok_d,
                                "reqs": [self._slot_req[i] if i in live else None
                                         for i in range(b)]}
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
        if inflight is not None:
            # stop() landed between dispatch and delivery: the tick's tokens
            # are computed, so deliver them (and device_gets stays equal to
            # decode_ticks)
            self._deliver(inflight)
