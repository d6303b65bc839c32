"""Disaggregated prefill/decode: prefill workers beside the decode loop over
the shared block pool (counterpart of vtpu/serving/disagg.py).

The co-scheduled loop runs admission prefill and decode on one thread, so a
burst of new sessions and the live streams compete for the same tick, and
admission waits for a free decode slot although prefill needs none. With
``ServingConfig(disagg=DisaggConfig(...))`` the roles split:

- ``PrefillWorker`` threads claim the oldest waiting request with its page
  reservation and chunk-prefill it into fresh pool blocks with no slot (the
  prefix build's discipline: ``chunked_prefill_into_slot`` with explicit
  ``block_ids`` and the slot count as the slot, so no length is written).
  The first token is sampled from the final chunk's logits and delivered to
  the client by the worker, without waiting for a slot. The filled blocks
  and that token form a handoff entry, shaped as an overcommit parked entry.
- The decode loop installs handoffs at its tick heads: one table-row and
  length write maps the filled blocks into a free slot (the resume remap),
  and the session goes on through the loop's one-fetch tick. No KV byte
  moves: ``handoff_copies == 0``. Worker fetches are counted as admission
  fetches, so ``device_gets_per_tick`` stays a decode-side figure.
- ``DisaggController`` partitions prefill against decode: a token bucket
  the loop refills once a decode tick with a share that steps between a
  floor, a midpoint and a ceiling with the backlog, bypassed while nothing
  decodes. Level changes count as ``repartitions``.

Pool ownership: a worker's fresh private blocks are refcount 1 and in no
parked entry, so eviction (which reclaims parked sessions' private pages
only) never touches them; shared prefix blocks are mapped with ``share()``
and never evicted. A worker never evicts: on a dry free list it posts the
blocks it needs, and the loop thread, which owns the parked sessions,
reclaims them at its next tick head.

Device order (the port's own; the reference chains every worker dispatch
after the loop's through its donated state). The state's tensors are
written in place, so on a card the order comes from the streams. Each
worker prefills on a CUDA stream of its own, while the loop replays its
graphs on the stream its thread runs on:
- blocks the loop released (a retired slot whose next tick was already
  dispatched, an eviction whose staging gather snapshots them) may still
  be written or read by work enqueued on the loop's stream; so before its
  first write into a reservation (the copy-on-write block or the first
  chunk) the worker's stream waits for the loop's stream. The host tier's
  copies read the gather's snapshot, never the pool;
- blocks a worker wrote reach the loop only through a handoff, pushed after
  the worker's first-token fetch, which waits on an event recorded on its
  stream behind every chunk; a cancelled or failed claim waits the same
  way before its blocks go back to the allocator, and a dead worker's
  blocks are released by the loop only after the loop's stream waits for
  the worker's;
- a prefix's stored logits (made on the loop's stream) are sampled on the
  worker's stream behind the same wait, and ``record_stream`` keeps their
  memory from reuse until that read is done; nothing the worker allocates
  rides a handoff entry to the loop.
The worker's fetch is an event wait (``cudaEventSynchronize``), which
``torch.cuda.set_sync_debug_mode`` does not flag, so a sync guard around
the loop's dispatch never catches it. Sampling draws from a per-worker
``torch.Generator`` seeded ``sampling_seed + 101 + worker id``: only greedy
streams are comparable with the reference.

Under a tensor-parallel mesh the workers run on rank 0: a worker's chunk
and its reservation's copy-on-write are the adapter's chunk and copy ops,
which every other rank runs on its one stream in the order the adapter's
lock gave them, so the fences above stay rank 0's and the other ranks need
none; a handoff install writes only a table row and a length, which reach
them with the next op.

``ServingConfig.disagg = None`` keeps all of this dormant: no worker
threads, and the loop is the co-scheduled one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from vtpu_torch.models.transformer import sample_tokens
from vtpu_torch.obs.trace import TERMINAL_CODES
from vtpu_torch.serving.faults import WorkerDeath

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Prefill/decode disaggregation knobs (``ServingConfig.disagg``).

    The partition is in prompt tokens per decode tick, the unit of
    ``prefill_budget``, and dynamic: the controller steps the share between
    ``min_prefill_tokens`` (steady decode, a backlog of 0 or 1) and
    ``max_prefill_tokens`` (a backlog at or past ``backlog_high``), the
    midpoint between. Greedy streams equal the co-scheduled engine's; at
    ``temperature > 0`` first tokens draw from per-worker generators, and
    with ``prefill_workers > 1`` claim order is a thread race, so seeded
    sampling does not reproduce across modes."""

    # prefill worker threads draining the waiting line
    prefill_workers: int = 1
    # the share's floor: prompt tokens a decode tick while the backlog is
    # empty-ish and slots decode
    min_prefill_tokens: int = 64
    # the share's ceiling under a burst backlog
    max_prefill_tokens: int = 1024
    # backlog (queued + claimed + ready) at which the ceiling applies
    backlog_high: int = 4
    # the allowance's cap, in ticks of the current share
    burst_ticks: int = 2

    def validate(self) -> None:
        if not 1 <= self.prefill_workers <= 8:
            raise ValueError(f"prefill_workers must be in 1..8, got {self.prefill_workers}")
        if not 0 < self.min_prefill_tokens <= self.max_prefill_tokens:
            raise ValueError(
                "need 0 < min_prefill_tokens <= max_prefill_tokens, got "
                f"{self.min_prefill_tokens}/{self.max_prefill_tokens}")
        if self.backlog_high < 1 or self.burst_ticks < 1:
            raise ValueError("backlog_high and burst_ticks must be >= 1")


class DisaggController:
    """The capacity partition: a token bucket the decode loop refills once a
    tick with the current share (floor / mid / ceiling by backlog).
    Workers ``acquire()`` a chunk's tokens before each chunk; while nothing
    decodes the bucket is bypassed, as ``prefill_budget`` is."""

    def __init__(self, cfg: DisaggConfig, chunk: int):
        self.cfg = cfg
        self._chunk = int(chunk)
        self._cv = threading.Condition()
        self._level = "floor"
        self._share = cfg.min_prefill_tokens
        self._allowance = 0.0
        self.repartitions = 0

    def _target(self, backlog: int) -> tuple[str, int]:
        c = self.cfg
        if backlog >= c.backlog_high:
            return "ceiling", c.max_prefill_tokens
        if backlog > 1:
            return "mid", (c.min_prefill_tokens + c.max_prefill_tokens) // 2
        return "floor", c.min_prefill_tokens

    @property
    def prefill_share(self) -> int:
        return self._share

    @property
    def level(self) -> str:
        return self._level

    def on_tick(self, backlog: int) -> None:
        """One decode tick elapsed: re-evaluate the level against the
        backlog and refill the allowance with the share."""
        with self._cv:
            level, share = self._target(backlog)
            if level != self._level:
                self._level = level
                self.repartitions += 1
            self._share = share
            cap = max(float(self._chunk), self.cfg.burst_ticks * float(share))
            self._allowance = min(self._allowance + share, cap)
            self._cv.notify_all()

    def acquire(self, tokens: int, idle, stop) -> bool:
        """Block until ``tokens`` of allowance are there, ``idle()`` (the
        bypass, no debit) or ``stop()``. False only on stop."""
        with self._cv:
            while True:
                if stop():
                    return False
                if idle():
                    return True
                if self._allowance >= tokens:
                    self._allowance -= tokens
                    return True
                # bounded: idle and stop have no notifier
                self._cv.wait(0.02)


class DisaggRuntime:
    """What the engine holds with disaggregation on: the controller, the
    workers, the claimed set (requests a worker holds mid-prefill), the
    ready queue of handoffs awaiting a slot, and the worker-side counters
    ``stats()`` merges. Workers and the loop meet only through these."""

    def __init__(self, engine, cfg: DisaggConfig):
        cfg.validate()
        self.engine = engine
        self.cfg = cfg
        self.controller = DisaggController(cfg, engine._chunk)
        # set by the loop thread once it runs (its graphs were captured at
        # construction): no worker touches the device before
        self.started = threading.Event()
        self._ready: "collections.deque[dict]" = collections.deque()
        self._claimed: set = set()
        self._mu = threading.Lock()  # claimed, ready, counters, need_blocks
        # serializes head peek -> reserve -> take across workers, so two
        # never reserve for the same head
        self.claim_mu = threading.Lock()
        self._work_cv = threading.Condition(self._mu)
        self._need_blocks = 0
        self.counters = {
            "handoffs": 0,
            # device copies the handoff path made: 0 by construction (a
            # prefix boundary copy counts as prefix_cow_copies)
            "handoff_copies": 0,
            "prefill_chunks": 0,
            "first_tokens": 0,
            "fetches": 0,
            "bytes_fetched": 0,
            "prefix_blocks_shared": 0,
            "prefix_cow_copies": 0,
            "pool_blocked_prefills": 0,
            # sessions served whole on the worker (budget 1 or eos first):
            # merged into stats()["admissions"]
            "worker_retired": 0,
            # merged into the engine's totals of the same names
            "shed_deadline": 0,
            "faulted_requests": 0,
        }
        # requests waiting out a re-queue backoff after their worker died
        # ([(eligible monotonic_ns, request)], loop thread only); the death
        # count rides on the request
        self._retry: list = []
        self.workers = [PrefillWorker(self, i) for i in range(cfg.prefill_workers)]

    def start(self) -> None:
        for w in self.workers:
            w.start()

    def join(self, timeout: float = 5.0) -> None:
        deadline = time.perf_counter() + timeout
        for w in self.workers:
            if w.ident is not None:
                w.join(max(deadline - time.perf_counter(), 0.1))

    # -------------------------------------------------------- shared state

    def bump(self, key: str, n: int = 1) -> None:
        with self._mu:
            self.counters[key] += n

    def counters_snapshot(self) -> dict:
        with self._mu:
            return dict(self.counters)

    def claim_request(self, req) -> None:
        with self._mu:
            self._claimed.add(req)

    def unclaim(self, req) -> None:
        with self._mu:
            self._claimed.discard(req)

    def push_ready(self, entry: dict) -> None:
        """The handoff becomes visible to the loop before the claim drops,
        so ``owns()`` has no gap a park could fall through."""
        with self._mu:
            self._ready.append(entry)
            self._claimed.discard(entry["req"])

    def pop_ready(self) -> Optional[dict]:
        with self._mu:
            return self._ready.popleft() if self._ready else None

    def owns(self, req) -> bool:
        """Is ``req`` mid-prefill or awaiting install? A park of such a
        request waits until it reaches a slot."""
        with self._mu:
            return req in self._claimed or any(e["req"] is req for e in self._ready)

    def owned(self) -> int:
        """Claimed plus ready: requests that left the waiting line and are
        not in a slot yet (``stats()`` adds them to ``queued``)."""
        with self._mu:
            return len(self._claimed) + len(self._ready)

    def backlog(self) -> int:
        """Waiting + claimed + ready: the controller's load signal and
        ``stats()["prefill_backlog"]``."""
        return len(self.engine._waiting) + self.owned()

    def request_blocks(self, n: int) -> None:
        """A worker's allocator miss: post the count for the loop thread to
        reclaim at its next tick head."""
        with self._mu:
            self._need_blocks = max(self._need_blocks, n)
        self.engine._wake.set()

    def take_needed_blocks(self) -> int:
        with self._mu:
            n, self._need_blocks = self._need_blocks, 0
            return n

    def notify_work(self) -> None:
        with self._work_cv:
            self._work_cv.notify_all()

    def wait_work(self, timeout: float) -> None:
        with self._work_cv:
            self._work_cv.wait(timeout)

    def on_tick(self) -> None:
        self.controller.on_tick(self.backlog())

    # --------------------------------------------- worker crash recovery

    def watch(self) -> None:
        """The loop thread's supervisor, every tick head. A worker that died
        (its thread exited without cleanup) loses exactly its claim: the
        reservation is released, the request re-queued with exponential
        backoff up to ``worker_retry_limit`` deaths and FAULTED after, or
        FAULTED at once if the worker had delivered its first token (a
        re-prefill would replay it), and the worker restarts. Retry
        entries whose backoff elapsed go back to the waiting line."""
        from vtpu_torch.serving.engine import Status

        eng = self.engine
        now = time.monotonic_ns()
        for i, w in enumerate(self.workers):
            # a worker that has not started yet is pending, not dead
            if w.ident is None or w.is_alive() or eng._stop.is_set():
                continue
            cur, w.current = w.current, None
            eng._stats["worker_restarts"] += 1
            eng.trace.record("worker_restart", cur["req"].rid if cur is not None else -1, i)
            log.warning("prefill worker %d died%s; restarting", i,
                        f" holding request {cur['req'].rid}" if cur is not None else "")
            if cur is not None:
                req, res = cur["req"], cur["res"]
                with self._mu:
                    in_ready = any(e["req"] is req for e in self._ready)
                handed_off = req.status is not None or req in eng._slot_req or in_ready
                blocks = res["shared"] + res["priv"]
                if blocks:
                    if w.stream is not None:
                        # the dead worker's writes into them come first
                        torch.cuda.current_stream(eng.device).wait_stream(w.stream)
                    eng._alloc.release(blocks)
                res["shared"], res["priv"] = [], []
                self.unclaim(req)
                if handed_off:
                    pass  # the handoff outlives its worker
                elif req.cancelled:
                    eng._end_stream(req, req._abort or Status.CANCELLED)
                else:
                    req._worker_deaths = getattr(req, "_worker_deaths", 0) + 1
                    if cur["delivered"] or req._worker_deaths > eng.serving.worker_retry_limit:
                        eng._stats["faulted_requests"] += 1
                        eng.trace.record("fault", req.rid, -1)
                        eng._end_stream(req, Status.FAULTED)
                    else:
                        backoff = int(eng.serving.worker_retry_backoff_ms * 1e6) * (
                            2 ** (req._worker_deaths - 1))
                        self._retry.append((now + backoff, req))
            # the restart keeps the dead worker's stream
            self.workers[i] = PrefillWorker(self, w.wid, stream=w.stream)
            self.workers[i].start()
        if self._retry and not eng._stop.is_set():
            due = [r for t, r in self._retry if t <= now]
            self._retry = [(t, r) for t, r in self._retry if t > now]
            for req in due:
                if req.cancelled:
                    eng._end_stream(req, req._abort or Status.CANCELLED)
                    continue
                eng._waiting.append(req)
            if due:
                self.notify_work()

    def drain(self) -> None:
        """Shutdown sweep (loop thread, workers joined): release every ready
        entry's blocks and end its stream (its first token was delivered,
        so it counts as an admission); end the claimed and retrying
        requests (a claim of a worker abandoned mid-join keeps its blocks,
        which die with the engine)."""
        from vtpu_torch.serving.engine import Status

        eng = self.engine
        while True:
            e = self.pop_ready()
            if e is None:
                break
            blocks = e["shared"] + e["priv"]
            if blocks:
                eng._alloc.release(blocks)
            eng._stats["admissions"] += 1
            eng._end_stream(e["req"], e["req"]._abort or Status.CANCELLED)
        with self._mu:
            leftover = list(self._claimed)
            self._claimed.clear()
            retry = [r for _, r in self._retry]
            self._retry = []
        for req in leftover + retry:
            eng._end_stream(req, req._abort or Status.CANCELLED)


class PrefillWorker(threading.Thread):
    """A prefill engine on a thread (and, on a card, a CUDA stream) of its
    own: claims the oldest waiting request with its pages, chunk-prefills
    it with no slot, samples and delivers the first token, and hands the
    loop the filled entry."""

    def __init__(self, rt: DisaggRuntime, wid: int, stream=None):
        super().__init__(daemon=True, name=f"vtpu-prefill-{wid}")
        self.rt = rt
        self.wid = wid
        eng = rt.engine
        # {"req", "res", "delivered"} while a claim is held, for the
        # supervisor: a WorkerDeath leaves it set on purpose
        self.current: Optional[dict] = None
        if stream is None and eng.device.type == "cuda":
            stream = torch.cuda.Stream(eng.device)
        self.stream = stream
        # the worker's own sampling stream (the slots' generators are the
        # loop thread's)
        self._gen = torch.Generator(device=eng.device).manual_seed(
            eng.serving.sampling_seed + 101 + wid)

    # ------------------------------------------------------------ thread

    def run(self) -> None:
        eng = self.rt.engine
        while not self.rt.started.wait(0.1):
            if eng._stop.is_set():
                return
        # the current stream is per thread: entered here, not at construction
        with (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext()):
            while not eng._stop.is_set():
                try:
                    claim = self._claim()
                except Exception:
                    # a failed claim must not kill the thread (one worker
                    # would wedge all admission); the reserve rolled back
                    log.exception("prefill worker %d claim failed", self.wid)
                    claim = None
                if claim is None:
                    # submit() and every tick head with a waiting line notify
                    self.rt.wait_work(0.05)
                    continue
                req, res = claim
                self.current = {"req": req, "res": res, "delivered": False}
                try:
                    self._prefill_one(req, res)
                    self.current = None
                except WorkerDeath:
                    # injected crash: the claim, its blocks and ``current``
                    # stay as they are, for the supervisor
                    return
                except Exception:
                    log.exception("prefill worker %d failed on request %s", self.wid, req.rid)
                    # contained to this request: FAULTED, blocks released
                    self.rt.bump("faulted_requests")
                    eng.trace.record("fault", req.rid, -1)
                    self._release_all(req, res, status="FAULTED")
                    self.current = None

    # ------------------------------------------------------------- claim

    def _claim(self):
        """The oldest live waiting request with its page reservation, or
        None (empty line, or a dry pool with the reclaim posted). The whole
        sequence holds the runtime's claim lock; ``take()`` can still lose
        to the lifecycle's park of a waiting request, which reserves
        nothing."""
        with self.rt.claim_mu:
            return self._claim_locked()

    def _claim_locked(self):
        eng = self.rt.engine
        while True:
            head = eng._waiting.head()
            if head is None:
                return None
            if head.cancelled:
                if eng._waiting.take(head):
                    eng._end_stream(head, head._abort or "CANCELLED")
                continue
            if head.deadline_ns is not None and time.monotonic_ns() > head.deadline_ns:
                # the claim path's deadline shed, atomic through take()
                if eng._waiting.take(head):
                    self.rt.bump("shed_deadline")
                    eng.trace.record("shed", head.rid, -1, TERMINAL_CODES["SHED_DEADLINE"])
                    eng._end_stream(head, "SHED_DEADLINE")
                continue
            res = self._reserve(head)
            if res == "unregistered":
                # the prefix went away after submit: this request alone faults
                if eng._waiting.take(head):
                    log.warning("request references unregistered prefix %s; retiring it "
                                "unserved", head.prefix)
                    self.rt.bump("faulted_requests")
                    eng.trace.record("fault", head.rid, -1)
                    eng._end_stream(head, "FAULTED")
                continue
            if res is None:
                return None
            break
        # claimed before taken, so the lifecycle never finds the request in
        # neither place; a lost take() rolls both back
        self.rt.claim_request(head)
        if not eng._waiting.take(head):
            self.rt.unclaim(head)
            self._release(res)
            return None
        # ownership confirmed: now the prefix counters may move
        if res["shared"]:
            self.rt.bump("prefix_blocks_shared", len(res["shared"]))
        if res["cow"]:
            self.rt.bump("prefix_cow_copies")
        now_ns = time.monotonic_ns()
        head.t_depart_ns = now_ns
        eng.trace.record("queue_depart", head.rid)
        if head.t_submit_ns:
            eng.trace.note_queue_wait((now_ns - head.t_submit_ns) / 1e9)
        return head, res

    def _reserve(self, req):
        """The slot-less half of the engine's ``_reserve_paged_locked``:
        prompt + budget pages, a prefix's full pages shared (no copy), only
        its partial boundary page copied. The reservation, None on a dry
        free list (reclaim posted), or "unregistered"."""
        eng = self.rt.engine
        if req.prefix is not None:
            # lookup, share and the copy's source read atomic against
            # unregister_prefix
            with eng._prefix_lock:
                entry = eng._prefixes.get(req.prefix)
                if entry is None:
                    return "unregistered"
                return self._reserve_locked(req, entry)
        return self._reserve_locked(req, None)

    def _reserve_locked(self, req, entry):
        # the engine's arithmetic; the share / copy / rollback sequence
        # mirrors _reserve_paged_locked on a worker thread (plain alloc: the
        # loop evicts; counters wait for take())
        eng = self.rt.engine
        base, budget, full, need_priv = eng._reserve_plan(req, entry)
        shared = entry["blocks"][:full] if entry is not None else []
        if need_priv > 0 and eng._fire_fault("alloc_exhaust"):
            priv = None  # the injected dry pool takes the real one's path
        else:
            priv = eng._alloc.alloc(need_priv) if need_priv > 0 else []
        if priv is None:
            self.rt.bump("pool_blocked_prefills")
            self.rt.request_blocks(need_priv)
            return None
        cow = False
        try:
            if shared:
                eng._alloc.share(shared)
            self._fence_in()
            if base % eng._page:
                # the prefix's boundary block, every layer and plane, on this
                # worker's stream (under a mesh on every rank)
                eng.model.copy_blocks(eng.state, [entry["blocks"][full]], [priv[0]])
                cow = True
        except Exception:
            eng._alloc.release(list(shared) + priv)
            raise
        last = entry["last_logits"] if entry is not None else None
        if last is not None and self.stream is not None:
            last.record_stream(self.stream)
        return {"shared": list(shared), "priv": priv, "base": base, "budget": budget,
                "cow": cow, "prefix_tokens": list(entry["tokens"]) if entry else [],
                "last_logits": last}

    # ------------------------------------------------------------ device order

    def _fence_in(self) -> None:
        """Order this worker's next writes after everything the loop's
        stream has been given so far (blocks just released may still be
        written or read there)."""
        if self.stream is not None:
            self.stream.wait_stream(self.rt.engine._main_stream)

    def _settle(self) -> None:
        """Wait (on the host) until this worker's stream has run everything
        given to it: an event wait, which the sync debug mode does not flag."""
        if self.stream is not None:
            done = torch.cuda.Event()
            done.record(self.stream)
            done.synchronize()

    def _fetch(self, tok: torch.Tensor) -> int:
        """The first token on the host: its copy staged into pinned memory
        on this worker's stream and waited for by event, which orders every
        chunk before the handoff."""
        if self.stream is None:
            return int(tok.reshape(-1)[0])
        host = torch.empty((1,), dtype=tok.dtype, pin_memory=True)
        host.copy_(tok.reshape(-1)[:1], non_blocking=True)
        self._settle()
        return int(host[0])

    # ----------------------------------------------------------- prefill

    def _release(self, res: dict) -> None:
        blocks = res["shared"] + res["priv"]
        if blocks:
            self._settle()
            self.rt.engine._alloc.release(blocks)
        res["shared"], res["priv"] = [], []

    def _release_all(self, req, res: dict, status: Optional[str] = None) -> None:
        """Release the claim's reservation and, with ``status``, end the
        stream (the request's own abort, cancel or shed, names it)."""
        self._release(res)
        self.rt.unclaim(req)
        if status is not None:
            self.rt.engine._end_stream(req, req._abort or status)

    def _idle(self) -> bool:
        return not any(r is not None for r in self.rt.engine._slot_req)

    def _prefill_one(self, req, res: dict) -> None:
        eng = self.rt.engine
        serving = eng.serving
        n = int(req.tokens.shape[0])
        base, total = res["base"], res["base"] + n
        blocks = res["shared"] + res["priv"]
        c = eng._chunk
        # the slot field carries the worker id: one Chrome lane a worker
        eng.trace.record("prefill_start", req.rid, self.wid, n)
        if eng._fire_fault("worker_death"):
            # the thread dies with its claim as it is; the supervisor recovers
            raise WorkerDeath(f"injected worker_death (worker {self.wid})")
        stop = eng._stop.is_set
        if n:
            padded = np.zeros((1, -(-n // c) * c), np.int32)
            padded[0, :n] = req.tokens
            pad = padded.shape[1]
            logits = None
            for off in range(0, pad, c):
                if not self.rt.controller.acquire(c, self._idle, stop) or req.cancelled:
                    self._release_all(req, res, status="CANCELLED")
                    return
                kv_bucket = eng._chunk_bucket(base + off + c)
                row = np.zeros((kv_bucket // eng._page,), np.int32)
                m = min(len(blocks), row.shape[0])
                row[:m] = blocks[:m]
                # explicit block ids and the slot count as the slot: the
                # chunk touches no slot's row or length
                logits, _ = eng._prefill_chunk(
                    eng.params, eng.state, eng._upload(padded[:, off:off + c], torch.int32),
                    serving.slots, base + off, min(base + off + c, total), kv_bucket=kv_bucket,
                    block_ids=eng._upload(row, torch.int32))
                self.rt.bump("prefill_chunks")
                eng.trace.record("prefill_chunk", req.rid, -1, c)
            last_row = logits[0, (total - base - 1) - (pad - c)]
        else:
            # an empty suffix after a prefix: the prefix's stored logits
            last_row = res["last_logits"]
        tok = self._fetch(sample_tokens(last_row[None], [self._gen], serving.temperature,
                                        serving.top_k, serving.top_p))
        self.rt.bump("fetches")
        self.rt.bump("bytes_fetched", 4)
        if req.cancelled or eng._stop.is_set():
            self._release_all(req, res, status="CANCELLED")
            return
        t_first = time.perf_counter()
        now_ns = time.monotonic_ns()
        eng.trace.record("first_token", req.rid, -1)
        if req.t_submit_ns:
            eng.trace.note_ttft((now_ns - req.t_submit_ns) / 1e9)
        if req.t_depart_ns:
            eng.trace.note_prefill_exec((now_ns - req.t_depart_ns) / 1e9)
        req.delivered += 1
        req.out.put(tok)
        if self.current is not None:
            # a dead worker's request is faulted from here on, never replayed
            self.current["delivered"] = True
        self.rt.bump("first_tokens")
        if res["budget"] - 1 <= 0 or tok == serving.eos_token:
            # served whole by the first token: no slot, blocks straight back
            self.rt.bump("worker_retired")
            self._release_all(req, res, status="OK")
            return
        entry = {
            "req": req,
            "tokens": res["prefix_tokens"] + [int(x) for x in req.tokens.tolist()],
            "pending": tok,
            "budget": res["budget"] - 1,
            "seq_len": total,
            "n_pages": len(blocks),
            "shared": res["shared"],
            "priv": res["priv"],
            "hist_exact": True,
            "t_first": t_first,
        }
        # the entry owns the blocks from here
        res["shared"], res["priv"] = [], []
        self.rt.push_ready(entry)
        self.rt.bump("handoffs")
        eng.trace.record("handoff", req.rid, self.wid, len(blocks))
        # an idle loop waits on _wake: the handoff installs now
        eng._wake.set()

