"""Live session migration between serving engines (counterpart of
vtpu/serving/migrate.py): a stream outlives the engine it started on.

    migrate(request, src, dst)

1. PARK on the source, lossless at the flush boundary: the token in
   flight lands, then the settled session leaves its slot (``park``).
2. EXTRACT on the source loop thread: the parked entry's metadata (token
   history, pending token, budget, priority, page count) and its block
   payload. Resident blocks go through the adapter's swap staging gathers
   (``swap_out``) into a block-major host buffer a plane, [n, L, page,
   ...], pinned on a card: the one D2H the session would pay to spill
   anyway, waited for here on the loop thread. Blocks already spilled to
   the source's host tier are read from host memory once their spill's
   event has completed. A dropped entry ships metadata only.
3. INSTALL on the destination loop thread: allocate pages (with the
   eviction-assisted reclaim an admission gets), upload the payload
   through ``restore_pages`` (the swap-in's staging scatter, in place: no
   state tensor moves and no graph is captured), and land the entry in the
   parked set. ``resume`` then remaps the table row and the stream
   continues at exactly the next token. No device copy beyond that
   D2H/H2D pair (``stats()["migration_copies"] == 0``).

Crash recovery: the metadata ships BEFORE the payload, so a source that
dies mid-transfer (the ``migrate_src_death`` seam, fired at the source's
extract) or a payload lost in transit (``migrate_payload_loss``, at the
destination's install) leaves the destination holding what
recompute-on-fault needs: the entry installs dropped and the prefill
rebuild regenerates the KV from the token history. Only a session that can
neither transfer nor be rebuilt ends with a typed FAULTED terminal.

``drain_engine(src, dst)`` (``ServingEngine.drain``) closes admission,
moves every live, parked, waiting and mid-admission session, and returns
once the source holds nothing. Sessions the caller cancelled retire with
their typed terminal; drain itself never ends one.

Threading: engines meet ONLY through lifecycle tickets. ``migrate()`` runs
on a client thread and blocks on the source's loop, so it must never be
called from inside a token's delivery (the loop thread: it would wait on
itself); ``park()`` may be. The extract and install handlers run on each
engine's own loop thread, the owner of its parked set, allocator and
device state. On one card both engines enqueue on the same stream, so
their work is serialized in stream order.

The payload is the port's own block-major layout (the reference's is
layer-major): payloads never cross packages. An engine under ``mesh=``
cannot migrate yet: its head shards need a broadcast op of their own.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

from vtpu_torch.serving.adapters import _runs, restore_pages, to_host
from vtpu_torch.serving.engine import Status

log = logging.getLogger(__name__)


class MigrationError(RuntimeError):
    """A migration (or drain) could not run or complete: incompatible
    engines, a park that never settled, an engine stopping mid-transfer,
    or a drain timeout. The session is never silently lost: it is still
    on the source, installed on the destination, or carries a typed
    terminal."""


class _Ticket:
    """One lifecycle-queue command and its answer: the caller blocks on
    ``done``; the owning loop thread fills ``result`` (ok) or ``error``
    (fail). ``meta``/``payload`` carry the install half's inputs.

    ``mu``/``abandoned`` close the timed-out-caller race: a caller that
    gives up marks the ticket abandoned UNDER THE LOCK the handler serves
    it under, so exactly one of two things happens: the handler had not
    started (it observes the flag: an abandoned EXTRACT leaves the session
    parked on the source, as the caller's error said; an abandoned INSTALL
    still lands the entry and resumes it itself, because by then the
    session exists nowhere else), or the handler was mid-serve, and
    ``abandon()`` blocks until it finishes and returns False so the caller
    uses the result after all."""

    __slots__ = ("req", "meta", "payload", "result", "error", "done", "mu", "abandoned")

    def __init__(self, req, meta=None, payload=None):
        self.req = req
        self.meta = meta
        self.payload = payload
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.mu = threading.Lock()
        self.abandoned = False

    def ok(self, result: dict) -> None:
        self.result = result
        self.done.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.done.set()

    def abandon(self) -> bool:
        """Mark the ticket dead to its caller. True when the handler had
        not served it (and now never acts for the caller); False when the
        answer arrived, possibly after blocking out a mid-serve handler,
        and the caller should use it."""
        with self.mu:
            if self.done.is_set():
                return False
            self.abandoned = True
            return True


def _block_shape(eng, key) -> tuple:
    """One plane's per-block geometry: the pool plane [L, blocks, page,
    ...] without its block axis."""
    s = eng.state[key].shape
    return (int(s[0]),) + tuple(int(x) for x in s[2:])


def _compat_check(src, dst) -> None:
    """Fail fast, on the caller's thread, for engine pairs that can never
    exchange a session: the block geometry (page size, KV planes, per-block
    shapes) must match exactly, since the payload is raw pool pages."""
    if src is dst:
        raise MigrationError("cannot migrate a session onto its own engine")
    for eng, name in ((src, "source"), (dst, "destination")):
        if eng.mesh is not None:
            raise MigrationError(
                f"the {name} engine serves under mesh=: migrating a session's head shards "
                "needs a broadcast op of its own, not ported yet (a later slice); migrate "
                "between one-device engines")
        if not getattr(eng, "_swap_enabled", False):
            raise MigrationError(
                f"migration requires ServingConfig.kv_swap on the {name} engine (the "
                "park/serialize machinery lives there)")
        if eng._thread is None:
            raise MigrationError(f"{name} engine is not started")
        if eng._stop.is_set():
            raise MigrationError(f"{name} engine is stopped")
    if dst._draining:
        raise MigrationError("destination engine is itself draining")
    if src._page != dst._page:
        raise MigrationError(
            f"kv_page mismatch: source {src._page} vs destination {dst._page}: pool "
            "pages cannot transfer across geometries")
    if src._swap_planes != dst._swap_planes:
        raise MigrationError(
            f"KV plane mismatch: source {src._swap_planes} vs destination "
            f"{dst._swap_planes} (quantization layouts differ)")
    for key in src._swap_planes:
        s_shape, d_shape = _block_shape(src, key), _block_shape(dst, key)
        if s_shape != d_shape or src.state[key].dtype != dst.state[key].dtype:
            raise MigrationError(
                f"block geometry mismatch on plane {key!r}: per-block {s_shape} "
                f"{src.state[key].dtype} vs {d_shape} {dst.state[key].dtype}: the engines "
                "serve different models")


def _ask(eng, kind: str, ticket: _Ticket, timeout: float) -> dict:
    """Enqueue one lifecycle ticket on *eng* and wait for its answer. On
    timeout the ticket is ABANDONED (``_Ticket.abandon``), unless the
    answer landed meanwhile, which is then used. The wait is a watched
    slice loop: a loop thread that died fails the ask at once instead of
    stranding the caller until the timeout."""
    eng._lifecycle_q.put((kind, ticket))
    eng._wake.set()
    served = ticket.done.wait(0.0)
    deadline = time.monotonic() + timeout
    why = "is its serving loop healthy?"
    while not served:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        if ticket.done.wait(min(remaining, 0.05)):
            served = True
            break
        t = eng._thread
        if eng._died or t is None or (eng._stop.is_set() and not t.is_alive()):
            why = "its serving loop is dead"
            break
    if not served and not ticket.done.wait(0.0) and ticket.abandon():
        raise MigrationError(
            f"{kind} did not complete within {timeout:.1f}s on engine {eng!r} ({why})")
    if ticket.error is not None:
        raise MigrationError(f"{kind} failed: {ticket.error!r}")
    return ticket.result


def migrate(request, src, dst, timeout: float = 60.0) -> dict:
    """Move one live session from *src* to *dst*, resuming its stream at
    exactly the next token. The request may be streaming, parked, or still
    waiting on the source; the client keeps iterating the same
    ``Request.stream()``, whose tokens start arriving from the destination.
    Returns a report::

        {"path": "resident" | "host" | "recompute" | "requeue"
                 | "completed" | "cancelled" | "gone" | "faulted",
         "bytes": payload bytes moved, "src_died": bool, "ms": wall}

    ``resident``: the payload was uploaded into the destination's pool;
    ``host``: it landed in the destination's host tier under pool pressure;
    ``recompute``: metadata only (payload lost or never resident), the
    destination rebuilds through prefill; ``requeue``: a request not yet
    admitted joined the destination's waiting line.
    ``completed``/``cancelled``/``gone``: the session settled before it
    could move; nothing was transferred. ``faulted``: the destination could
    neither land nor rebuild it and delivered its FAULTED terminal.

    Raises MigrationError when the pair is incompatible or the transfer
    cannot run; the session then still lives on the source (parked if the
    park settled: ``resume()`` it to carry on in place). Call it from a
    client thread, never from inside a token's delivery."""
    _compat_check(src, dst)
    t0 = time.perf_counter()

    def report(path, nbytes=0, src_died=False):
        return {"path": path, "bytes": nbytes, "src_died": src_died,
                "ms": (time.perf_counter() - t0) * 1e3}

    if request.status is not None:
        return report("completed")
    if request.prefix is not None and request in src._waiting:
        # a WAITING prefix-backed request has no pages to ship and its
        # prefix id means nothing on the destination; once admitted it
        # migrates (the prefix content rides the payload, private)
        raise MigrationError(
            "a waiting prefix-backed request cannot migrate (its prefix registration "
            "lives on the source engine); migrate it after it admits")
    we_parked = request not in src._parked
    if we_parked:
        src.park(request)
        deadline = t0 + timeout
        while request not in src._parked:
            if request.status is not None:
                return report("completed")
            if time.perf_counter() > deadline:
                raise MigrationError(
                    "park never settled on the source (request unknown to the engine, "
                    "or its loop is stalled)")
            time.sleep(0.001)
    entry = src._parked.get(request)
    if entry is not None and entry.get("unstarted") and request.prefix is not None:
        if we_parked:
            src.resume(request)  # undo our park: back to the waiting line
        raise MigrationError(
            "a waiting prefix-backed request cannot migrate (its prefix registration "
            "lives on the source engine)")
    out = _ask(src, "migrate_out", _Ticket(request), timeout)
    if out["status"] != "ok":
        return report(out["status"])
    res = _ask(dst, "migrate_in", _Ticket(request, meta=out["meta"], payload=out["payload"]),
               timeout)
    path = res["path"]
    if path in ("resident", "host", "recompute", "requeue"):
        dst.resume(request)
    nbytes = (out["meta"]["n_pages"] * src._block_bytes
              if out["payload"] is not None else 0)
    return report(path, nbytes=nbytes, src_died=out.get("src_died", False))


def _snaplist(d, tries: int = 8) -> list:
    """list(keys) of a dict another thread mutates: retry the rare
    mid-iteration resize instead of locking the serving loop."""
    for _ in range(tries):
        try:
            return list(d)
        except RuntimeError:
            continue
    return list(d)


def _live_sessions(src) -> list:
    """Every session the source still owes a stream: live slots, chunked
    admissions, parked entries, the waiting line. Worker-owned (disagg) and
    still-pending submits surface in these within a tick or two: drain's
    outer loop snapshots again until the engine reads empty."""
    seen, out = set(), []

    def add(r):
        if r is not None and id(r) not in seen and r.status is None:
            seen.add(id(r))
            out.append(r)

    for r in list(src._slot_req):
        add(r)
    for slot in range(src.serving.slots):
        adm = src._admitting.get(slot)
        if adm is not None:
            add(adm["req"])
    for r in _snaplist(src._parked):
        add(r)
    for r in src._waiting:
        add(r)
    return out


def drain_engine(src, dst=None, timeout: float = 120.0, choose_dst=None,
                 on_migrated=None) -> dict:
    """Evacuate *src* (``ServingEngine.drain``): close admission, migrate
    every session the source still owes a stream, and return once it holds
    nothing: no slots, nothing parked, queued or admitting. Cancelled
    sessions retire on the source with their typed terminal; sessions that
    complete during the evacuation are counted, not moved.

    The destination is either FIXED (*dst*) or chosen per session by
    ``choose_dst(req) -> engine`` (a fleet's rolling evacuation; a
    selector with no candidate raises MigrationError, which ends the
    drain). ``on_migrated(req, target)`` observes each successful move."""
    if (dst is None) == (choose_dst is None):
        raise ValueError("pass exactly one of dst / choose_dst")
    if dst is not None:
        _compat_check(src, dst)

        def choose_dst(req, _dst=dst):
            return _dst

    src._draining = True
    t0 = time.perf_counter()
    migrated = completed = faulted = 0
    while True:
        live = [r for r in _live_sessions(src) if not r.cancelled]
        if not live:
            s = src.stats()
            if (s["active_slots"] == 0 and s["parked_sessions"] == 0
                    and s["queued"] == 0 and s["admitting_slots"] == 0):
                break
        for req in live:
            remaining = timeout - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            if req.prefix is not None and req in src._waiting:
                # cannot migrate while waiting: leave it until it admits
                # (admission stays open to requests already queued), then
                # it migrates; retrying it here would livelock the drain
                continue
            target = choose_dst(req)
            try:
                rep = migrate(req, src, target, timeout=max(remaining, 1.0))
            except MigrationError:
                # settled or cancelled meanwhile, or not parkable yet
                # (mid-chunk, worker-owned): the next pass retries, and the
                # timeout bounds the whole drain
                continue
            if rep["path"] == "completed":
                completed += 1
            elif rep["path"] == "faulted":
                # off the source, but its stream ended FAULTED: a loss,
                # never an evacuation
                faulted += 1
            elif rep["path"] not in ("cancelled", "gone"):
                migrated += 1
                if on_migrated is not None:
                    on_migrated(req, target)
        if time.perf_counter() - t0 > timeout:
            raise MigrationError(
                f"drain timed out after {timeout:.1f}s with sessions still on the source")
        time.sleep(0.002)
    return {"migrated": migrated, "completed": completed, "faulted": faulted,
            "ms": (time.perf_counter() - t0) * 1e3}


# ---------------------------------------------------------------- handlers
# Everything below runs ON AN ENGINE'S SERVING-LOOP THREAD, from
# _process_lifecycle: the one writer of the parked set, the allocator and
# the device state.


def handle_migrate_command(eng, kind: str, ticket: _Ticket) -> None:
    """Serve one migrate ticket; never lets an exception reach the loop. A
    failed EXTRACT leaves the entry parked on the source (the snapshot
    changes nothing until it has succeeded), so the session survives; a
    failed INSTALL faults the request, typed: its source blocks are
    released already and no engine is left that could resume it."""
    with ticket.mu:
        if ticket.abandoned and kind == "migrate_out":
            # the caller timed out and was told the session still lives
            # here, parked: extract nothing, release nothing
            return
        try:
            if kind == "migrate_out":
                _do_migrate_out(eng, ticket)
            else:
                _do_migrate_in(eng, ticket)
        except Exception as exc:
            log.exception("%s failed for request %s; containing", kind,
                          getattr(ticket.req, "rid", None))
            if kind == "migrate_in":
                eng._stats["migrate_failures"] += 1
                eng._stats["faulted_requests"] += 1
                eng.trace.record("fault", ticket.req.rid, -1)
                eng._end_stream(ticket.req, Status.FAULTED)
            ticket.fail(exc)


def _do_migrate_out(eng, ticket: _Ticket) -> None:
    """Source half: snapshot the parked entry's metadata and payload, then
    release everything it held here. Snapshot before release, so any
    failure leaves the session parked and whole."""
    req = ticket.req
    if req.status is not None:
        ticket.ok({"status": "completed"})
        return
    e = eng._parked.get(req)
    if e is None:
        # finished, cancelled and swept, or never parked here: nothing to
        # extract and nothing held
        ticket.ok({"status": "gone"})
        return
    if req.cancelled:
        eng._release_parked(eng._parked.pop(req))
        eng._end_stream(req, req._abort or Status.CANCELLED)
        ticket.ok({"status": "cancelled"})
        return
    meta = {
        "unstarted": bool(e.get("unstarted")),
        "tokens": list(e["tokens"]),
        "pending": e["pending"],
        "budget": e["budget"],
        "seq_len": e["seq_len"],
        "n_pages": e["n_pages"],
        "hist_exact": bool(e.get("hist_exact", True)),
        "priority": e["priority"],
        # content-addressed prefix identity: none in the port yet (the
        # prefix directory is a later slice), so a destination never
        # re-shares a resident replica and rebuilds every position
        "pid": e.get("pid"),
        "prefix_len": int(e.get("prefix_len") or 0),
    }
    payload = None
    src_died = False
    if not meta["unstarted"]:
        if eng._fire_fault("migrate_src_death"):
            # injected source death after the metadata handshake: the
            # payload dies with this engine's pool, the destination
            # rebuilds from the token history
            src_died = True
        elif not e["dropped"]:
            payload = _snapshot_payload(eng, e)
    eng._release_parked(eng._parked.pop(req))
    eng._stats["migrations_out"] += 1
    if payload is not None:
        eng._stats["migrate_out_bytes"] += meta["n_pages"] * eng._block_bytes
    eng.trace.record("migrate_out", req.rid, -1, meta["n_pages"])
    ticket.ok({"status": "ok", "meta": meta, "payload": payload, "src_died": src_died})


def _snapshot_payload(eng, e: dict) -> dict:
    """The entry's block contents in table-row order (shared prefix blocks
    first, then private) as one block-major host buffer a KV plane, [n, L,
    page, ...] (scale planes included), pinned on a card. Resident blocks
    go through the adapter's staging gathers and copy into it; the loop
    thread waits for those copies once (the one D2H of the transfer).
    Blocks spilled to this engine's host tier are read on the host, after
    the spill's copies are known done (its event, waited for here: the
    device-side wait a swap-in uses would not order a host read)."""
    if e["pend"] is not None:
        e["pend"].synchronize()
    if e in eng._swap_pending:
        eng._finalize_swap_out(e)
    n = e["n_pages"]
    cuda = eng.device.type == "cuda"
    bufs = {key: torch.empty((n,) + _block_shape(eng, key), dtype=eng.state[key].dtype,
                             pin_memory=cuda)
            for key in eng._swap_planes}
    resident = list(e["shared"]) + (list(e["priv"]) if e["host"] is None else [])
    if resident:
        w = eng._swap_stage
        pos = list(range(len(resident)))
        for i, snap in eng.model.swap_out(eng.state, resident, pos, w):
            to_host(bufs, snap, pos[i:i + w], non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(eng.device).synchronize()
    done = len(resident)
    if e["host"] is not None:
        for j, h, r in _runs(e["host"]):
            for key in eng._swap_planes:
                bufs[key][done + j:done + j + r].copy_(eng._host_pool[key][h:h + r])
        done += len(e["host"])
    assert done == n, f"payload covered {done} of {n} pages"
    return bufs


def _fault_install(eng, req, reason: str) -> dict:
    eng._stats["migrate_failures"] += 1
    eng._stats["faulted_requests"] += 1
    eng.trace.record("fault", req.rid, -1)
    eng._end_stream(req, Status.FAULTED)
    log.warning("migration install faulted request %s: %s", req.rid, reason)
    return {"path": "faulted", "error": reason}


def _do_migrate_in(eng, ticket: _Ticket) -> None:
    """Destination half: land the entry in the parked set, its payload in
    freshly reclaimed pool pages (one staged H2D), in the host tier under
    pool pressure, or metadata only as a dropped entry headed for a
    rebuild. ``resume()`` then continues the stream through the ordinary
    restore paths (row remap, swap-in, prefill rebuild)."""
    req, meta, payload = ticket.req, ticket.meta, ticket.payload
    if req.status is not None:
        ticket.ok({"path": "completed"})
        return
    if req.cancelled:
        eng._end_stream(req, req._abort or Status.CANCELLED)
        ticket.ok({"path": "cancelled"})
        return
    # a fresh identity on this engine: its trace is its own, and a source
    # rid equal to a live destination rid would merge their spans
    req.rid = next(eng._req_ctr)
    if meta["unstarted"]:
        try:
            eng._bucket(int(req.tokens.shape[0]))
        except ValueError as exc:
            ticket.ok(_fault_install(eng, req, str(exc)))
            return
        eng._parked[req] = {
            "req": req, "unstarted": True, "tokens": [], "pending": None, "budget": 0,
            "seq_len": 0, "n_pages": 0, "shared": [], "priv": [], "host": None,
            "pend": None, "dropped": False, "recompute_ok": True, "hist_exact": True,
            "priority": meta["priority"], "seq": eng._park_seq}
        eng._park_seq += 1
        eng._stats["migrations_in"] += 1
        eng.trace.record("migrate_in", req.rid, -1, 0)
        ticket.ok({"path": "requeue"})
        if ticket.abandoned:
            eng.resume(req)  # no caller left to do it (_Ticket)
        return
    if payload is not None and eng._fire_fault("migrate_payload_loss"):
        # injected transit loss: the metadata survived, the bytes did not
        payload = None
    recompute_ok = meta["hist_exact"] and eng._can_recompute(meta["seq_len"])
    if meta["n_pages"] > eng._max_pages:
        ticket.ok(_fault_install(
            eng, req, f"session needs {meta['n_pages']} pages but this engine's table "
                      f"rows hold {eng._max_pages}"))
        return
    entry = {
        "req": req, "tokens": list(meta["tokens"]), "pending": meta["pending"],
        "budget": meta["budget"], "seq_len": meta["seq_len"], "n_pages": meta["n_pages"],
        "shared": [], "priv": [], "host": None, "pend": None, "dropped": False,
        "recompute_ok": recompute_ok, "hist_exact": meta["hist_exact"],
        "priority": meta["priority"], "seq": eng._park_seq,
        "pid": meta.get("pid"), "prefix_len": int(meta.get("prefix_len") or 0)}
    if payload is None:
        if not recompute_ok:
            ticket.ok(_fault_install(
                eng, req, "payload lost and the session cannot be rebuilt (inexact "
                          "history or sequence past every prefill route)"))
            return
        entry["dropped"] = True
        eng._stats["migrate_recomputes"] += 1
        path = "recompute"
    else:
        n = meta["n_pages"]
        # the reclaim's eviction gathers and the upload's scatters both run
        # on this thread's stream, in that order
        priv = eng._alloc_reclaim(n)
        if priv is not None:
            try:
                _upload_payload(eng, priv, payload, n)
            except Exception:
                # the blocks are attached to nothing yet: give them back,
                # or every such fault shrinks the pool for good
                eng._alloc.release(priv)
                raise
            entry["priv"] = priv
            path = "resident"
        elif eng._swap_host_blocks and len(eng._host_free) >= n:
            # the pool cannot cover it even after reclaim: land in the host
            # tier, and resume swaps it in like any evicted session
            hbs = [eng._host_free.pop() for _ in range(n)]
            try:
                if eng._copy_stream is not None:
                    # a freed host block may still be the target of a spill
                    # in flight on the side stream: let it land first
                    eng._copy_stream.synchronize()
                for j, h, r in _runs(hbs):
                    for key in eng._swap_planes:
                        eng._host_pool[key][h:h + r].copy_(payload[key][j:j + r])
            except Exception:
                eng._host_free.extend(hbs)
                raise
            entry["host"] = hbs
            path = "host"
        elif recompute_ok:
            entry["dropped"] = True
            eng._stats["migrate_recomputes"] += 1
            path = "recompute"
        else:
            ticket.ok(_fault_install(
                eng, req, "no pool pages, no host-tier room, and the session cannot be "
                          "rebuilt"))
            return
        if path in ("resident", "host"):
            eng._stats["migrate_in_bytes"] += n * eng._block_bytes
    eng._park_seq += 1
    eng._parked[req] = entry
    eng._stats["migrations_in"] += 1
    eng.trace.record("migrate_in", req.rid, -1, meta["n_pages"])
    ticket.ok({"path": path})
    if ticket.abandoned:
        eng.resume(req)  # no caller left to do it (_Ticket)


def _upload_payload(eng, priv: list, payload: dict, n: int) -> None:
    """Scatter the payload into freshly allocated pool pages ``priv``
    through the swap-in's staging path (``restore_pages``: up to
    ``kv_swap_stage_blocks`` blocks a scatter, in place, on this thread's
    stream), the one H2D of the transfer. On a card the pinned payload
    copies non-blocking; the host allocator keeps it alive until the copy
    has read it."""
    eng.state = restore_pages(eng.state, payload, priv, list(range(n)), eng._swap_stage)
