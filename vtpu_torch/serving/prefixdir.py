"""Prefix gravity: the prefix cache as a fleet resource, not an engine's
(the port's copy of vtpu/serving/prefixdir.py).

One engine's prefix registry (register once, admit by mapping pool blocks
read-only), its host swap tier and its lifecycle tickets compose here into
a fleet-wide prefix tier:

1. CONTENT ADDRESSING. A prefix is named by ``prefix_id(tokens)``, a stable
   hash of its token values, so the same system prompt registered on two
   engines is ONE directory entry with two residents. The engine keeps its
   dense local ids; the content pid is the cross-engine name.

2. THE DIRECTORY. ``PrefixDirectory`` maps ``pid -> {engine: state}``
   where state is RESIDENT (blocks pinned in that engine's pool) or
   HOST-TIER (a serialized payload any compatible engine can install),
   with live refcounts and last-hit stamps fed by the engine's own
   share/release discipline through a per-engine listener: the directory
   never polls, and an engine outside a fleet has no listener.

3. MOVEMENT. ``export_prefix`` snapshots a registered prefix's blocks
   through the migration payload's staging (the adapter's swap gathers
   into a pinned block-major host buffer a plane, the one D2H);
   ``install_prefix`` lands a payload in a destination pool through the
   swap-in's staging scatter, in place, and registers it under the SAME
   content pid (``prefix_install_copies`` stays 0: the install is the
   once-per-engine transfer, admission still maps read-only). Both run as
   lifecycle tickets on the owning loop thread; the prefix's final logits
   ride along as one extra ``__logits__`` plane.

The routing half lives in ``EngineFleet.submit(prefix_tokens=...)``: the
directory supplies a bonus proportional to the prefill a resident engine
avoids (prefix length x the measured per-token build cost, in queue-slot
units so it composes with ``LeastPressureRoutePolicy``'s score), and the
fleet monitor replicates hot prefixes and spills cold ones with the two
movement primitives above. The payload is the port's block-major layout
(the reference's is layer-major): payloads never cross packages.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from vtpu_torch.serving.migrate import _Ticket, _ask, _snapshot_payload, _upload_payload

log = logging.getLogger(__name__)

# the payload plane carrying the prefix's stored final logits (the
# first-token source for empty-suffix submits): not a KV plane, so it
# rides the generic payload dict under a key no KV plane can collide with
LOGITS_PLANE = "__logits__"


def prefix_id(tokens) -> str:
    """Stable content address for a prefix: sha256 over the int32 token
    bytes, truncated to 16 hex chars. Engines hashing the same prompt on
    different hosts (or across restarts) agree on the name — that
    agreement is what makes the directory a directory and not a cache of
    per-engine opinions."""
    arr = np.asarray(tokens, np.int32)
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


class PrefixDirectory:
    """The fleet's view of WHERE each content-addressed prefix lives.

    Thread-safe throughout (listener events arrive from every engine's
    loop thread, route scoring from submitter threads, replication from
    the monitor). Per pid it tracks the resident engines (local id,
    live refcount, hit count, last-hit stamp), an optional host-tier
    payload, and the token tuple itself; globally it maintains an EMA of
    the measured per-token prefill cost (fed from registration build
    wall-times) that prices the route bonus.

    Refcounts follow the engine's own share()/release() discipline via
    listener events: a paged admission's share() is a "hit" (+1 ref), a
    slot retire / park-entry release is a "release" (-1). Remote engines
    report through the fleet's route bookkeeping instead (their loop
    threads live on another host), so their refcounts read 0 — the spill
    policy treats hits-recency as the signal there."""

    def __init__(self, queue_slot_ms: float = 100.0):
        self._mu = threading.Lock()
        # pid -> {"tokens": [int], "len": int,
        #         "engines": {name: {"lid", "refs", "hits", "last_hit_ns"}}}
        self._pids: dict[str, dict] = {}
        # pid -> (meta, payload) — the shared host tier (fleet-process
        # memory standing in for a pinned shared segment / object store)
        self._host: dict[str, tuple[dict, dict]] = {}
        # ms one queue-slot of pressure is "worth" when converting
        # avoided prefill into LeastPressure score units (see route_bonus)
        self._queue_slot_ms = float(queue_slot_ms)
        self._ms_per_token: Optional[float] = None
        self._hits = 0
        self._misses = 0

    # ------------------------------------------------------------ events

    def on_event(self, engine: str, event: str, pid: Optional[str],
                 lid: Optional[int] = None, tokens=None,
                 length: Optional[int] = None,
                 build_ms: Optional[float] = None) -> None:
        """One engine-side prefix event. ``register``/``unregister``
        maintain residency, ``hit``/``release`` the refcounts. Tolerant
        by design: events for engines the directory already dropped (a
        fenced corpse's loop thread winding down) are no-ops."""
        if pid is None:
            return
        now = time.monotonic_ns()
        with self._mu:
            if event == "register":
                ent = self._pids.get(pid)
                if ent is None:
                    ent = self._pids[pid] = {
                        "tokens": [int(x) for x in tokens or []],
                        "len": int(length or 0), "engines": {}}
                res = ent["engines"].get(engine)
                if res is None:
                    ent["engines"][engine] = {
                        "lid": lid, "refs": 0, "hits": 0,
                        "last_hit_ns": now}
                else:  # re-register is idempotent: refresh the local id
                    res["lid"] = lid
                if build_ms is not None and length:
                    self._note_build_locked(int(length), float(build_ms))
            elif event == "unregister":
                ent = self._pids.get(pid)
                if ent is not None:
                    ent["engines"].pop(engine, None)
                    if not ent["engines"] and pid not in self._host:
                        del self._pids[pid]
            elif event == "hit":
                res = self._res(pid, engine)
                if res is not None:
                    res["refs"] += 1
                    res["hits"] += 1
                    res["last_hit_ns"] = now
                self._hits += 1
            elif event == "release":
                res = self._res(pid, engine)
                if res is not None and res["refs"] > 0:
                    res["refs"] -= 1

    def _res(self, pid: str, engine: str) -> Optional[dict]:
        ent = self._pids.get(pid)
        return ent["engines"].get(engine) if ent is not None else None

    def note_miss(self) -> None:
        """A prefix-aware route fell back to a full-prompt submit — the
        pid lived nowhere, or pressure out-scored every resident. The
        accounting contract the bench audits: every prefix-aware submit
        lands as exactly one directory hit or one miss."""
        with self._mu:
            self._misses += 1

    def note_route_hit(self, pid: str, engine: str) -> None:
        """A prefix submit landed on a REMOTE resident: its loop thread
        reports to its own host, not to this directory, so the fleet
        stamps the hit at route time (refcounts stay 0 for remotes —
        documented in the class docstring)."""
        now = time.monotonic_ns()
        with self._mu:
            res = self._res(pid, engine)
            if res is not None:
                res["hits"] += 1
                res["last_hit_ns"] = now
            self._hits += 1

    def _note_build_locked(self, n_tokens: int, ms: float) -> None:
        per = ms / max(n_tokens, 1)
        self._ms_per_token = (per if self._ms_per_token is None
                              else 0.7 * self._ms_per_token + 0.3 * per)

    def drop_engine(self, engine: str) -> None:
        """Fence-time sweep: every residency on a dead engine vanishes
        (its pool died with it). Host-tier payloads survive — they are
        exactly the failover story."""
        with self._mu:
            for pid in list(self._pids):
                ent = self._pids[pid]
                ent["engines"].pop(engine, None)
                if not ent["engines"] and pid not in self._host:
                    del self._pids[pid]

    # ----------------------------------------------------------- lookups

    def tokens_of(self, pid: str) -> Optional[list[int]]:
        with self._mu:
            ent = self._pids.get(pid)
            if ent is not None and ent["tokens"]:
                return list(ent["tokens"])
            host = self._host.get(pid)
            return list(host[0]["tokens"]) if host is not None else None

    def residents(self, pid: str) -> dict[str, int]:
        """{engine: local id} for every engine holding *pid* resident."""
        with self._mu:
            ent = self._pids.get(pid)
            if ent is None:
                return {}
            return {name: res["lid"] for name, res in ent["engines"].items()}

    def route_bonus(self, prefix_len: int) -> float:
        """The directory's price on a resident route: avoided prefill
        milliseconds (prefix length x measured per-token build cost)
        converted into LeastPressure score units at the 0.25-per-
        queue-slot weight — a resident engine N queue slots busier than
        an idle peer still wins exactly when the avoided prefill
        outweighs N slots' worth of waiting. 0.0 until a registration
        has measured the cost (there is nothing resident to route to
        before one has)."""
        with self._mu:
            if self._ms_per_token is None:
                return 0.0
            avoided_ms = prefix_len * self._ms_per_token
        return 0.25 * avoided_ms / self._queue_slot_ms

    def ms_per_token(self) -> Optional[float]:
        with self._mu:
            return self._ms_per_token

    # --------------------------------------------------------- host tier

    def put_host(self, pid: str, meta: dict, payload: dict) -> None:
        with self._mu:
            self._host[pid] = (dict(meta), payload)
            ent = self._pids.get(pid)
            if ent is None:
                self._pids[pid] = {"tokens": list(meta["tokens"]),
                                   "len": int(meta["len"]), "engines": {}}

    def get_host(self, pid: str) -> Optional[tuple[dict, dict]]:
        with self._mu:
            got = self._host.get(pid)
            return (dict(got[0]), got[1]) if got is not None else None

    def in_host_tier(self, pid: str) -> bool:
        with self._mu:
            return pid in self._host

    # ----------------------------------------- replication / spill policy

    def hot_candidate(self, min_hits: int, max_replicas: int,
                      routable) -> Optional[tuple[str, list[int], str]]:
        """One (pid, tokens, donor_engine) worth replicating: total hits
        past the threshold, fewer residents than the cap, and at least
        one routable engine NOT already holding it (the monitor picks
        which). Hottest first, deterministic ties by pid."""
        routable = set(routable)
        with self._mu:
            best = None
            for pid in sorted(self._pids):
                ent = self._pids[pid]
                live = {n: r for n, r in ent["engines"].items()
                        if n in routable}
                if not live or not ent["tokens"]:
                    continue
                hits = sum(r["hits"] for r in ent["engines"].values())
                if hits < min_hits or len(live) >= max_replicas:
                    continue
                if len(routable - set(live)) == 0:
                    continue
                donor = min(live)  # deterministic donor
                if best is None or hits > best[0]:
                    best = (hits, pid, list(ent["tokens"]), donor)
            return (best[1], best[2], best[3]) if best is not None else None

    def cold_candidate(self, idle_s: float,
                       routable) -> Optional[tuple[str, str, int]]:
        """One (pid, engine, lid) worth spilling: zero live refs
        anywhere, every resident's last hit older than *idle_s*. Coldest
        first, deterministic ties by (pid, engine)."""
        cutoff = time.monotonic_ns() - int(idle_s * 1e9)
        routable = set(routable)
        with self._mu:
            best = None
            for pid in sorted(self._pids):
                ent = self._pids[pid]
                if not ent["engines"]:
                    continue
                if any(r["refs"] > 0 for r in ent["engines"].values()):
                    continue
                last = max(r["last_hit_ns"]
                           for r in ent["engines"].values())
                if last > cutoff:
                    continue
                for name in sorted(ent["engines"]):
                    if name not in routable:
                        continue
                    if best is None or last < best[0]:
                        best = (last, pid, name,
                                ent["engines"][name]["lid"])
                    break
            return ((best[1], best[2], best[3])
                    if best is not None else None)

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Flat gauges/counters, merged into EngineFleet.stats() under
        the exporter's fleet map."""
        with self._mu:
            replicas = sum(len(e["engines"]) for e in self._pids.values())
            refs = sum(r["refs"] for e in self._pids.values()
                       for r in e["engines"].values())
            return {
                "prefix_pids": len(self._pids),
                "prefix_resident_replicas": replicas,
                "prefix_host_tier": len(self._host),
                "prefix_live_refs": refs,
                "prefix_directory_hits": self._hits,
                "prefix_directory_misses": self._misses,
                "prefix_ms_per_token": (
                    round(self._ms_per_token, 6)
                    if self._ms_per_token is not None else None),
            }


# ------------------------------------------------------- movement tickets


def handle_prefix_command(eng, kind: str, ticket: _Ticket) -> None:
    """Serve a prefix_out / prefix_in ticket on *eng*'s loop thread (the
    owner of its pool state and prefix registry). Never raises — a
    failed export/install answers the ticket typed and the loop keeps
    serving everyone else."""
    with ticket.mu:
        if ticket.abandoned:
            return
        try:
            if kind == "prefix_out":
                _do_prefix_out(eng, ticket)
            else:
                _do_prefix_in(eng, ticket)
        except Exception as exc:
            log.exception("%s failed; containing", kind)
            ticket.fail(exc)


def _do_prefix_out(eng, ticket: _Ticket) -> None:
    """Snapshot one registered prefix's pool blocks into pinned host
    buffers, block-major, through the migration payload's staging
    (``_snapshot_payload``: the adapter's staging gathers, one D2H wait), so
    ``prefix_install_copies`` and ``migration_copies`` are untouched. The
    registry entry stays registered: an export is a copy, not a move (the
    spill policy unregisters separately once the payload is safe)."""
    if not getattr(eng, "_paged", False):
        raise RuntimeError("prefix export requires the paged pool")
    if not getattr(eng, "_swap_enabled", False):
        raise RuntimeError(
            "prefix export requires ServingConfig.kv_swap (the staging "
            "gather lives there)")
    lid = ticket.meta["lid"]
    # under the registry lock: an unregister's release must not free the
    # blocks mid-gather (the atomicity an admission's share relies on)
    with eng._prefix_lock:
        entry = eng._prefixes.get(lid)
        if entry is None:
            raise RuntimeError(f"unknown prefix id {lid}")
        blocks = list(entry["blocks"])
        bufs = _snapshot_payload(eng, {"pend": None, "n_pages": len(blocks),
                                       "shared": blocks, "priv": [], "host": None})
        bufs[LOGITS_PLANE] = entry["last_logits"].detach().to("cpu")
        meta = {"pid": entry.get("pid"), "tokens": list(entry["tokens"]),
                "len": entry["len"], "pad": entry["pad"]}
    eng._stats["prefix_exports"] += 1
    ticket.ok({"meta": meta, "payload": bufs})


def _do_prefix_in(eng, ticket: _Ticket) -> None:
    """Install an exported prefix payload into this engine's pool: the
    once-per-engine H2D through the swap-in's staging scatter
    (``_upload_payload``, in place), then a registry entry under the SAME
    content pid: admissions from here on map the blocks read-only exactly
    as if register_prefix had built them here. Idempotent on pid: a
    replica already resident answers with its existing local id. A failed
    upload hands its blocks back."""
    if not getattr(eng, "_paged", False):
        raise RuntimeError("prefix install requires the paged pool")
    if not getattr(eng, "_swap_enabled", False):
        raise RuntimeError(
            "prefix install requires ServingConfig.kv_swap (the staging "
            "scatter lives there)")
    meta, payload = ticket.meta, ticket.payload
    pid = meta["pid"]
    with eng._prefix_lock:
        have = eng._pid_index.get(pid)
        if have is not None and have in eng._prefixes:
            ticket.ok({"lid": have, "pid": pid, "installed": False})
            return
    pad = int(meta["pad"])
    pages = -(-pad // eng._page)
    blocks = eng._alloc_reclaim(pages)
    if blocks is None:
        raise RuntimeError(
            f"kv pool exhausted: prefix install needs {pages} blocks, "
            f"{eng._alloc.free_blocks} free")
    planes = dict(payload)
    logits = planes.pop(LOGITS_PLANE)
    try:
        _upload_payload(eng, blocks, planes)
        last_logits = torch.as_tensor(logits).to(eng.device)
    except Exception:
        # the blocks are attached to nothing yet: hand them back, or every
        # failed install shrinks the pool for good
        eng._alloc.release(blocks)
        raise
    entry = {"tokens": list(meta["tokens"]), "blocks": blocks,
             "len": int(meta["len"]), "pad": pad,
             "last_logits": last_logits, "pid": pid}
    with eng._prefix_lock:
        lid = eng._next_prefix_id
        eng._next_prefix_id += 1
        eng._prefixes[lid] = entry
        eng._pid_index[pid] = lid
    eng._stats["prefix_tier_installs"] += 1
    listener = getattr(eng, "_prefix_listener", None)
    if listener is not None:
        listener("register", pid, lid=lid, tokens=entry["tokens"],
                 length=entry["len"])
    ticket.ok({"lid": lid, "pid": pid, "installed": True})


def export_prefix(eng, lid: int, timeout: float = 30.0) -> tuple[dict, dict]:
    """Snapshot prefix *lid* off *eng* as (meta, payload): the host-tier
    form any compatible engine can install from."""
    res = _ask(eng, "prefix_out", _Ticket(None, meta={"lid": lid}), timeout)
    return res["meta"], res["payload"]


def install_prefix(eng, meta: dict, payload: dict,
                   timeout: float = 30.0) -> dict:
    """Install an exported prefix into *eng*. Returns {"lid", "pid",
    "installed"}."""
    return _ask(eng, "prefix_in",
                _Ticket(None, meta=dict(meta), payload=payload), timeout)
