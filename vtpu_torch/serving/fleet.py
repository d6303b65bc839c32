"""Engine fleet (the port's copy of vtpu/serving/fleet.py): health-checked
supervision, signal-driven routing, and automatic session failover when an
engine dies without saying goodbye.

``migrate``/``drain`` move a stream only when the source cooperates: both
need a live extract on the source's loop thread. An engine can die
mid-tick, and every stream it held must still finish. An ``EngineFleet``
owns N ``ServingEngine``s behind one ``submit()`` front door, on three
pillars:

**Supervision.** A monitor thread health-probes each engine: the loop
stamps a heartbeat at every tick head (``ServingEngine._beat_ns``; an idle
loop passes one at least every ~50 ms), and the probe reads its age plus
the ``stats()``/``EngineSignals`` pressure gauges. Missed beats walk a
HEALTHY -> SUSPECT -> DEAD ladder with hysteresis: SUSPECT engines are
deprioritized by routing but NEVER failed over (a slow-but-alive engine
that beats again returns to HEALTHY with its streams untouched); only
``dead_misses`` consecutive misses declare DEAD, which stops routing at
once, fences the corpse and triggers failover. The ``probe_loss`` fault
seam (consulted once per engine per round, in sorted-name order) drives
the ladder deterministically in tests.

**Signal-driven routing.** A pluggable ``RoutePolicy`` (instance, class,
or ``"module:attr"`` string, the shed policy's loading shape) scores
engines on the ``EngineSignals`` snapshot (pool free/capacity, queue
depth, prefill backlog, parked sessions, ``draining``, attested
``duty``); the highest score wins, ties break on name, and draining or
dead engines are never candidates. Routing also drives the lifecycle:
``fleet.drain(name)`` evacuates an engine with each session landing on the
best-scored survivor at its moment, and a pool-occupancy imbalance past
``rebalance_threshold`` moves one session per probe round from the most-
to the least-pressured engine.

**Automatic failover.** A session ledger: at every tick head each
engine's loop thread (the one writer of its slots, parked set and
histories) records every live and parked session's recovery metadata
(token history, pending token, remaining budget, priority, prefix
identity: the metadata a migration ticket ships) into the fleet's ledger.
When an engine is declared DEAD with no extract possible, every session it
held is rebuilt on a survivor by enqueueing that metadata through the
``migrate_in`` install (payload-less: a dropped entry, rebuilt through
prefill), then resumed: token-equal, with the client's ``Request`` and its
stream never changing hands. The ledger reflects everything DELIVERED as
of the last tick head; a dispatch in flight at death was never delivered,
so the rebuild regenerates it: no duplicates, no gaps. Sessions the ledger
never saw started rebuild as re-queues from the fleet's own assignment
record.

Fencing: failover runs on the monitor thread only AFTER the corpse is
fenced (``_stop`` set and its loop thread joined), so no late delivery
races the rebuild. Afterwards the fleet REAPS the corpse's host-side
bookkeeping (slot blocks, parked entries, host-tier pages, queued
requests, unserved lifecycle tickets), so a dead engine's invariants
(allocator free == capacity, nothing parked, no slots) hold as a stopped
engine's do.

Members are engines in this process or fabric proxies
(``vtpu_torch.serving.fabric.RemoteEngine``: an engine in another process
or on another host behind an ``EngineHost``), which route, drain,
rebalance and fail over through the same code path: a proxy's ledger is
its client-side mirror of the tokens delivered across the wire, its reap
drops that mirror, and ``stats()`` sums its channel's ``fabric_*``
counters. A member may serve under ``mesh=``: its sessions migrate through
its adapter's snapshot and upload ops, and a failover rebuilds from the
ledger's token history, as for a one-device member.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from vtpu_torch.obs.fleettrace import FleetTrace
from vtpu_torch.serving.engine import Request, ServingEngine, Status
from vtpu_torch.serving.faults import FaultPlan
from vtpu_torch.serving.migrate import (
    MigrationError,
    _Ticket,
    _ask,
    _snaplist,
    drain_engine,
    migrate,
)
from vtpu_torch.serving.prefixdir import (
    PrefixDirectory,
    export_prefix,
    install_prefix,
    prefix_id,
)
from vtpu_torch.serving.shed import EngineSignals

log = logging.getLogger(__name__)

# engine health states (the supervision ladder)
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"


class RoutePolicy:
    """WHICH engine serves a new request (and receives a drained or
    rebalanced session). Implementations must be pure decisions over the
    snapshot — the fleet owns the actual placement, counters and retry
    loop. Return a float score (highest wins; ties break on engine name,
    so equal fleets route deterministically) or None to remove the
    engine from consideration entirely."""

    def score(self, name: str, signals: EngineSignals) -> Optional[float]:
        raise NotImplementedError


class LeastPressureRoutePolicy(RoutePolicy):
    """The default: most free pool fraction wins, penalized by the
    queue/backlog/occupancy pressure gauges — and by attested device
    duty when a ``duty_supplier`` is wired (route AWAY from chips whose
    device-truth busyness is high, whatever their host queues claim).
    A draining engine scores None: it is evacuating, never a target."""

    def score(self, name: str,
              signals: EngineSignals) -> Optional[float]:
        if signals.draining:
            return None
        s = 0.0
        if signals.pool_blocks:
            s += (signals.pool_free or 0) / signals.pool_blocks
        s -= 0.25 * signals.queue_depth
        s -= 0.10 * signals.active_slots
        s -= 0.10 * signals.prefill_backlog
        s -= 0.02 * signals.parked_sessions
        if signals.duty is not None:
            s -= 0.5 * signals.duty
        return s


def load_route_policy(spec) -> RoutePolicy:
    """Resolve ``FleetConfig.route_policy``: None -> the least-pressure
    default; a ``"module:attr"`` string -> imported (class or instance —
    the user-loadable policy-program hook, byte-for-byte the
    shed.load_shed_policy shape); a class -> instantiated; anything else
    is used as-is (must quack like RoutePolicy)."""
    if spec is None:
        return LeastPressureRoutePolicy()
    if isinstance(spec, str):
        mod, sep, attr = spec.partition(":")
        if not sep or not attr:
            raise ValueError(
                f"route_policy string must be 'module:attr', got {spec!r}")
        spec = getattr(importlib.import_module(mod), attr)
    if isinstance(spec, type):
        spec = spec()
    if not callable(getattr(spec, "score", None)):
        raise ValueError(
            f"route_policy {spec!r} does not implement score(name, signals)")
    return spec


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    # monitor probe cadence. Each round probes every non-DEAD engine in
    # sorted-name order (the determinism the probe_loss seam's arrival
    # indices stand on), then runs the rebalance check.
    probe_interval_ms: float = 20.0
    # heartbeat age past this counts the probe as a MISS. The loop beats
    # at every flush boundary and at least every ~50 ms while idle
    # (_idle_wait), so anything over ~200 ms only trips on a genuinely
    # stalled or dead loop; the generous default also rides out
    # mid-serving executable re-lowers on cold caches.
    miss_ms: float = 1000.0
    # the ladder: consecutive misses to SUSPECT (deprioritized, still
    # serving, NEVER failed over) and to DEAD (fence + failover + reap).
    # A single fresh beat resets the count and restores HEALTHY — the
    # hysteresis that keeps a slow-but-alive engine's streams intact.
    suspect_misses: int = 2
    dead_misses: int = 5
    # RoutePolicy: None = least-pressure default; "module:attr" / class /
    # instance — the shed_policy loading shape.
    route_policy: Optional[Any] = None
    # background rebalancing: when the pool-occupancy FRACTION gap
    # between the most- and least-pressured healthy engines exceeds this,
    # one session migrates per probe round (live preferred — it parks at
    # its flush boundary and resumes on the destination transparently;
    # else a parked session, which resumes on arrival per migrate()'s
    # contract). None = off.
    rebalance_threshold: Optional[float] = None
    # per-session budget for the failover install handshake
    failover_timeout: float = 30.0
    # per-migration budget for a background rebalance move. SHORT on
    # purpose: rebalancing runs on the monitor thread, so a blocking
    # migrate here pauses health probing — a move that cannot finish
    # quickly is abandoned (the session stays put or parked on the
    # source; next round retries) rather than freezing death detection.
    rebalance_timeout: float = 5.0
    # fencing: how long to wait for a DEAD-declared engine's loop thread
    # to join before flagging _died and proceeding (a truly dead thread
    # joins instantly; a wedged one gets its late deliveries gated).
    fence_timeout: float = 5.0
    # deterministic fault plan for the FLEET's own seam (probe_loss);
    # engine-side seams (engine_death, ...) live on each engine's
    # ServingConfig.faults as ever.
    faults: Optional[Any] = None
    # the fleet observability plane (vtpu/obs/fleettrace.FleetTrace):
    # control-event ring capacity. 0 disables the WHOLE plane — no
    # control events, no journey stitching, no flight-recorder bundles —
    # the knob an overhead A/B of the plane flips.
    trace_events: int = 4096
    # bounded journey registry / post-mortem bundle set sizes
    trace_journeys: int = 4096
    trace_bundles: int = 8
    # --- prefix gravity (vtpu/serving/prefixdir) ---------------------
    # hot replication: once a content pid's total hits reach this, the
    # monitor replicates it (one per probe round, through the ordinary
    # chunk-prefill registration — prefix_install_copies stays 0) to the
    # least-pressured routable engine not yet holding it, up to
    # prefix_max_replicas residents. None = replication off.
    prefix_replicate_hits: Optional[int] = None
    prefix_max_replicas: int = 2
    # cold spill: a pid with ZERO live refs whose last hit is older than
    # this many seconds is exported to the fleet host tier (the staged
    # D2H any spill pays) and its resident copy unregistered — one per
    # probe round. Any engine re-installs from the tier on demand.
    # None = spill off.
    prefix_spill_idle_s: Optional[float] = None
    # route-bonus denominator: milliseconds of avoided prefill that
    # "weigh" the same as one queue slot of pressure in the
    # LeastPressure score (the 0.25/slot weight) — smaller values make
    # resident engines win from further behind.
    prefix_queue_slot_ms: float = 100.0


def _ledger_entries(eng: ServingEngine) -> Dict[Request, dict]:
    """One engine's session-ledger snapshot — runs ON THE ENGINE'S LOOP
    THREAD (the single writer of slots/parked/history), at the tick head,
    so it is coherent by construction. Entries carry exactly the metadata
    the migrate handshake ships (_do_migrate_out's meta): cache-contents
    token history, the pending (delivered-but-unwritten) token, remaining
    budget, sequence length, page count, history exactness, priority and
    the prefix identity. Only STARTED sessions are recorded — an
    unstarted one rebuilds from the fleet's assignment record as a plain
    re-queue, and a slot still in async-admission limbo (first token
    sampled on device but not yet delivered) deliberately falls back the
    same way: its client has seen nothing, so a fresh admission is
    token-equal."""
    entries: Dict[Request, dict] = {}
    for slot, req in enumerate(eng._slot_req):
        if req is None or req.status is not None or req.cancelled:
            continue
        hist = eng._history[slot]
        if len(hist) != eng._slot_len[slot] + 1:
            continue  # admission limbo: nothing delivered yet
        entries[req] = {
            "unstarted": False,
            "tokens": list(hist[:-1]),
            # the last DELIVERED token, from the host's history (as a park
            # takes it): on the pipelined loops the next input may sit on
            # the device
            "pending": hist[-1],
            "budget": eng._slot_budget[slot],
            "seq_len": eng._slot_len[slot],
            "n_pages": len(eng._slot_blocks[slot]),
            "hist_exact": bool(eng._slot_hist_exact[slot]),
            "priority": req.priority,
            # prefix identity: a survivor holding the same content pid
            # resident re-shares it at rebuild instead of recomputing
            "pid": (eng._slot_pid[slot][0]
                    if eng._slot_pid[slot] is not None else None),
            "prefix_len": (eng._slot_pid[slot][1]
                           if eng._slot_pid[slot] is not None else 0),
        }
    for req, e in eng._parked.items():
        if req.status is not None or req.cancelled or e.get("unstarted"):
            continue
        entries[req] = {
            "unstarted": False,
            "tokens": list(e["tokens"]),
            "pending": e["pending"],
            "budget": e["budget"],
            "seq_len": e["seq_len"],
            "n_pages": e["n_pages"],
            "hist_exact": bool(e.get("hist_exact", True)),
            "priority": e["priority"],
            "pid": e.get("pid"),
            "prefix_len": int(e.get("prefix_len") or 0),
        }
    return entries


def _unstarted_meta(req: Request) -> dict:
    """Rebuild metadata for a session the ledger never saw started: an
    unstarted install re-queues the request through the destination's
    ordinary admission (the migrate 'requeue' path) — the client has
    seen no tokens, so a fresh admission is exactly the stream it was
    promised."""
    return {"unstarted": True, "tokens": [], "pending": None, "budget": 0,
            "seq_len": 0, "n_pages": 0, "hist_exact": True,
            "priority": req.priority}


def sweep_corpse(eng: ServingEngine, finish=None) -> None:
    """Release everything a dead engine's loop held: slot blocks and
    rows, admissions in flight, parked entries and their host-tier pages,
    the waiting line and pending submits, prefix builds (failed) and
    unserved lifecycle tickets (failed), so a corpse's invariants
    (allocator free == capacity, nothing parked, no slots) hold as a
    stopped engine's do. ``finish(req)`` sees every request met on the way
    (the fleet's reap delivers the typed terminals it owes there); None
    sweeps silently, as an engine host supervising its own corpse does.
    Only the caller may touch the engine's structures: its loop is gone."""
    eng._stop.set()
    fin = finish if finish is not None else (lambda req: None)
    for slot in range(eng.serving.slots):
        fin(eng._slot_req[slot])
        eng._free_slot_blocks(slot)
        eng._slot_req[slot] = None
        eng._slot_budget[slot] = 0
        eng._slot_len[slot] = 0
        eng._history[slot] = []
        eng._slot_hist_exact[slot] = True
        eng._itl_last[slot] = None
        eng._admit_mask[slot] = False
    for slot, adm in list(eng._admitting.items()):
        fin(adm["req"])
    eng._admitting.clear()
    eng._pending_firsts = []
    eng._inflight_slots = set()
    for req in list(eng._parked):
        fin(req)
        eng._release_parked(eng._parked.pop(req))
    eng._want_park.clear()
    eng._park_unseen.clear()
    eng._want_resume.clear()
    eng._swap_pending.clear()
    for req in eng._waiting:
        fin(req)
    eng._waiting.clear()
    while True:
        try:
            req = eng._pending.get_nowait()
        except queue.Empty:
            break
        fin(req)
    while True:
        try:
            item = eng._prefix_work.get_nowait()
        except queue.Empty:
            break
        item["error"] = RuntimeError("engine died")
        item["done"].set()
    while True:
        try:
            kind, item = eng._lifecycle_q.get_nowait()
        except queue.Empty:
            break
        if kind in ("migrate_out", "migrate_in",
                    "prefix_out", "prefix_in"):
            item.fail(RuntimeError(
                "engine died before serving the ticket"))


class EngineFleet:
    """N ServingEngines behind one ``submit()`` front door, with
    health-checked supervision, signal-driven routing, and automatic
    session failover (see the module docstring for the architecture).

    ``engines`` is a ``{name: ServingEngine}`` dict (or an iterable,
    auto-named e0..eN-1). Every engine needs ``ServingConfig.kv_swap``
    (the park/serialize machinery the ledger, drain and failover all
    stand on) and identical block geometry (sessions move between them);
    disaggregated engines are rejected — failover has no reap/rebuild
    path for worker-owned state yet (drain/migrate compose fine).
    The fleet installs each engine's ledger hook at ``start()`` and runs
    one monitor thread; ``stop()`` stops the monitor, then the engines.
    """

    def __init__(self, engines, fleet: FleetConfig = FleetConfig()):
        if isinstance(engines, dict):
            self._engines: Dict[str, ServingEngine] = dict(engines)
        else:
            self._engines = {f"e{i}": e for i, e in enumerate(engines)}
        if len(self._engines) < 2:
            raise ValueError(
                "an EngineFleet needs at least 2 engines (failover and "
                f"drain need a survivor), got {len(self._engines)}")
        for name, eng in self._engines.items():
            if not isinstance(name, str) or not name:
                raise ValueError(f"engine names must be non-empty strings, "
                                 f"got {name!r}")
            if not getattr(eng, "_swap_enabled", False):
                raise ValueError(
                    f"fleet engine {name!r} needs ServingConfig.kv_swap: "
                    "the session ledger, drain and failover all ride the "
                    "park/serialize machinery (kv_swap=0 is enough for "
                    "recompute-only fleets)")
            if getattr(eng, "_disagg", None) is not None:
                raise ValueError(
                    f"fleet engine {name!r} is disaggregated: fleet "
                    "FAILOVER does not compose with disagg yet — a dead "
                    "engine's worker-owned sessions and completed-handoff "
                    "blocks have no reap/rebuild path (drain/migrate "
                    "compose fine; use ServingEngine.drain for disagg "
                    "engines)")
        names = sorted(self._engines)
        ref = self._engines[names[0]]
        for name in names[1:]:
            eng = self._engines[name]
            if eng._page != ref._page or eng._swap_planes != ref._swap_planes:
                raise ValueError(
                    f"fleet engines {names[0]!r} and {name!r} have "
                    "incompatible pool geometry (kv_page / KV planes): "
                    "sessions cannot move between them")
        if fleet.faults is not None and not isinstance(fleet.faults,
                                                       FaultPlan):
            raise ValueError(
                "FleetConfig.faults must be a vtpu_torch.serving.faults."
                f"FaultPlan, got {type(fleet.faults).__name__}")
        if fleet.suspect_misses < 1 or fleet.dead_misses < fleet.suspect_misses:
            raise ValueError(
                f"need 1 <= suspect_misses <= dead_misses, got "
                f"{fleet.suspect_misses}/{fleet.dead_misses}")
        if fleet.probe_interval_ms <= 0 or fleet.miss_ms <= 0:
            raise ValueError("probe_interval_ms and miss_ms must be > 0")
        self.fleet = fleet
        self._policy = load_route_policy(fleet.route_policy)
        self._faults = fleet.faults
        self._mu = threading.Lock()
        self._health: Dict[str, str] = {n: HEALTHY for n in self._engines}
        self._miss: Dict[str, int] = {n: 0 for n in self._engines}
        # the session ledger: engine name -> {Request: recovery metadata},
        # replaced wholesale by each engine's flush-boundary hook
        self._ledger: Dict[str, Dict[Request, dict]] = {}
        # the fleet's own routing record: every request submit() placed,
        # and where it lives NOW (updated by drain/rebalance/failover).
        # This is what guarantees a request the ledger never saw is still
        # rebuilt (as an unstarted re-queue) when its engine dies.
        self._assigned: Dict[Request, str] = {}
        # requests with a rebuild IN FLIGHT: the failover sweep and the
        # submit straggler corner can race to recover the same request —
        # the claim makes the rebuild exactly-once (the loser trusts the
        # winner's outcome). Cleared when the rebuild settles, so a
        # session that later loses its SECOND engine rebuilds again.
        self._rebuilding: set = set()
        self._fstats = {
            "failovers": 0,           # DEAD engines failed over
            "failover_sessions": 0,   # sessions rebuilt on survivors
            "failover_faulted": 0,    # sessions no survivor could rebuild
            "reroutes": 0,            # submits retargeted off a closed door
            "rebalance_migrations": 0,
            "probe_misses": 0,        # probes counted as missed (ladder fuel)
            "probes": 0,              # monitor rounds completed
            "suspects": 0,            # HEALTHY->SUSPECT transitions
            # prefix gravity (vtpu/serving/prefixdir):
            "prefix_routes": 0,       # submits routed onto a resident
            "prefix_replications": 0,  # hot prefixes copied to a peer
            "prefix_spills": 0,       # cold prefixes moved to host tier
            "prefix_installs": 0,     # host-tier installs back into pools
        }
        self._stop_ev = threading.Event()
        self._mon: Optional[threading.Thread] = None
        # the fleet observability plane: per-engine rings attached under
        # their fleet names (sorted, so merged-dump pids are stable for
        # equal fleets), journeys keyed by the jid submit() stamps
        self.trace = FleetTrace(capacity=fleet.trace_events,
                                max_journeys=fleet.trace_journeys,
                                max_bundles=fleet.trace_bundles)
        for name in sorted(self._engines):
            self.trace.attach(name, self._engines[name].trace)
        # the fleet-owned prefix directory: WHERE each content-addressed
        # prefix lives (resident engines with live refcounts, host-tier
        # payloads), fed by per-engine listeners installed at start()
        self.prefixdir = PrefixDirectory(
            queue_slot_ms=fleet.prefix_queue_slot_ms)

    # ------------------------------------------------------------- lifecycle

    @property
    def engines(self) -> Dict[str, ServingEngine]:
        return dict(self._engines)

    def start(self) -> None:
        """Install the ledger hooks, start any engine not yet started,
        and start the monitor thread."""
        for name in sorted(self._engines):
            eng = self._engines[name]
            eng._ledger_hook = self._make_hook(name)
            if not getattr(eng, "is_remote", False):
                # local members report prefix register/hit/release events
                # straight into the directory; remote members' events stay
                # on their host, so the fleet updates the directory from the
                # ask results and route bookkeeping instead
                eng._prefix_listener = self._make_prefix_listener(name)
            if eng._thread is None:
                eng.start()
        self._mon = threading.Thread(target=self._monitor, daemon=True)
        self._mon.start()

    def stop(self) -> None:
        """Stop the monitor, then every engine (dead ones were already
        fenced and reaped; live ones run their ordinary shutdown sweep)."""
        self._stop_ev.set()
        if self._mon is not None:
            self._mon.join(timeout=10)
        for eng in self._engines.values():
            eng.stop()
        # every stream now carries a terminal (the engines' shutdown
        # sweeps deliver CANCELLED to stragglers): close their journeys
        # so a post-shutdown journeys() read sees only ended spans
        self._prune_assigned()

    def _make_hook(self, name: str):
        def hook(eng, _name=name):
            # a fabric proxy derives its ledger from the client-side mirror
            # (tokens actually delivered across the wire): the host's own
            # ledger is unreadable once the host is SIGKILLed, which is
            # exactly when this matters
            fn = getattr(eng, "ledger_entries", None)
            entries = fn() if fn is not None else _ledger_entries(eng)
            with self._mu:
                self._ledger[_name] = entries
        return hook

    def _make_prefix_listener(self, name: str):
        def listener(event, pid, _name=name, **kw):
            self.prefixdir.on_event(_name, event, pid, **kw)
        return listener

    # --------------------------------------------------------------- routing

    def _routable(self, exclude: Iterable[str] = ()) -> List[str]:
        """Engines a request (or a migrating session) may land on:
        started, not DEAD, not fenced, not draining."""
        exclude = set(exclude)
        with self._mu:
            states = dict(self._health)
        out = []
        for name in sorted(self._engines):
            if name in exclude:
                continue
            eng = self._engines[name]
            if states.get(name) == DEAD or eng._died or eng._draining:
                continue
            if eng._thread is None or eng._stop.is_set():
                continue
            out.append(name)
        return out

    def _route_ranked(self, exclude: Iterable[str] = ()) \
            -> List[tuple]:
        """Candidate engines best-first as (name, score) pairs: HEALTHY
        before SUSPECT (a suspect engine still serves, but new work
        prefers proven-alive peers), policy score descending within a
        tier, name ascending on ties — fully deterministic for equal
        fleets. The score rides along so routing decisions can be
        recorded next to the inputs that made them (FleetTrace)."""
        with self._mu:
            states = dict(self._health)
        ranked = []
        for name in self._routable(exclude):
            eng = self._engines[name]
            score = self._policy.score(name, eng.signals())
            if score is None:
                continue
            ranked.append((states.get(name) == SUSPECT, -float(score), name))
        ranked.sort()
        return [(name, -neg) for _, neg, name in ranked]

    def _route_order(self, exclude: Iterable[str] = ()) -> List[str]:
        return [name for name, _ in self._route_ranked(exclude)]

    def _host_of(self, name: str) -> str:
        """The placement host a journey hop records: a fabric proxy
        carries its EngineHost's label, an in-proc member is 'local'."""
        return getattr(self._engines[name], "host", "local")

    def submit(self, tokens, max_new_tokens: int = 0, priority: int = 0,
               deadline_ms: Optional[float] = None, prefix_tokens=None,
               pid: Optional[str] = None) -> Request:
        """The fleet's front door: route to the best-scored engine and
        return its Request. A door that turns out closed (draining or
        stopping — the drain/submit race) re-routes to the next candidate
        (``reroutes`` counts it); a submit that lands in the flip gap on
        a now-draining engine is rescued by migrating it straight off.

        ``prefix_tokens`` (the shared prompt's token list) or ``pid`` (a
        content pid from ``register_prefix``) makes the route PREFIX-
        AWARE: the directory is consulted before scoring, a resident
        engine's score gets the avoided-prefill bonus, and the winning
        submit ships only the suffix (falling back to the full prompt
        when the prefix lives nowhere). Engine-LOCAL prefix ids never
        cross this door — they only mean something to the engine that
        minted them."""
        if prefix_tokens is not None or pid is not None:
            return self._submit_prefix(tokens, max_new_tokens, priority,
                                       deadline_ms, prefix_tokens, pid)
        last: Optional[BaseException] = None
        for name, score in self._route_ranked():
            eng = self._engines[name]
            try:
                req = eng.submit(tokens, max_new_tokens=max_new_tokens,
                                 priority=priority, deadline_ms=deadline_ms)
            except RuntimeError as exc:
                # stopped or draining: the door closed between scoring
                # and knocking — the drain/submit race, resolved by
                # walking to the next candidate
                last = exc
                with self._mu:
                    self._fstats["reroutes"] += 1
                self.trace.control("reroute", engine=name)
                continue
            # journey opens BEFORE the assignment publishes: the moment
            # _assigned carries the request, the monitor's prune pass (or
            # a failover sweep) may act on it — both need the jid already
            # stamped, or a fast-finishing request would leak an
            # unclosable journey. The winning score sits in the route
            # event so the policy verdict is auditable.
            req.jid = self.trace.begin_journey(name, req.rid,
                                               host=self._host_of(name))
            self.trace.control("route", engine=name, jid=req.jid,
                               score=score)
            with self._mu:
                self._assigned[req] = name
                swept = self._health.get(name) == DEAD
            return self._settle_placement(req, name, eng, swept)
        raise RuntimeError(
            f"no routable engine in the fleet ({last!r})" if last is not None
            else "no routable engine in the fleet")

    def _settle_placement(self, req: Request, name: str,
                          eng: ServingEngine, swept: bool) -> Request:
        """The two submit/death races every placement path closes after
        the enqueue landed and the assignment published."""
        if swept and req.status is None:
            # the narrowest corner: the engine died between scoring
            # and enqueue AND its failover already swept the
            # assignment set — nobody else will ever see this
            # request, so re-place it ourselves (it never started:
            # an unstarted re-queue is token-equal by construction)
            if not self._rebuild(req, _unstarted_meta(req),
                                 exclude=name):
                req.finish(Status.FAULTED)
                with self._mu:
                    self._fstats["failover_faulted"] += 1
            return req
        if eng._draining and not eng._died:
            # the OTHER half of the race: drain flipped between the
            # engine's own admission check and the enqueue, so the
            # request landed on a draining engine — migrate it off
            # (the drain loop would also catch it; whichever runs
            # first wins, the loser observes 'gone'). A DIED engine
            # is deliberately NOT rescued here: migrate() needs the
            # source's loop thread, which is gone — the request is
            # already in _assigned, and the failover rebuild is the
            # path that recovers it.
            with self._mu:
                self._fstats["reroutes"] += 1
            self._rescue(req, name)
        return req

    # ------------------------------------------------------- prefix gravity

    def register_prefix(self, prefix_tokens, engine=None) -> str:
        """Register a shared prompt prefix ONCE somewhere in the fleet
        and return its content pid — the fleet-level name
        ``submit(pid=...)`` routes by. ``engine`` pins the build to one
        member; by default the best-scored routable engine builds it
        (and a pid already resident anywhere returns immediately — the
        registration is content-addressed, so it is idempotent across
        the fleet)."""
        toks = [int(x) for x in np.asarray(prefix_tokens,
                                           np.int32).tolist()]
        cpid = prefix_id(toks)
        if engine is None:
            order = self._route_order()
            if not order:
                raise RuntimeError(
                    "no routable engine to register the prefix on")
            residents = self.prefixdir.residents(cpid)
            if any(n in residents for n in order):
                return cpid
            name = order[0]
        else:
            name = self._resolve(engine)
        eng = self._engines[name]
        lid = eng.register_prefix(toks)
        if getattr(eng, "is_remote", False):
            # a remote build reported to ITS host, not to this directory:
            # mirror the registration from the proxy's client-side record
            meta = eng._prefix_meta[lid]
            self.prefixdir.on_event(
                name, "register", cpid, lid=lid, tokens=toks,
                length=meta["len"], build_ms=meta.get("build_ms"))
        return cpid

    def _submit_prefix(self, tokens, max_new_tokens: int, priority: int,
                       deadline_ms: Optional[float], prefix_tokens,
                       pid: Optional[str]) -> Request:
        """The prefix-aware route: rank every candidate on policy score
        PLUS the directory bonus for residents (the policy itself stays
        pure — residency rides ``signals.prefix_resident_tokens``), then
        place on the winner: suffix-only onto a resident, tier-install-
        then-suffix when only the host tier holds it, full prompt when
        the prefix lives nowhere (a directory miss)."""
        if prefix_tokens is not None:
            ptoks = [int(x) for x in np.asarray(prefix_tokens,
                                                np.int32).tolist()]
            cpid = prefix_id(ptoks)
            if pid is not None and pid != cpid:
                raise ValueError(
                    f"prefix_tokens hash to pid {cpid!r} but pid={pid!r} "
                    "was passed — they name different prefixes")
        else:
            cpid = pid
            ptoks = self.prefixdir.tokens_of(cpid)
            if ptoks is None:
                raise ValueError(
                    f"unknown prefix pid {cpid!r}: pass prefix_tokens "
                    "(or register_prefix first) so the fleet can fall "
                    "back to a full-prompt submit")
        plen = len(ptoks)
        residents = self.prefixdir.residents(cpid)
        bonus_val = self.prefixdir.route_bonus(plen)
        with self._mu:
            states = dict(self._health)
        ranked = []
        for name in self._routable():
            eng = self._engines[name]
            sig = eng.signals()
            if name in residents:
                # the policy sees exactly what the bonus priced: tokens
                # of THIS request's prefix resident on this engine
                sig = dataclasses.replace(sig, prefix_resident_tokens=plen)
            score = self._policy.score(name, sig)
            if score is None:
                continue
            b = bonus_val if name in residents else 0.0
            ranked.append((states.get(name) == SUSPECT,
                           -(float(score) + b), name, b))
        ranked.sort()
        last: Optional[BaseException] = None
        for suspect, neg, name, b in ranked:
            eng = self._engines[name]
            total = -neg
            lid = residents.get(name)
            routed_resident = lid is not None
            if lid is None and self.prefixdir.in_host_tier(cpid):
                lid = self._install_from_tier(name, cpid)
            try:
                if lid is not None:
                    try:
                        req = eng.submit(tokens,
                                         max_new_tokens=max_new_tokens,
                                         prefix=lid, priority=priority,
                                         deadline_ms=deadline_ms)
                    except ValueError:
                        # unregistered in the gap (a racing spill):
                        # same engine, full prompt — still the winner
                        lid = None
                if lid is None:
                    full = list(ptoks) + [
                        int(x) for x in np.asarray(tokens,
                                                   np.int32).tolist()]
                    req = eng.submit(full, max_new_tokens=max_new_tokens,
                                     priority=priority,
                                     deadline_ms=deadline_ms)
            except RuntimeError as exc:
                last = exc
                with self._mu:
                    self._fstats["reroutes"] += 1
                self.trace.control("reroute", engine=name)
                continue
            if lid is not None:
                with self._mu:
                    self._fstats["prefix_routes"] += 1
                if getattr(eng, "is_remote", False):
                    # local residents stamp the hit at the share (the
                    # loop-thread listener); a remote's share happens on
                    # another host, so the route stamps it here
                    self.prefixdir.note_route_hit(cpid, name)
            else:
                self.prefixdir.note_miss()
            req.jid = self.trace.begin_journey(
                name, req.rid, host=self._host_of(name),
                prefix=lid is not None and b > 0)
            self.trace.control("route", engine=name, jid=req.jid,
                               score=total, bonus=b)
            with self._mu:
                self._assigned[req] = name
                swept = self._health.get(name) == DEAD
            return self._settle_placement(req, name, eng, swept)
        raise RuntimeError(
            f"no routable engine in the fleet ({last!r})" if last is not None
            else "no routable engine in the fleet")

    def _install_from_tier(self, name: str, cpid: str) -> Optional[int]:
        """Best-effort host-tier install of *cpid* into engine *name*
        (the once-per-engine staged H2D); None when the tier has no
        payload or the install fails — the caller falls back to a full-
        prompt submit, never an error."""
        got = self.prefixdir.get_host(cpid)
        if got is None:
            return None
        meta, payload = got
        eng = self._engines[name]
        try:
            res = install_prefix(eng, meta, payload,
                                 timeout=self.fleet.failover_timeout)
        except MigrationError as exc:
            log.warning("host-tier prefix install of %s on %s failed: "
                        "%s", cpid, name, exc)
            return None
        if getattr(eng, "is_remote", False):
            self.prefixdir.on_event(
                name, "register", cpid, lid=res["lid"],
                tokens=meta["tokens"], length=meta["len"])
        if res.get("installed", True):
            with self._mu:
                self._fstats["prefix_installs"] += 1
            self.trace.control("prefix_install", engine=name,
                               val=int(meta["len"]))
        return res["lid"]

    def _ensure_prefix_on(self, name: str, cpid: str) -> None:
        """Make *cpid* resident on engine *name* from wherever it still
        lives: already resident -> done; host tier -> staged install;
        another live resident -> cross-engine copy over the prefix_out/
        prefix_in pair (fabric asks for remote members). Raises only
        MigrationError-shaped failures the caller treats as advisory."""
        residents = self.prefixdir.residents(cpid)
        if name in residents:
            return
        if self.prefixdir.in_host_tier(cpid):
            self._install_from_tier(name, cpid)
            return
        donor = next((n for n in self._routable(exclude={name})
                      if n in residents), None)
        if donor is None:
            return
        meta, payload = export_prefix(self._engines[donor],
                                      residents[donor],
                                      timeout=self.fleet.failover_timeout)
        res = install_prefix(self._engines[name], meta, payload,
                             timeout=self.fleet.failover_timeout)
        if getattr(self._engines[name], "is_remote", False):
            self.prefixdir.on_event(
                name, "register", cpid, lid=res["lid"],
                tokens=meta["tokens"], length=meta["len"])
        if res.get("installed", True):
            with self._mu:
                self._fstats["prefix_installs"] += 1
            self.trace.control("prefix_install", engine=name,
                               val=int(meta["len"]))

    def _rescue(self, req: Request, src_name: str) -> None:
        """Move a straggler off a draining engine. Best-effort by
        design: a MigrationError here means the drain loop (or the
        session's own completion) got there first."""
        src = self._engines[src_name]
        for dst_name in self._route_order(exclude={src_name}):
            try:
                rep = migrate(req, src, self._engines[dst_name])
            except MigrationError:
                continue
            if rep["path"] in ("resident", "host", "recompute", "requeue"):
                with self._mu:
                    self._assigned[req] = dst_name
                self.trace.hop(req.jid, dst_name, req.rid, "rescue",
                               host=self._host_of(dst_name))
                self.trace.control("reroute", engine=dst_name, jid=req.jid)
            return

    # ----------------------------------------------------------------- drain

    def _resolve(self, engine) -> str:
        if isinstance(engine, str):
            if engine not in self._engines:
                raise KeyError(f"unknown fleet engine {engine!r}")
            return engine
        for name, eng in self._engines.items():
            if eng is engine:
                return name
        raise KeyError("engine is not a member of this fleet")

    def drain(self, engine, timeout: float = 120.0) -> dict:
        """The rolling evacuation, routed: `migrate.drain_engine`
        with the destination chosen PER SESSION by the route policy (the
        best-scored survivor at that moment, so a long drain spreads
        over the fleet instead of dog-piling one destination) and the
        fleet's assignment record riding the on_migrated hook. The
        drain/submit race is covered twice over: a straggler that
        enqueued in the flip gap surfaces in the drain's live-session
        snapshot, and submit()'s own post-enqueue check rescues it
        independently — whichever runs first wins."""
        name = self._resolve(engine)
        src = self._engines[name]
        names = {eng: n for n, eng in self._engines.items()}

        def choose(req):
            order = self._route_order(exclude={name})
            if not order:
                raise MigrationError(
                    "fleet drain has no routable survivor to evacuate "
                    "onto")
            return self._engines[order[0]]

        def placed(req, target):
            with self._mu:
                self._assigned[req] = names[target]
            self.trace.hop(req.jid, names[target], req.rid, "drain",
                           host=self._host_of(names[target]))

        self.trace.control("drain_start", engine=name)
        try:
            rep = drain_engine(src, timeout=timeout, choose_dst=choose,
                               on_migrated=placed)
        except MigrationError:
            self.trace.control("drain_end", engine=name, val=-1)
            raise
        self.trace.control("drain_end", engine=name, val=rep["migrated"])
        return rep

    def migrate_session(self, request: Request, dst,
                        timeout: float = 60.0) -> dict:
        """Explicitly move one fleet-tracked session onto *dst* through
        the migration primitive, keeping the assignment record and journey
        trace consistent — the operator's by-hand form of the move the
        rebalancer and drain perform themselves. Returns migrate()'s
        report dict."""
        dst_name = self._resolve(dst)
        with self._mu:
            src_name = self._assigned.get(request)
        if src_name is None:
            raise MigrationError(
                "request is not tracked by this fleet (submit it through "
                "fleet.submit, or it already finished)")
        if src_name == dst_name:
            raise MigrationError(
                f"request already lives on engine {dst_name!r}")
        rep = migrate(request, self._engines[src_name],
                      self._engines[dst_name], timeout=timeout)
        if rep["path"] in ("resident", "host", "recompute", "requeue"):
            with self._mu:
                self._assigned[request] = dst_name
            self.trace.hop(request.jid, dst_name, request.rid, "migrate",
                           host=self._host_of(dst_name))
        return rep

    # ----------------------------------------------------------- supervision

    def _monitor(self) -> None:
        while not self._stop_ev.wait(self.fleet.probe_interval_ms / 1e3):
            try:
                self._probe_round()
            except Exception:  # pragma: no cover - supervisor must survive
                log.exception("fleet probe round raised; continuing")

    def _probe_round(self) -> None:
        """One probe pass over every non-DEAD engine, in sorted-name
        order (the probe_loss seam's arrival indices are defined by this
        order). A probe misses when the heartbeat is older than miss_ms
        — or when the probe_loss seam eats it — and consecutive misses
        walk the SUSPECT -> DEAD ladder; any fresh beat resets the count
        and restores HEALTHY. An engine that has never beaten is still
        WARMING (executable compiles take seconds) and its age never
        counts as a miss."""
        dead_now: List[str] = []
        for name in sorted(self._engines):
            with self._mu:
                if self._health[name] == DEAD:
                    continue
            eng = self._engines[name]
            lost = bool(self._faults.fire("probe_loss")) \
                if self._faults is not None else False
            beat = eng._beat_ns
            warming = beat == 0
            stale = (not warming
                     and (time.monotonic_ns() - beat)
                     > self.fleet.miss_ms * 1e6)
            if not (lost or stale):
                with self._mu:
                    self._miss[name] = 0
                    if self._health[name] == SUSPECT:
                        self._health[name] = HEALTHY
                continue
            # the decision inputs ride the control event: a miss is rare
            # (never on the healthy steady state), so snapshotting the
            # engine's signals here costs nothing the hot path pays
            try:
                sig = eng.signals()
            except Exception:  # pragma: no cover - a corpse may refuse
                sig = None
            went_suspect = went_dead = False
            with self._mu:
                self._fstats["probe_misses"] += 1
                self._miss[name] += 1
                n = self._miss[name]
                if n >= self.fleet.dead_misses:
                    # DEAD: routing stops the moment the state flips —
                    # fencing/failover/reap run after the lock drops
                    self._health[name] = DEAD
                    dead_now.append(name)
                    went_dead = True
                elif (n >= self.fleet.suspect_misses
                      and self._health[name] == HEALTHY):
                    self._health[name] = SUSPECT
                    self._fstats["suspects"] += 1
                    went_suspect = True
            self.trace.control("probe_miss", engine=name, val=n,
                               signals=sig)
            if went_suspect:
                self.trace.control("suspect", engine=name, val=n)
            if went_dead:
                self.trace.control("dead", engine=name, val=n)
        for name in dead_now:
            try:
                self._failover(name)
            except Exception:  # pragma: no cover - must not kill the monitor
                log.exception("failover of engine %r raised", name)
        with self._mu:
            self._fstats["probes"] += 1
        self._maybe_rebalance()
        self._prune_assigned()
        try:
            self._prefix_gravity()
        except Exception:  # pragma: no cover - must not kill the monitor
            log.exception("prefix gravity pass raised")

    def _prefix_gravity(self) -> None:
        """The directory's background actuators, one action of each kind
        per probe round (the rebalance cadence): REPLICATE the hottest
        under-replicated prefix onto the least-pressured non-resident
        survivor (the chunked-prefill build path — zero staged copies,
        so ``prefix_install_copies`` stays 0), and
        SPILL the coldest zero-ref prefix to the shared host tier so ANY
        engine can install it later. Both are best-effort and opt-in via
        FleetConfig (None disables each)."""
        fc = self.fleet
        if fc.prefix_replicate_hits is not None:
            routable = self._routable()
            got = self.prefixdir.hot_candidate(
                fc.prefix_replicate_hits, fc.prefix_max_replicas, routable)
            if got is not None:
                pid, toks, _donor = got
                residents = self.prefixdir.residents(pid)
                target = next((n for n in self._route_order()
                               if n not in residents), None)
                if target is not None:
                    dst = self._engines[target]
                    lid = dst.register_prefix(toks)
                    if getattr(dst, "is_remote", False):
                        meta = dst._prefix_meta[lid]
                        self.prefixdir.on_event(
                            target, "register", pid, lid=lid, tokens=toks,
                            length=meta["len"],
                            build_ms=meta.get("build_ms"))
                    with self._mu:
                        self._fstats["prefix_replications"] += 1
                    self.trace.control("prefix_replicate", engine=target,
                                       val=len(toks))
        if fc.prefix_spill_idle_s is not None:
            got = self.prefixdir.cold_candidate(
                fc.prefix_spill_idle_s, self._routable())
            if got is not None:
                pid, name, lid = got
                eng = self._engines[name]
                if not self.prefixdir.in_host_tier(pid):
                    meta, payload = export_prefix(
                        eng, lid, timeout=fc.failover_timeout)
                    self.prefixdir.put_host(pid, meta, payload)
                eng.unregister_prefix(lid)
                if getattr(eng, "is_remote", False):
                    self.prefixdir.on_event(name, "unregister", pid,
                                            lid=lid)
                with self._mu:
                    self._fstats["prefix_spills"] += 1
                self.trace.control("prefix_spill", engine=name,
                                   val=int(self.prefixdir.in_host_tier(pid)))

    def _prune_assigned(self) -> None:
        with self._mu:
            done = [r for r, _ in self._assigned.items()
                    if r.status is not None]
            for req in done:
                del self._assigned[req]
        for req in done:
            # close the journey at the terminal: delivered is the
            # engine-agnostic count the client actually received — the
            # denominator of the stitch's token-conservation contract
            self.trace.end_journey(req.jid, req.delivered, req.status)

    # -------------------------------------------------------------- failover

    def _failover(self, name: str) -> None:
        """An engine died without saying goodbye: fence the corpse,
        rebuild every session it held on survivors from the ledger (plus
        the fleet's assignment record for sessions the ledger never saw
        started), and reap its host-side bookkeeping. Runs on the
        monitor thread; by the time any rebuild starts the loop thread
        is confirmed gone (or fenced), so nothing races the metadata."""
        eng = self._engines[name]
        # FENCE: a declared-dead engine must never speak again. A truly
        # dead loop joins instantly; a wedged-but-alive one (a false
        # positive the hysteresis should have prevented) exits at its
        # next _stop check — and its shutdown sweep then cancels its own
        # streams BEFORE we read their statuses below, so a fenced-alive
        # engine degrades to typed CANCELLED terminals, never to
        # duplicate tokens on two engines.
        eng._stop.set()
        eng._wake.set()
        t = eng._thread
        if t is not None:
            t.join(self.fleet.fence_timeout)
            if t.is_alive():  # pragma: no cover - wedged-thread corner
                eng._died = True  # gate any late shutdown delivery
                log.warning("fleet: engine %r did not fence within %.1fs; "
                            "late deliveries gated", name,
                            self.fleet.fence_timeout)
        self.trace.control("fence", engine=name)
        # the corpse's prefix replicas are gone with it: drop its column
        # from the directory NOW so the rebuilds below (and every racing
        # route) only see surviving residents — replicas elsewhere and
        # the host tier keep the pids alive
        self.prefixdir.drop_engine(name)
        # FLIGHT RECORDER: snapshot the corpse's ring, stats, signals and
        # ledger census into the post-mortem bundle NOW — after the fence
        # (the state is quiescent) and before the rebuild/reap mutate the
        # very bookkeeping a post-mortem needs to read
        with self._mu:
            ledger_census = dict(self._ledger.get(name, {}))
        try:
            self.trace.flight_record(name, eng, ledger_census)
        except Exception:  # pragma: no cover - recorder must not block
            log.exception("flight recorder failed for engine %r", name)
        with self._mu:
            ledger = dict(self._ledger.pop(name, {}))
            assigned = [r for r, n in self._assigned.items() if n == name]
            placement = dict(self._assigned)
        sessions = list(ledger)
        for req in assigned:
            if req not in ledger:
                sessions.append(req)
        spared: set = set()
        for req in sessions:
            if req.status is not None:
                continue
            owner = placement.get(req)
            if owner is not None and owner != name:
                # the ledger lags one flush: this session was migrated
                # OFF the corpse (drain/rebalance/rescue) after its last
                # record and lives on another engine — rebuilding it here
                # would fork the stream
                spared.add(req)
                continue
            if req.cancelled:
                # the client abandoned it; honor the typed terminal the
                # dead engine never delivered (finish is idempotent, so
                # a racing completer collapses to one sentinel)
                req.finish(req._abort or Status.CANCELLED)
                spared.add(req)
                continue
            meta = ledger.get(req)
            if meta is None:
                if req.prefix is not None or req.delivered:
                    # nothing anywhere can rebuild it honestly: its
                    # prefix registration died with the engine, or the
                    # client has already seen tokens the ledger never
                    # recorded (a migrated-in session killed before its
                    # first flush record) — an unstarted re-queue would
                    # REPLAY delivered tokens, so FAULT typed instead
                    req.finish(Status.FAULTED)
                    with self._mu:
                        self._fstats["failover_faulted"] += 1
                    spared.add(req)
                    continue
                meta = _unstarted_meta(req)
            if self._rebuild(req, meta, exclude=name):
                spared.add(req)
            else:
                req.finish(Status.FAULTED)
                with self._mu:
                    self._fstats["failover_faulted"] += 1
                spared.add(req)
        with self._mu:
            self._fstats["failovers"] += 1
        self._reap(eng, spared)

    def _rebuild(self, req: Request, meta: dict, exclude: str) -> bool:
        """Install one session's recovery metadata on the best-scored
        survivor through the payload-less migrate_in path and resume it.
        Returns True when SOME survivor served the install (whatever the
        outcome — a settled/faulted answer is still an answer), False
        when no survivor could be asked at all (the caller faults the
        session typed rather than leaving it hanging). Exactly-once per
        request across concurrent recoverers: a racing caller loses the
        claim and trusts the winner's outcome."""
        with self._mu:
            if req in self._rebuilding:
                return True
            self._rebuilding.add(req)
        t0 = time.perf_counter()
        try:
            for dst_name in self._route_order(exclude={exclude}):
                dst = self._engines[dst_name]
                pid = meta.get("pid")
                if pid is not None:
                    # the session rode a shared prefix: make it resident
                    # on the survivor BEFORE the install so the recompute
                    # path shares those blocks and replays only the
                    # private tail (failover_prefix_reuses). Best-effort:
                    # a full recompute is correct, just slower.
                    try:
                        self._ensure_prefix_on(dst_name, pid)
                    except Exception:  # pragma: no cover - never fatal
                        log.exception("prefix %s pre-stage on %r failed",
                                      pid, dst_name)
                ticket = _Ticket(req, meta=dict(meta), payload=None)
                try:
                    res = _ask(dst, "migrate_in", ticket,
                               self.fleet.failover_timeout)
                except MigrationError:
                    continue  # try the next survivor
                if res["path"] in ("resident", "host", "recompute",
                                  "requeue"):
                    if req.deadline_ns is not None:
                        # the survivor may never have seen a deadline
                        # submit; open its per-tick deadline sweep
                        dst._deadlines_seen = True
                    dst.resume(req)
                    with self._mu:
                        self._assigned[req] = dst_name
                        self._fstats["failover_sessions"] += 1
                    # journey hop under the session's FRESH destination
                    # rid (migrate_in reassigned it); rebuild latency =
                    # claim -> resumed on the survivor
                    self.trace.note_rebuild(time.perf_counter() - t0)
                    self.trace.hop(req.jid, dst_name, req.rid, "failover",
                                   host=self._host_of(dst_name))
                    self.trace.control("failover_rebuild", engine=dst_name,
                                       jid=req.jid, val=1)
                elif res["path"] == "faulted":
                    with self._mu:
                        self._fstats["failover_faulted"] += 1
                    self.trace.control("failover_rebuild", engine=dst_name,
                                       jid=req.jid, val=0)
                return True
            return False
        finally:
            with self._mu:
                self._rebuilding.discard(req)

    def _reap(self, eng: ServingEngine, spared: set) -> None:
        """Post-mortem host-side cleanup of a fenced corpse — the fleet
        is the sole owner of these structures once the loop thread is
        gone. Releases every resource the dead loop held (slot blocks,
        parked entries and their host-tier pages, queued work, unserved
        lifecycle tickets) WITHOUT delivering terminals to sessions the
        failover just rebuilt (``spared`` — they live on survivors now);
        anything else still unfinished here was never routed through the
        fleet and could not be recovered: it gets a typed FAULTED
        terminal instead of a hang."""
        eng._stop.set()
        name = self._resolve(eng)

        def finish_unspared(req) -> None:
            if req is None or req.status is not None or req in spared:
                return
            with self._mu:
                # a submit straggler may be rebuilding this request RIGHT
                # NOW (the _rebuilding claim), or may already have placed
                # it on a survivor (_assigned names another engine) — the
                # failover's `spared` snapshot predates both. Faulting it
                # here would end a stream that lives elsewhere.
                if (req in self._rebuilding
                        or self._assigned.get(req, name) != name):
                    return
            req.finish(req._abort or Status.FAULTED)

        reaper = getattr(eng, "fleet_reap", None)
        if reaper is not None:
            # a fabric proxy owns only its client-side mirrors; the
            # host's own resources died with the host (or its shutdown
            # sweep reclaims them on a mere link death)
            reaper(finish_unspared)
            return
        sweep_corpse(eng, finish_unspared)

    # ------------------------------------------------------------- rebalance

    def _maybe_rebalance(self) -> None:
        """One rebalancing migration per probe round, when the pool-
        occupancy fraction gap between the most- and least-pressured
        routable engines exceeds the threshold: a LIVE session preferred
        (it parks at its flush boundary and resumes on the destination —
        the client just sees tokens keep arriving), else a parked one
        (which resumes on arrival, per migrate()'s contract)."""
        thr = self.fleet.rebalance_threshold
        if thr is None:
            return
        occ = []
        for name in self._routable():
            sig = self._engines[name].signals()
            if sig.pool_blocks:
                used = sig.pool_blocks - (sig.pool_free or 0)
                occ.append((used / sig.pool_blocks, name))
        if len(occ) < 2:
            return
        occ.sort(key=lambda t: (t[0], t[1]))
        lo_f, lo_name = occ[0]
        hi_f, hi_name = occ[-1]
        if hi_f - lo_f < thr:
            return
        hi, lo = self._engines[hi_name], self._engines[lo_name]
        live = getattr(hi, "live_sessions", None)
        if live is not None:
            # a fabric proxy: pick from its mirror (streaming sessions
            # first; a parked mirror entry carries "unstarted")
            victim = next(
                (r for r in live()
                 if r.status is None and not r.cancelled
                 and not hi._parked.get(r, {}).get("unstarted")),
                None)
        else:
            victim = next(
                (r for r in list(hi._slot_req)
                 if r is not None and r.status is None and not r.cancelled),
                None)
            if victim is None:
                for req in _snaplist(hi._parked):
                    e = hi._parked.get(req)
                    if (e is not None and req.status is None
                            and not req.cancelled and not e.get("unstarted")):
                        victim = req
                        break
        if victim is None:
            return
        try:
            # bounded: this runs on the monitor thread, and a wedged
            # source must cost at most rebalance_timeout of probing
            rep = migrate(victim, hi, lo,
                          timeout=self.fleet.rebalance_timeout)
        except MigrationError:
            return  # it settled, or the pair is busy: next round retries
        if rep["path"] in ("resident", "host", "recompute", "requeue"):
            with self._mu:
                self._fstats["rebalance_migrations"] += 1
                self._assigned[victim] = lo_name
            self.trace.hop(victim.jid, lo_name, victim.rid, "rebalance",
                           host=self._host_of(lo_name))
            self.trace.control("rebalance", engine=lo_name, jid=victim.jid,
                               score=hi_f - lo_f)

    # ----------------------------------------------------------------- stats

    def stats(self, include_engines: bool = True) -> dict:
        """Fleet-level counters plus (with ``include_engines``) every
        engine's stats() under its name — the exporter
        (vtpu/obs/export.ServingCollector.register_fleet) maps the flat
        keys to vtpu_serving_fleet_* families and the per-engine
        snapshots to the ordinary vtpu_serving_* families under an
        ``engine`` label; it passes include_engines=False because its
        collect() already snapshots the members itself (per-engine
        stats() is not free — trace percentile aggregation rides it)."""
        with self._mu:
            out: dict = dict(self._fstats)
            out["engine_states"] = dict(self._health)
            out["ledger_sessions"] = sum(
                len(v) for v in self._ledger.values())
        out["fleet_engines"] = len(self._engines)
        # the observability plane's flat keys (journey accounting, control
        # ring health, bundle census, stitched-SLO percentiles) — all
        # exporter-mapped, like every other fleet counter
        out.update(self.trace.stats())
        out.update(self.prefixdir.stats())
        states = out["engine_states"]
        out["healthy_engines"] = sum(
            1 for v in states.values() if v == HEALTHY)
        out["suspect_engines"] = sum(
            1 for v in states.values() if v == SUSPECT)
        out["dead_engines"] = sum(1 for v in states.values() if v == DEAD)
        out["draining_engines"] = sum(
            1 for e in self._engines.values() if e._draining)
        out.update(self._fabric_stats())
        out["engines"] = ({name: eng.stats()
                           for name, eng in self._engines.items()}
                          if include_engines else {})
        return out

    def _fabric_stats(self) -> dict:
        """The fabric's flat keys, ALWAYS emitted (zero for an all-local
        fleet, so dashboards and the exporter see a stable schema).
        Channel counters are per HostClient — two proxies sharing one
        host share one channel — so aggregation dedups by client."""
        out = {
            "remote_engines": 0,
            "fabric_msgs_sent": 0, "fabric_msgs_recv": 0,
            "fabric_bytes_sent": 0, "fabric_bytes_recv": 0,
            "fabric_payload_bytes": 0,
            "fabric_retries": 0, "fabric_timeouts": 0,
            "fabric_resends": 0, "fabric_checksum_faults": 0,
            "fabric_links_down": 0,
            "fabric_rtt_ms": 0.0, "fabric_gbps": 0.0,
        }
        clients = {}
        for eng in self._engines.values():
            if getattr(eng, "is_remote", False):
                out["remote_engines"] += 1
                clients[id(eng._client)] = eng._client
        rtts, gbps = [], []
        for client in clients.values():
            c = client.fabric_stats()
            out["fabric_msgs_sent"] += c["msgs_sent"]
            out["fabric_msgs_recv"] += c["msgs_recv"]
            out["fabric_bytes_sent"] += c["bytes_sent"]
            out["fabric_bytes_recv"] += c["bytes_recv"]
            out["fabric_payload_bytes"] += (c["payload_bytes_sent"]
                                            + c["payload_bytes_recv"])
            out["fabric_retries"] += c["retries"]
            out["fabric_timeouts"] += c["timeouts"]
            out["fabric_resends"] += c["resends"]
            out["fabric_checksum_faults"] += c["checksum_faults"]
            if not c["link_ok"]:
                out["fabric_links_down"] += 1
            if c["rtt_ms"] is not None:
                rtts.append(c["rtt_ms"])
            if c["gbps"] is not None:
                gbps.append(c["gbps"])
        if rtts:
            out["fabric_rtt_ms"] = sum(rtts) / len(rtts)
        if gbps:
            out["fabric_gbps"] = sum(gbps) / len(gbps)
        return out
