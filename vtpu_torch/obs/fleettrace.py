"""Fleet observability: journey stitching, flight recorder, merged dumps
(the port's copy of vtpu/obs/fleettrace.py, on the port's RequestTrace,
``pct``, ``BoundedHistogram`` and ``LATENCY_BUCKETS_MS``).

The per-engine trace stops at the boundary a session crosses when it moves
between engines (migrate, drain, rebalance, failover). A request's history is split over per-engine
rings under engine-local rids, a DEAD engine's ring (the most interesting
one) dies with the corpse, and the fleet's own control decisions (which
engine a route policy picked and WHY, which probe missed, when a drain
started) leave no trace at all. This module is the fleet half of the
plane, three pieces:

**Journey stitching.** The fleet assigns every request a fleet-stable
``jid`` and registers a HOP — ``(engine, rid, kind, t_ns)`` — at every
placement: the initial route, a drain/rebalance/rescue migration, a
failover rebuild. ``journeys()`` joins each hop's per-engine derived span
(vtpu/obs/trace.spans, which the jid->rid hop list keys into) into ONE
stitched journey span: per-hop token counts and TTFT/ITL attribution,
migration/failover **blackout windows** (last delivered token on the
source hop -> first delivered token on the destination hop), and the
correctness contract the whole plane stands on — **token conservation**:
the per-hop token counts must sum to exactly the tokens the client was
delivered (``Request.delivered``), or the stitch is lying about where a
stream lived. A hop whose ring wrapped past its events voids the check
honestly (``truncated``) instead of failing it — which is why the
engine-side ``trace_ring_*`` gauges exist.

**Control-event ring.** Fleet control events (``route``, ``reroute``,
``probe_miss``, ``suspect``, ``dead``, ``fence``, ``failover_rebuild``,
``rebalance``, ``drain_start``/``drain_end``) record into a bounded ring,
each optionally carrying the ``EngineSignals`` snapshot and policy score
that drove the decision — a ``RoutePolicy``/``ShedPolicy`` verdict is
only auditable with the inputs it scored sitting next to the outcome.

**Flight recorder.** At DEAD fencing — after the fence, BEFORE the
rebuild and the reap wipe the corpse's host bookkeeping — the fleet
snapshots the dead engine's trace ring, ``stats()``, last signals and a
ledger census into a bounded post-mortem bundle (JSON-parseable; JSONL
dump + a Chrome fragment under the engine's merged-dump pid). Every
failover yields a loadable black box instead of a reaped mystery.

Everything here is bounded (ring, journey map, bundle set, reservoirs)
and host-only: nothing touches the device, so the plane adds no sync.

One change from the reference: ``events_recorded`` is a plain integer
counted under the ring's lock (the reference reads an ``itertools.count``
through ``__reduce__``, which Python 3.14 removes); it holds the same
value.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import IO, Optional, Union

from vtpu_torch.obs.tickprof import LATENCY_BUCKETS_MS, BoundedHistogram
from vtpu_torch.obs.trace import RequestTrace, pct

# The fleet control-event vocabulary (the engine-side EVENT_KINDS
# analogue). ``engine`` names the subject; ``jid`` ties request-scoped
# events to a journey; ``signals``/``score`` carry the decision inputs.
FLEET_EVENT_KINDS = (
    "route",             # submit placed a request (score: winning score)
    "reroute",           # a closed/draining door was walked past, or an
                         # in-gap straggler was rescued off one
    "probe_miss",        # a health probe counted as missed (val: streak)
    "suspect",           # HEALTHY -> SUSPECT ladder transition
    "dead",              # DEAD declared (val: miss streak at declaration)
    "fence",             # the corpse was fenced (loop joined / gated)
    "failover_rebuild",  # one session rebuilt on a survivor (engine:
                         # destination; val: 1 rebuilt / 0 faulted)
    "rebalance",         # one background rebalance migration (engine:
                         # destination; score: the occupancy gap)
    "drain_start",       # router-driven evacuation began
    "drain_end",         # evacuation finished (val: sessions migrated)
    "prefix_install",    # a host-tier/donor prefix was installed on an
                         # engine (engine: destination; val: prefix tokens)
    "prefix_replicate",  # gravity replicated a hot prefix (engine:
                         # destination; val: prefix tokens)
    "prefix_spill",      # gravity spilled a cold prefix to the host tier
                         # (engine: the ex-resident; val: 1 if host-tiered)
)

# Hop kinds a journey records (the "why did the stream move" vocabulary).
# "route" opens every journey; the rest append one hop per placement.
HOP_KINDS = ("route", "migrate", "drain", "rebalance", "rescue", "failover")
# hop kinds whose blackout window is a FAILOVER blackout (the engine died;
# everything else is a cooperative migration)
_FAILOVER_KINDS = ("failover",)


def validate_bundle(bundle) -> bool:
    """Is *bundle* a well-formed post-mortem black box? One definition of
    the contract — JSON round-trips losslessly, the ledger census and
    trace events are present and non-empty — shared by every check that
    gates on it, so the contract cannot drift per copy."""
    if bundle is None:
        return False
    try:
        if json.loads(json.dumps(bundle)) != bundle:
            return False
    except (TypeError, ValueError):
        return False
    return bool(bundle.get("ledger")) and bool(bundle.get("events"))


def _jsonable(obj):
    """Best-effort conversion to JSON-serializable types — post-mortem
    bundles must ALWAYS parse, whatever a stats() snapshot happens to
    carry (numpy scalars, tuples)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


class FleetTrace:
    """The fleet-level trace: per-engine ``RequestTrace`` rings tagged by
    engine name, a bounded control-event ring, the journey registry, the
    post-mortem bundle set, and the stitched-SLO histogram substrate
    (failover/migration blackout, rebuild latency, hops per request) the
    ``vtpu_serving_fleet_*`` exporter publishes. One instance per
    EngineFleet; ``capacity=0`` disables the whole plane (every recorder
    is a cheap no-op and no memory is held)."""

    def __init__(self, capacity: int = 4096, max_journeys: int = 4096,
                 max_bundles: int = 8, reservoir: int = 1024):
        self.capacity = int(capacity)
        self.enabled = self.capacity > 0
        self._mu = threading.Lock()
        # control events recorded (the next event's seq), counted under
        # _mu so a reader never consumes a number
        self._recorded = 0
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=max(self.capacity, 1))
        self._engines: dict[str, RequestTrace] = {}
        self._pids: dict[str, int] = {}  # merged-dump pid per engine
        self._next_jid = 0
        self.max_journeys = int(max_journeys)
        self._journeys: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self.max_bundles = int(max_bundles)
        self._bundles: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._ended = 0
        self._conserved = 0
        self._truncated = 0
        # the stitched-SLO substrate: monotonic histograms for the
        # exporter + bounded reservoirs for stats() percentiles — exactly
        # the trace.py latency-substrate split
        self.failover_blackout_hist = BoundedHistogram(LATENCY_BUCKETS_MS)
        self.migration_blackout_hist = BoundedHistogram(LATENCY_BUCKETS_MS)
        self.rebuild_hist = BoundedHistogram(LATENCY_BUCKETS_MS)
        self.hops_hist: dict[int, int] = {}  # hop count -> ended journeys
        self._blackout_res = {
            "failover": collections.deque(maxlen=reservoir),
            "migration": collections.deque(maxlen=reservoir),
        }
        self._rebuild_res: "collections.deque[float]" = collections.deque(
            maxlen=reservoir)

    # ----------------------------------------------------------- attachment

    def attach(self, name: str, trace: RequestTrace) -> None:
        """Register one engine's ring under its fleet name. The pid is
        assigned by attach order (fleet pid 1 is the control track, so
        engines start at 2) and stays stable for merged dumps and
        flight-recorder fragments."""
        with self._mu:
            self._engines[name] = trace
            if name not in self._pids:
                self._pids[name] = 2 + len(self._pids)

    # ------------------------------------------------------- control events

    def control(self, event: str, engine: str = "", jid: int = -1,
                val: int = 0, signals=None, score=None,
                bonus=None) -> None:
        """Record one fleet control event. ``signals`` (an EngineSignals)
        and ``score`` ride along as the decision's audited inputs; both
        default absent so the hot route path pays one dict + one deque
        append. ``bonus`` is the prefix-gravity additive a route event
        records NEXT TO the winning score (the route's
        audit trail extended: score already includes it, bonus shows the
        directory's share). Host-only, lock-held only for the append."""
        if not self.enabled:
            return
        rec = {
            "seq": -1,
            "ts_ns": time.monotonic_ns(),
            "event": event,
            "engine": engine,
            "jid": jid,
            "val": val,
        }
        if score is not None:
            rec["score"] = float(score)
        if bonus is not None:
            rec["bonus"] = float(bonus)
        if signals is not None:
            rec["signals"] = dataclasses.asdict(signals)
        with self._mu:
            rec["seq"] = self._recorded
            self._recorded += 1
            self._ring.append(rec)

    @property
    def events_recorded(self) -> int:
        with self._mu:
            return self._recorded

    @property
    def events_dropped(self) -> int:
        if not self.enabled:
            return 0
        with self._mu:
            return max(0, self._recorded - len(self._ring))

    def events(self) -> list[dict]:
        """The control ring's live events, oldest first (dict copies)."""
        with self._mu:
            return [dict(e) for e in self._ring]

    # -------------------------------------------------------------- journeys

    def begin_journey(self, engine: str, rid: int,
                      host: str = "local", prefix: bool = False) -> int:
        """Open a journey at its first placement; returns the jid the
        fleet stamps on the Request (stable across every later hop).
        ``host`` is the placement's EngineHost label ('local' for an
        in-proc member) — cross-host hops stitch into ONE journey.
        ``prefix`` marks a prefix-GRAVITATIONAL placement: the route
        bonus (not pressure alone) chose this engine, the annotation a
        stitched journey surfaces per hop."""
        if not self.enabled:
            return -1
        hop = {"engine": engine, "rid": rid, "kind": "route",
               "host": host, "prefix": bool(prefix),
               "t_ns": time.monotonic_ns()}
        with self._mu:
            jid = self._next_jid
            self._next_jid += 1
            self._journeys[jid] = {"jid": jid, "hops": [hop], "ended": False,
                                   "delivered": None, "terminal": None}
            while len(self._journeys) > self.max_journeys:
                self._journeys.popitem(last=False)
        return jid

    def hop(self, jid: int, engine: str, rid: int, kind: str,
            host: str = "local") -> None:
        """Append one placement hop (the rid is the session's FRESH
        identity on the destination engine — migrate_in reassigns it;
        ``host`` tags which EngineHost the destination lives on)."""
        if not self.enabled or jid < 0:
            return
        with self._mu:
            j = self._journeys.get(jid)
            if j is None or j["ended"]:
                return
            j["hops"].append({"engine": engine, "rid": rid, "kind": kind,
                              "host": host,
                              "t_ns": time.monotonic_ns()})

    def end_journey(self, jid: int, delivered: int,
                    terminal: Optional[str]) -> None:
        """Close a journey at its terminal: stamp what the CLIENT actually
        received (the conservation denominator) and fold the stitched
        blackout windows / hop count into the SLO substrate exactly once.
        Idempotent — racing enders collapse to the first."""
        if not self.enabled or jid < 0:
            return
        with self._mu:
            j = self._journeys.get(jid)
            if j is None or j["ended"]:
                return
            j["ended"] = True
            j["delivered"] = int(delivered)
            j["terminal"] = terminal
            hops = [dict(h) for h in j["hops"]]
            self._ended += 1
            n = len(hops)
            self.hops_hist[n] = self.hops_hist.get(n, 0) + 1
        if n > 1:
            # stitch once, at close, so the histograms stay monotonic:
            # span derivation only runs for the rare multi-hop journey.
            # Stitch the locked-copy snapshot, not the shared dict — the
            # live journey is only append-frozen by ended=True.
            stitched = self._stitch({**j, "hops": hops},
                                    self._engine_view(
                                        {h["engine"] for h in hops}))
            with self._mu:
                # reservoir appends under the lock: stats() sorts these
                # deques under the same lock, and an unlocked append
                # during sorted()'s iteration raises (the hops_snapshot
                # race class). The hists are monotonic bucket counters —
                # benign racing, the engine-stats convention.
                for b in stitched["blackouts"]:
                    if b["ms"] is None:
                        continue
                    kind = b["kind"]
                    (self.failover_blackout_hist if kind == "failover"
                     else self.migration_blackout_hist).note_ms(b["ms"])
                    self._blackout_res[kind].append(b["ms"])
                if stitched["conserved"]:
                    self._conserved += 1
                if stitched["truncated"]:
                    self._truncated += 1
        else:
            # one hop: there is no seam to lose tokens at — conservation
            # holds BY CONSTRUCTION (delivered counts deliveries on that
            # one engine; the stitch sums exactly one hop), so the
            # counter takes it without paying a span derivation per
            # request. NOTE the asymmetry with journeys(): the offline
            # view re-derives from the RING and reports a wrapped
            # single-hop journey as truncated/unproven — the counter
            # says "nothing was lost", the view says "the ring can no
            # longer show it"; ring wrap itself is surfaced by the
            # per-engine trace_ring_utilization gauges.
            with self._mu:
                self._conserved += 1

    def hops_snapshot(self) -> dict[int, int]:
        """{hop count: ended journeys} copied under the lock — the
        exporter's read (iterating the live dict racing end_journey's
        insert would RuntimeError mid-scrape)."""
        with self._mu:
            return dict(self.hops_hist)

    def note_rebuild(self, seconds: float) -> None:
        """One failover rebuild's latency (install handshake + resume
        enqueue on the survivor)."""
        if not self.enabled:
            return
        self.rebuild_hist.note(seconds)
        with self._mu:  # stats() sorts this deque under the lock
            self._rebuild_res.append(seconds * 1e3)

    def _engine_view(self, names) -> dict[str, tuple]:
        """{engine: (spans, horizon_ns)} for the named engines. The
        horizon is the oldest event still in a ring that HAS dropped
        events (None for a ring that never wrapped): a hop placed before
        the horizon may have lost events, one placed after it is whole —
        a lifetime drop counter alone would void every stitch on a
        long-lived engine."""
        with self._mu:
            traces = {n: self._engines[n] for n in names
                      if n in self._engines}
        view = {}
        for n, tr in traces.items():
            evs = tr.snapshot()
            horizon = evs[0][1] if evs and tr.events_dropped > 0 else None
            view[n] = (tr.spans(), horizon)
        return view

    def _stitch(self, j: dict, view: dict) -> dict:
        """One journey joined across its hops' per-engine spans: hop list
        with per-hop token counts and TTFT/ITL attribution, blackout
        windows between consecutive hops, the conservation verdict."""
        hops_out = []
        blackouts = []
        total = 0
        truncated = False
        for i, h in enumerate(j["hops"]):
            spans, horizon = view.get(h["engine"], ({}, None))
            span = spans.get(h["rid"])
            if span is None or (horizon is not None
                                and h["t_ns"] < horizon):
                # the hop's events are (partly) gone — ring wrapped past
                # its placement, or a rid the ring never saw: the stitch
                # must say so instead of failing conservation dishonestly
                truncated = True
            hop = {"engine": h["engine"], "rid": h["rid"],
                   "kind": h["kind"], "t_ns": h["t_ns"],
                   "host": h.get("host", "local"),
                   "prefix": bool(h.get("prefix", False)),
                   "tokens": span["tokens"] if span else 0,
                   "first_tok_ns": span["first_tok_ns"] if span else None,
                   "last_tok_ns": span["last_tok_ns"] if span else None,
                   "itl_ms": list(span["itl_ms"]) if span else [],
                   "terminal": span["terminal"] if span else None}
            # per-hop TTFT attribution: hop start (submit for hop 0, the
            # placement for later hops) -> the hop's first delivered token
            hop["ttft_ms"] = (
                (hop["first_tok_ns"] - h["t_ns"]) / 1e6
                if hop["first_tok_ns"] is not None
                and hop["first_tok_ns"] >= h["t_ns"] else None)
            total += hop["tokens"]
            hops_out.append(hop)
            if i > 0:
                prev = hops_out[i - 1]
                src_last = prev["last_tok_ns"]
                dst_first = hop["first_tok_ns"]
                kind = ("failover" if h["kind"] in _FAILOVER_KINDS
                        else "migration")
                blackouts.append({
                    "from": prev["engine"], "to": hop["engine"],
                    "kind": kind,
                    "src_last_tok_ns": src_last,
                    "dst_first_tok_ns": dst_first,
                    # a hop off a never-streamed (still-waiting) session
                    # has no window: ms is None, honestly
                    "ms": ((dst_first - src_last) / 1e6
                           if src_last is not None and dst_first is not None
                           else None),
                })
        conserved = (not truncated and j["delivered"] is not None
                     and total == j["delivered"])
        return {
            "jid": j["jid"], "hops": hops_out, "n_hops": len(hops_out),
            "tokens": total, "delivered": j["delivered"],
            "terminal": j["terminal"], "ended": j["ended"],
            "conserved": conserved, "truncated": truncated,
            "blackouts": blackouts,
        }

    def journeys(self) -> dict[int, dict]:
        """Every registered journey, stitched: {jid: journey span}. Span
        derivation runs once per engine (off ring snapshots), never per
        hop — the offline post-mortem read, not a hot path."""
        with self._mu:
            snap = [dict(j, hops=[dict(h) for h in j["hops"]])
                    for j in self._journeys.values()]
        names = {h["engine"] for j in snap for h in j["hops"]}
        view = self._engine_view(names)
        return {j["jid"]: self._stitch(j, view) for j in snap}

    # -------------------------------------------------------- flight recorder

    def flight_record(self, name: str, engine, ledger: dict,
                      reason: str = "dead") -> Optional[dict]:
        """Snapshot a fenced corpse into a post-mortem bundle — called by
        the fleet at DEAD declaration, after the fence, BEFORE the reap
        releases the host bookkeeping the snapshot reads. The bundle is
        JSON-parseable by construction: the corpse's trace-ring events,
        ``stats()``, last ``signals()``, and a ledger CENSUS (per-session
        summary — rid/jid/delivered/seq_len/pages/priority, never the
        token arrays: bundles are bounded). The Chrome fragment carries
        the corpse's ring under its merged-dump pid so the black box
        drops straight into the fleet timeline."""
        if not self.enabled:
            return None
        try:
            sig = dataclasses.asdict(engine.signals())
        except Exception:
            sig = None
        census = []
        for req, meta in ledger.items():
            census.append({
                "rid": getattr(req, "rid", -1),
                "jid": getattr(req, "jid", -1),
                "delivered": getattr(req, "delivered", 0),
                "unstarted": bool(meta.get("unstarted")),
                "seq_len": meta.get("seq_len"),
                "n_pages": meta.get("n_pages"),
                "budget": meta.get("budget"),
                "priority": meta.get("priority"),
                "hist_exact": meta.get("hist_exact"),
            })
        with self._mu:
            pid = self._pids.get(name, 2)
        bundle = {
            "kind": "postmortem",
            "engine": name,
            "reason": reason,
            "t_ns": time.monotonic_ns(),
            "stats": _jsonable(engine.stats()),
            "signals": _jsonable(sig),
            "ledger": census,
            "events": _jsonable(engine.trace.events()),
            "chrome": _jsonable(
                engine.trace.chrome_trace(pid=pid, name=f"engine:{name}")),
        }
        with self._mu:
            self._bundles[name] = bundle
            while len(self._bundles) > self.max_bundles:
                self._bundles.popitem(last=False)
        return bundle

    def bundles(self) -> dict[str, dict]:
        with self._mu:
            return dict(self._bundles)

    def dump_bundle(self, name: str, dest: Union[str, IO]) -> int:
        """Write one engine's post-mortem bundle as JSON Lines: a header
        record (stats/signals/ledger census), one line per trace event,
        then the Chrome fragment. Returns lines written (0: no bundle)."""
        with self._mu:
            bundle = self._bundles.get(name)
        if bundle is None:
            return 0
        head = {k: bundle[k] for k in ("kind", "engine", "reason", "t_ns",
                                       "stats", "signals", "ledger")}
        lines = [json.dumps(head)]
        lines += [json.dumps({"kind": "event", **e})
                  for e in bundle["events"]]
        lines.append(json.dumps({"kind": "chrome", "doc": bundle["chrome"]}))
        payload = "\n".join(lines) + "\n"
        if hasattr(dest, "write"):
            dest.write(payload)
        else:
            with open(dest, "w") as fh:
                fh.write(payload)
        return len(lines)

    # ---------------------------------------------------------- merged dump

    def chrome_trace(self) -> dict:
        """ONE Chrome ``trace_event`` document for the whole fleet: each
        engine's ring under its own pid (rid collisions across engines
        stop mattering — a tid only names a track within its pid) against
        a COMMON time origin, plus the fleet-control track (pid 1):
        instant markers for every control event and complete slices for
        each stitched blackout window."""
        with self._mu:
            engines = dict(self._engines)
            pids = dict(self._pids)
            ctl = [dict(e) for e in self._ring]
        snaps = {n: tr.snapshot() for n, tr in engines.items()}
        stamps = [e[1] for evs in snaps.values() for e in evs]
        stamps += [e["ts_ns"] for e in ctl]
        out: list[dict] = [{
            "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": "fleet-control"},
        }]
        if not stamps:
            return {"traceEvents": out, "displayTimeUnit": "ms"}
        t0 = min(stamps)
        us = lambda ns: (ns - t0) / 1e3  # noqa: E731
        for name in sorted(engines):
            doc = engines[name].chrome_trace(
                pid=pids.get(name, 2), name=f"engine:{name}", t0_ns=t0)
            out.extend(doc["traceEvents"])
        for e in ctl:
            args = {"engine": e["engine"], "jid": e["jid"], "val": e["val"]}
            if "score" in e:
                args["score"] = e["score"]
            if "bonus" in e:
                args["bonus"] = e["bonus"]
            if "signals" in e:
                args["signals"] = e["signals"]
            out.append({"ph": "i", "pid": 1, "tid": 0, "s": "p",
                        "ts": us(e["ts_ns"]), "name": e["event"],
                        "args": args})
        # blackout slices: the stitched windows rendered on the control
        # track, one tid per journey so overlapping failovers stay visible
        for jid, j in self.journeys().items():
            for b in j["blackouts"]:
                if b["ms"] is None:
                    continue
                out.append({
                    "ph": "X", "pid": 1, "tid": 1 + (jid % 32),
                    "ts": us(b["src_last_tok_ns"]),
                    "dur": max(b["ms"] * 1e3, 0.001),
                    "name": f"{b['kind']} blackout j{jid}",
                    "args": {"jid": jid, "from": b["from"], "to": b["to"],
                             "ms": round(b["ms"], 3)},
                })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def to_chrome_trace(self, dest: Union[str, IO]) -> dict:
        doc = self.chrome_trace()
        if hasattr(dest, "write"):
            json.dump(doc, dest)
        else:
            with open(dest, "w") as fh:
                json.dump(doc, fh)
        return doc

    # ----------------------------------------------------------------- stats

    def stats(self) -> dict:
        """The flat keys EngineFleet.stats() merges (and the exporter's
        FLEET_COUNTERS/FLEET_GAUGES map): journey accounting, control-ring
        health, bundle census, and the stitched-SLO percentiles (views
        over the bounded reservoirs, the engine-stats convention)."""
        with self._mu:
            open_j = sum(1 for j in self._journeys.values()
                         if not j["ended"])
            out = {
                "journeys_open": open_j,
                "journeys_ended": self._ended,
                "journeys_conserved": self._conserved,
                "journeys_truncated": self._truncated,
                "fleet_trace_events_recorded": self._recorded,
                "postmortem_bundles": len(self._bundles),
            }
            fo = sorted(self._blackout_res["failover"])
            mig = sorted(self._blackout_res["migration"])
            reb = sorted(self._rebuild_res)
        out["fleet_trace_events_dropped"] = self.events_dropped
        for key, vals in (("failover_blackout", fo),
                          ("migration_blackout", mig), ("rebuild", reb)):
            for q, suffix in ((0.5, "p50"), (0.99, "p99")):
                v = pct(vals, q)
                out[f"{key}_{suffix}_ms"] = (
                    round(v, 3) if v is not None else None)
        return out
