"""The port's engine fleet (``vtpu_torch.serving.fleet``) against vtpu's on
the same weights (CPU, f32), in the reference's configuration
(tests/test_fleet.py: the tiny model, page 8, slots 2, ``kv_swap`` 8).

Every case runs one scenario on a fleet of JAX engines and on a fleet of
the port's engines and holds both runs to the same outcome: streams equal
to the JAX single-engine references, the same fleet counters and health
states, the same report paths and journey hops, and clean pools with
reaped corpses (allocator free == capacity, nothing parked, no slots).
The cases are tests/test_fleet.py's thirteen: validation, route-policy
loading, least-pressure and duty routing, kill one of three, ledger
staleness, a cancel racing failover, SUSPECT recovery, a routed drain,
rebalancing, the migrate and failover journeys (with the flight
recorder), and the ledger's shape.

Nothing races the loop threads (tests/torch_fleet_kit.py): requests are
submitted while the engine's loop is held at a tick head (``TickGate``),
so what admits together is fixed; engine death is armed, a cancel or a
park asked, from inside a chosen token's delivery; SUSPECT comes from a
``probe_loss`` plan. Rebalancing stops after its first move (a pair of
engines otherwise trades the session back and forth each probe round).
A wall clock only guards against a hang. One torch thread."""

import io
import json
import threading
import time

import pytest
import torch

from tests.torch_fleet_kit import (
    CFG,
    JCFG,
    PAGE,
    PinPolicy,
    ProbeGate,
    TickGate,
    both,
    fleet_counters,
    held,
    hold_until,
    journey,
    make_weights,
    on_token,
    on_token_when,
    prompt,
    settle_clean,
    wait,
    watch_parks,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine

# long enough that an armed kill lands mid-stream (prompt 6 + 20 < max_seq 32)
STEPS = 20
BASE = dict(slots=2, prefill_buckets=(8,), max_new_tokens=STEPS, kv_page=PAGE, kv_swap=8)
# probes every 5 ms; a beat older than 2 s is a miss (wide: only a dead
# loop or a probe_loss injection walks the ladder); 2 misses -> SUSPECT,
# 4 -> DEAD
FC = dict(probe_interval_ms=5.0, miss_ms=2000.0, suspect_misses=2, dead_misses=4)

P1, P2, P3 = prompt(1, 5), prompt(2, 6), prompt(3, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def refs(weights):
    """The JAX single-engine streams of P1-P3 (greedy, slot-count
    invariant)."""
    eng = JServingEngine(weights[0], JCFG, JServingConfig(**{**BASE, "slots": 3}))
    eng.start()
    try:
        return [list(eng.submit(p, max_new_tokens=STEPS).stream()) for p in (P1, P2, P3)]
    finally:
        eng.stop()


def run(weights, scenario):
    return both(weights, scenario, BASE, FC)


def _reaped(fleet, eng):
    """The corpse's invariants once the failover's reap ran."""
    wait(lambda: fleet.stats(include_engines=False)["failovers"] >= 1, "the failover")
    return settle_clean(eng)


# ------------------------------------------------------------- validation


def test_fleet_validation(weights, refs):
    """Fewer than two engines, an engine without kv_swap, another page
    size, a ladder out of order and a fault plan of the wrong type fail at
    construction, with the reference's messages. An engine under mesh=
    joins a fleet as the reference's does (the port refused it before its
    sessions could migrate): a one-rank-mesh member beside a one-device
    one serves a pinned session, and the fleet's drain moves it across,
    the stream equal to the JAX engine's."""
    def scenario(k):
        one, two = k.engine(), k.engine()
        no_swap = k.engine(kv_swap=None)
        other = k.engine(kv_page=4)
        cases = [({"a": one}, {}, "at least 2"), ({"a": one, "b": no_swap}, {}, "kv_swap"),
                 ({"a": one, "b": other}, {}, "geometry"),
                 ({"a": one, "b": two}, dict(suspect_misses=3, dead_misses=2), "suspect_misses"),
                 ({"a": one, "b": two}, dict(faults=object()), "FaultPlan")]
        for engines, fc, match in cases:
            with pytest.raises(ValueError, match=match):
                k.Fleet(engines, k.FleetConfig(**fc))
        return {"refused": [m for _, _, m in cases]}

    out = run(weights, scenario)
    held(out, {})
    from vtpu_torch.parallel import TpMesh
    from vtpu_torch.serving import EngineFleet, FleetConfig, ServingConfig, ServingEngine

    mesh = TpMesh(rank=0, size=1, device=torch.device("cpu"))
    tp = ServingEngine(weights[1], CFG, ServingConfig(**BASE), mesh=mesh)
    one = ServingEngine(weights[1], CFG, ServingConfig(**BASE), device="cpu")
    fleet = EngineFleet({"a": tp, "b": one}, FleetConfig(**FC, route_policy=PinPolicy("a")))
    fleet.start()
    try:
        with TickGate(tp):
            req = fleet.submit(P1, max_new_tokens=STEPS)
            on_token(req, 2, lambda: tp.park(req))
        wait(lambda: req in tp._parked, "the park")
        report = fleet.drain("a")
        assert list(req.stream()) == refs[0]
        assert (report["migrated"], report["faulted"]) == (1, 0)
        assert fleet._assigned.get(req, "b") == "b"
        assert settle_clean(tp, one)
        s = fleet.stats(include_engines=False)
        assert s["draining_engines"] == 1 and s["failovers"] == 0
    finally:
        fleet.stop()


def test_route_policy_loading(weights):
    """None -> the least-pressure default; a class is instantiated, an
    instance kept, a "module:attr" string imported (compared by behaviour:
    the import path differs); a bad string or an object without score()
    fails typed. Both packages' loaders agree."""
    def scenario(k):
        pin = PinPolicy("b")
        loaded = k.load_route_policy("tests.torch_fleet_kit:PinPolicy")
        errors = []
        for bad, match in (("no-colon", "module:attr"), (object(), "score")):
            with pytest.raises(ValueError, match=match):
                k.load_route_policy(bad)
            errors.append(match)
        return {"default": type(k.load_route_policy(None)).__name__,
                "class": type(k.load_route_policy(PinPolicy)).__name__,
                "instance": k.load_route_policy(pin) is pin,
                "string": (type(loaded).__name__, loaded.score("a", k.Signals())),
                "errors": errors}

    held(run(weights, scenario), {"default": "LeastPressureRoutePolicy", "class": "PinPolicy",
                                  "instance": True, "string": ("PinPolicy", 1.0)})


# ---------------------------------------------------------------- routing


def test_routing_prefers_least_pressure(weights, refs):
    """The default policy routes to the engine with the most free pool and
    least queue pressure: with 'a' holding two streams (its loop held inside
    their first delivery, so they hold their slots and pages), a submit
    lands on 'b' and completes there; a draining engine is never a
    target."""
    holders_p = [prompt(50 + j, 5) for j in range(2)]

    def scenario(k):
        fleet, E = k.fleet(("a", "b"))
        go, held_ev = threading.Event(), threading.Event()
        holders = [E["a"].submit(p, max_new_tokens=STEPS) for p in holders_p]
        on_token(holders[0], 1, hold_until(go.is_set, held_ev))
        fleet.start()
        assert held_ev.wait(60), "the loop was not held"
        req = fleet.submit(P1, max_new_tokens=STEPS)
        first = fleet._assigned[req]
        go.set()
        got = list(req.stream())
        E["b"]._draining = True
        try:
            req2 = fleet.submit(P1, max_new_tokens=2)
            second = fleet._assigned[req2]
            got2 = list(req2.stream())
        finally:
            E["b"]._draining = False
        hs = [list(r.stream()) for r in holders]
        fleet.stop()
        settle_clean(*E.values())
        return {"first": first, "second": second, "stream": got, "stream2": got2,
                "holders": hs, "counters": fleet_counters(fleet),
                "journey": journey(fleet, req)}

    out = run(weights, scenario)
    held(out, {"first": "b", "second": "a", "stream": refs[0], "stream2": refs[0][:2]})
    assert out["port"]["journey"]["hops"] == [("route", "b", "local")]


def test_routing_steers_off_high_duty(weights):
    """Attested duty (a duty_supplier) reaches the route policy: equal
    engines split by duty alone."""
    def scenario(k):
        fleet, E = k.fleet(("a", "b"), engine_kw={"a": {"duty_supplier": lambda: 0.9},
                                                   "b": {"duty_supplier": lambda: 0.05}})
        fleet.start()
        req = fleet.submit(P1, max_new_tokens=2)
        where = fleet._assigned[req]
        got = list(req.stream())
        return {"where": where, "stream": got}

    held(run(weights, scenario), {"where": "b"})


# --------------------------------------------------------------- failover


def test_kill_one_of_three_failover_token_equal(weights, refs):
    """One of three engines dies without saying goodbye (engine_death armed
    inside its first stream's second token) while holding two live streams
    and one waiting request. Every stream finishes token-equal on a
    survivor: the started sessions rebuilt from the ledger through
    recompute, the waiting one re-queued from the fleet's assignment
    record; failover_sessions is 3 and the corpse reads reaped."""
    def scenario(k):
        plan = k.Plan()
        fleet, E = k.fleet(faults_for={"a": plan}, fc={"route_policy": PinPolicy("a")})
        fleet.start()
        with TickGate(E["a"]):
            reqs = [fleet.submit(p, max_new_tokens=STEPS) for p in (P1, P2, P3)]
            on_token(reqs[0], 2, lambda: plan.arm("engine_death"))
        placed = [fleet._assigned[r] for r in reqs]
        streams = [list(r.stream()) for r in reqs]
        _reaped(fleet, E["a"])
        s = fleet.stats()
        fleet.stop()
        return {"placed": placed, "streams": streams,
                "statuses": [r.status for r in reqs], "counters": fleet_counters(fleet),
                "moved": {n: s["engines"][n]["migrations_in"] for n in ("b", "c")},
                "injected": plan.snapshot()["injected"]["engine_death"],
                "journeys": [journey(fleet, r)["hops"] for r in reqs],
                "conserved": [journey(fleet, r)["conserved"] for r in reqs]}

    out = run(weights, scenario)
    held(out, {"placed": ["a"] * 3, "streams": refs, "statuses": ["OK"] * 3, "injected": 1,
               "moved": {"b": 3, "c": 0}, "conserved": [True] * 3})
    c = out["port"]["counters"]
    assert (c["failovers"], c["failover_sessions"], c["failover_faulted"]) == (1, 3, 0)
    assert c["engine_states"] == {"a": "DEAD", "b": "HEALTHY", "c": "HEALTHY"}
    assert out["port"]["journeys"] == [[("route", "a", "local"), ("failover", "b", "local")]] * 3


def test_ledger_staleness_die_between_flushes(weights, refs):
    """The ledger records at tick heads, so a death loses only the
    never-delivered dispatch in flight: the rebuild resumes at exactly the
    last delivered token and regenerates the rest: no duplicates, no
    gaps."""
    def scenario(k):
        plan = k.Plan()
        fleet, E = k.fleet(("a", "b"), faults_for={"a": plan},
                           fc={"route_policy": PinPolicy("a")})
        fleet.start()
        with TickGate(E["a"]):
            req = fleet.submit(P1, max_new_tokens=STEPS)
            on_token(req, 3, lambda: plan.arm("engine_death"))
        got = list(req.stream())
        _reaped(fleet, E["a"])
        fleet.stop()
        return {"stream": got, "status": req.status, "counters": fleet_counters(fleet),
                "journey": journey(fleet, req)}

    out = run(weights, scenario)
    held(out, {"stream": refs[0], "status": "OK"})
    assert len(out["port"]["stream"]) == STEPS
    assert out["port"]["counters"]["failover_sessions"] == 1
    assert out["port"]["journey"]["conserved"] is True


def test_cancel_racing_failover(weights, refs):
    """A client cancel landing while its engine dies resolves to exactly
    one typed terminal: the fleet honours the abandon (CANCELLED) instead
    of rebuilding it, and the sibling stream fails over token-equal."""
    def scenario(k):
        plan = k.Plan()
        fleet, E = k.fleet(("a", "b"), faults_for={"a": plan},
                           fc={"route_policy": PinPolicy("a")})
        fleet.start()
        with TickGate(E["a"]):
            keep = fleet.submit(P1, max_new_tokens=STEPS)
            drop = fleet.submit(P2, max_new_tokens=STEPS)

            def die_and_cancel():
                plan.arm("engine_death")
                drop.cancel()

            on_token(keep, 2, die_and_cancel)
        kept, dropped = list(keep.stream()), list(drop.stream())
        _reaped(fleet, E["a"])
        fleet.stop()
        return {"kept": kept, "statuses": [keep.status, drop.status],
                "dropped_prefix": dropped == refs[1][:len(dropped)],
                "counters": fleet_counters(fleet)}

    out = run(weights, scenario)
    held(out, {"kept": refs[0], "statuses": ["OK", "CANCELLED"], "dropped_prefix": True})
    c = out["port"]["counters"]
    assert (c["failovers"], c["failover_sessions"], c["failover_faulted"]) == (1, 1, 0)


def test_suspect_recovery_never_fails_over(weights, refs):
    """Hysteresis: probe_loss eats two consecutive probes of a streaming
    engine; it goes SUSPECT, is never failed over, and returns to HEALTHY at
    its next fresh beat with its stream untouched."""
    def scenario(k):
        # probes walk sorted names each round: arrivals 0, 2, 4, ... are
        # 'a', 1, 3, 5, ... 'b': eat b's probes in rounds 0 and 1 only
        plan = k.Plan([k.Spec("probe_loss", at=1), k.Spec("probe_loss", at=3)])
        fleet, E = k.fleet(("a", "b"), fc={"route_policy": PinPolicy("b"), "faults": plan})
        # no probe round before the placement: two of them would make b
        # SUSPECT first, and the router prefers HEALTHY a
        with ProbeGate(fleet):
            fleet.start()
            req = fleet.submit(P1, max_new_tokens=STEPS)
            where = fleet._assigned[req]
        wait(lambda: fleet.stats()["suspects"] >= 1, "the SUSPECT transition")
        wait(lambda: fleet.stats()["engine_states"]["b"] == "HEALTHY", "the recovery")
        got = list(req.stream())
        s = fleet.stats(include_engines=False)
        fleet.stop()
        return {"where": where, "stream": got, "status": req.status,
                "counters": fleet_counters(fleet), "probe_misses": s["probe_misses"],
                "injected": plan.snapshot()["injected"]["probe_loss"]}

    out = run(weights, scenario)
    held(out, {"where": "b", "stream": refs[0], "status": "OK", "probe_misses": 2,
               "injected": 2})
    c = out["port"]["counters"]
    assert (c["failovers"], c["failover_sessions"], c["suspects"]) == (0, 0, 1)


# ------------------------------------------------------- drain + rebalance


def test_fleet_drain_routes_to_survivors(weights, refs):
    """fleet.drain: a live session (its loop held in a delivery until the
    drain asks for its park), a parked one and a waiting one (parked
    unstarted) all land on the best-scored survivor, the source ends empty
    with admission refused, every stream completes token-equal, and the
    front door routes around the drained engine."""
    def scenario(k):
        fleet, E = k.fleet(fc={"route_policy": PinPolicy("a")})
        a = E["a"]
        asked = watch_parks(a)
        fleet.start()
        go, held_ev = threading.Event(), threading.Event()
        with TickGate(a):
            r1, r2, r3 = (fleet.submit(p, max_new_tokens=STEPS) for p in (P1, P2, P3))

            def park_two():
                a.park(r2)
                a.park(r3)  # still waiting: parks unstarted

            on_token(r2, 1, park_two)
            # r1 holds the loop at its first delivery after both parks
            # settled, until drain asks for its park
            on_token_when(r1, lambda n: r2 in a._parked and r3 in a._parked,
                          hold_until(lambda: go.is_set() and r1 in asked, held_ev))
        assert held_ev.wait(60), "the loop was not held"
        go.set()
        report = fleet.drain("a")
        try:
            a.submit(P1)
            refused = False
        except RuntimeError as exc:
            refused = "draining" in str(exc)
        streams = [list(r.stream()) for r in (r1, r2, r3)]
        extra = fleet.submit(P1, max_new_tokens=2)
        extra_at = fleet._assigned[extra]
        list(extra.stream())
        settle_clean(*E.values())
        fleet.stop()
        return {"streams": streams, "statuses": [r.status for r in (r1, r2, r3)],
                "report": {k_: report[k_] for k_ in ("migrated", "completed", "faulted")},
                "refused": refused, "extra_at": extra_at, "counters": fleet_counters(fleet),
                "hops": [journey(fleet, r)["hops"] for r in (r1, r2, r3)]}

    out = run(weights, scenario)
    held(out, {"streams": refs, "statuses": ["OK"] * 3, "refused": True, "extra_at": "b",
               "report": {"migrated": 3, "completed": 0, "faulted": 0}})
    assert out["port"]["hops"] == [[("route", "a", "local"), ("drain", "b", "local")]] * 3
    assert out["port"]["counters"]["draining_engines"] == 1


def test_rebalance_migrates_off_pressured_engine(weights, refs):
    """Background rebalancing: the pool-occupancy gap past the threshold
    moves the session from the most- to the least-pressured engine (its
    loop held inside its first delivery until the rebalancer's park is
    queued); the stream just keeps going, counted as one
    rebalance_migration."""
    def scenario(k):
        fleet, E = k.fleet(("a", "b"), fc={"route_policy": PinPolicy("a")},
                           rebalance_threshold=0.2)
        once = fleet._maybe_rebalance

        def first_move_only():
            # after one move the pair would trade the session back
            if not fleet._fstats["rebalance_migrations"]:
                once()

        fleet._maybe_rebalance = first_move_only
        asked = watch_parks(E["a"])
        fleet.start()
        with TickGate(E["a"]):
            req = fleet.submit(P1, max_new_tokens=STEPS)
            on_token(req, 1, hold_until(lambda: req in asked))
        got = list(req.stream())
        settle_clean(*E.values())
        s = fleet.stats()
        fleet.stop()
        return {"stream": got, "status": req.status, "counters": fleet_counters(fleet),
                "moves": s["rebalance_migrations"], "b_in": s["engines"]["b"]["migrations_in"],
                "hops": journey(fleet, req)["hops"]}

    out = run(weights, scenario)
    held(out, {"stream": refs[0], "status": "OK", "moves": 1, "b_in": 1,
               "hops": [("route", "a", "local"), ("rebalance", "b", "local")]})


def test_journey_migrate_once_stitched(weights, refs):
    """A session moved once (fleet.migrate_session, its loop held inside
    its second delivery until the park is queued) yields ONE stitched
    journey: two hops (route -> migrate), per-hop tokens summing to exactly
    the delivered stream, and a migration blackout window."""
    def scenario(k):
        fleet, E = k.fleet(("a", "b"), fc={"route_policy": PinPolicy("a")})
        asked = watch_parks(E["a"])
        fleet.start()
        held_ev = threading.Event()
        with TickGate(E["a"]):
            req = fleet.submit(P1, max_new_tokens=STEPS)
            on_token(req, 2, hold_until(lambda: req in asked, held_ev))
        assert held_ev.wait(60), "the loop was not held"
        rep = fleet.migrate_session(req, "b")
        got = list(req.stream())
        fleet.stop()
        j = fleet.trace.journeys()[req.jid]
        s = fleet.stats(include_engines=False)
        return {"path": rep["path"], "stream": got, "status": req.status,
                "journey": journey(fleet, req), "hop_tokens": [h["tokens"] for h in j["hops"]],
                "ttft_ok": all(h["ttft_ms"] is None or h["ttft_ms"] >= 0 for h in j["hops"]),
                "ordered": j["blackouts"][0]["src_last_tok_ns"]
                <= j["blackouts"][0]["dst_first_tok_ns"],
                "p50": s["migration_blackout_p50_ms"] is not None,
                "ended": (s["journeys_ended"], s["journeys_conserved"])}

    out = run(weights, scenario)
    held(out, {"path": "resident", "stream": refs[0], "status": "OK", "ttft_ok": True,
               "ordered": True, "p50": True, "ended": (1, 1)})
    j = out["port"]["journey"]
    assert j["hops"] == [("route", "a", "local"), ("migrate", "b", "local")]
    assert j["tokens"] == j["delivered"] == STEPS and j["conserved"] and not j["truncated"]
    assert j["blackouts"] == [("migration", "a", "b", True)]
    assert all(t > 0 for t in out["port"]["hop_tokens"])


def test_journey_failover_stitched_with_bundle(weights, refs):
    """A session rebuilt by failover yields one journey (route ->
    failover) with token conservation and a failover blackout bracketing
    the kill, and the dead engine leaves a post-mortem bundle (flight
    recorder): JSON, the corpse's ring, stats, signals and ledger census,
    dumped as JSON lines; the merged Chrome dump has the control track and
    both engines."""
    def scenario(k):
        plan = k.Plan()
        fleet, E = k.fleet(("a", "b"), faults_for={"a": plan},
                           fc={"route_policy": PinPolicy("a")})
        fleet.start()
        t_arm = []

        def arm():
            t_arm.append(time.monotonic_ns())
            plan.arm("engine_death")

        with TickGate(E["a"]):
            req = fleet.submit(P1, max_new_tokens=STEPS)
            on_token(req, 2, arm)
        got = list(req.stream())
        _reaped(fleet, E["a"])
        fleet.stop()
        j = fleet.trace.journeys()[req.jid]
        (b,) = j["blackouts"]
        bundle = fleet.trace.bundles()["a"]
        sio = io.StringIO()
        n_lines = fleet.trace.dump_bundle("a", sio)
        lines = [json.loads(ln) for ln in sio.getvalue().splitlines()]
        doc = fleet.trace.chrome_trace()
        s = fleet.stats(include_engines=False)
        return {
            "stream": got, "journey": journey(fleet, req),
            "brackets": b["dst_first_tok_ns"] > t_arm[0] and b["ms"] > 0
            and b["src_last_tok_ns"] <= b["dst_first_tok_ns"],
            "bundle_json": bundle == json.loads(json.dumps(bundle)),
            "bundle": (bundle["engine"], bundle["reason"], bundle["stats"]["generated_tokens"] >= 2,
                       bundle["signals"] is not None, sorted(bundle)),
            "census": any(c["jid"] == req.jid and c["delivered"] >= 2 and not c["unstarted"]
                          for c in bundle["ledger"]),
            "first_token_event": any(e["event"] == "first_token" for e in bundle["events"]),
            "dump": (n_lines == len(lines) > 2, lines[0]["kind"], lines[-1]["kind"]),
            "pids": {e["pid"] for e in doc["traceEvents"]} >= {1, 2, 3},
            "instants": {"route", "probe_miss", "dead", "fence", "failover_rebuild"} <= {
                e["name"] for e in doc["traceEvents"] if e["ph"] == "i" and e["pid"] == 1},
            "blackout_slice": any(e["ph"] == "X" and "blackout" in e["name"]
                                  for e in doc["traceEvents"] if e["pid"] == 1),
            "stats": (s["postmortem_bundles"], s["failover_blackout_p50_ms"] is not None,
                      s["rebuild_p50_ms"] is not None)}

    out = run(weights, scenario)
    held(out, {"stream": refs[0], "brackets": True, "bundle_json": True, "census": True,
               "first_token_event": True, "dump": (True, "postmortem", "chrome"),
               "pids": True, "instants": True, "blackout_slice": True,
               "stats": (1, True, True)})
    j = out["port"]["journey"]
    assert j["hops"] == [("route", "a", "local"), ("failover", "b", "local")]
    assert j["tokens"] == j["delivered"] == STEPS and j["conserved"]
    assert j["blackouts"] == [("failover", "a", "b", True)]
    assert out["port"]["bundle"][:2] == ("a", "dead")


def test_fleet_stats_and_ledger_shape(weights):
    """The ledger records a started session at tick heads with exactly
    the migrate handshake's metadata (its token history and pending token
    a prefix of the prompt and the stream), and stats() carries the fleet
    counters plus each engine's snapshot under its name. The entry is read
    on the loop thread, inside the session's third delivery."""
    def scenario(k):
        fleet, E = k.fleet(("a", "b"), fc={"route_policy": PinPolicy("a")})
        fleet.start()
        box = {}

        def snap():
            with fleet._mu:
                box["entry"] = dict(fleet._ledger["a"][req])
                box["sessions"] = sum(len(v) for v in fleet._ledger.values())

        with TickGate(E["a"]):
            req = fleet.submit(P1, max_new_tokens=STEPS)
            on_token(req, 3, snap)
        got = list(req.stream())
        s = fleet.stats()
        fleet.stop()
        e = box["entry"]
        seq = e["seq_len"]
        return {"unstarted": e["unstarted"], "exact": e["hist_exact"],
                "history": e["tokens"] + [e["pending"]] == (P1 + got)[:seq + 1],
                "seq_len": seq, "len_ok": seq == len(e["tokens"]), "n_pages": e["n_pages"],
                "meta_keys": sorted(e), "sessions": box["sessions"],
                "engines": sorted(s["engines"]),
                "generated": s["engines"]["a"]["generated_tokens"], "stream_len": len(got)}

    out = run(weights, scenario)
    held(out, {"unstarted": False, "exact": True, "history": True, "len_ok": True,
               "sessions": 1, "engines": ["a", "b"], "generated": STEPS,
               "stream_len": STEPS})
    assert out["port"]["n_pages"] >= 1 and out["port"]["seq_len"] >= len(P1)
