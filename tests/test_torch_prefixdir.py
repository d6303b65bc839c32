"""The port's prefix directory (``vtpu_torch.serving.prefixdir``) and the
fleet's prefix gravity against vtpu's on the same weights (CPU, f32), in
the reference's configuration (tests/test_prefixdir.py: the tiny model,
page 8, slots 2, ``prefill_chunk`` 8, ``kv_swap`` 8).

The directory's units run the same call sequence through both packages'
``PrefixDirectory`` and compare every answer. Every engine case runs one
scenario on JAX engines and on the port's and holds both runs to the same
outcome: streams equal to the JAX single-engine references, the same fleet
and engine prefix counters, the same residents, and
``prefix_install_copies`` 0 everywhere. The cases are tests/
test_prefixdir.py's thirteen: content addressing, the directory's
lifecycle, the route bonus, the hot and cold candidates, routing onto a
resident with the full-prompt fallback, ties by name, the pid API, hot
replication, export and install, cold spill and a tier install, failover
around a survivor's resident prefix (the rebuild recomputes only the tail:
``failover_prefix_reuses`` 1, its trace value the tail length), and the two
remote ones, a fabric member behind an in-proc host over a loopback link:
a payload-carrying install and a wire registration through the proxy, and
a remote resident as the route's target.

Nothing races the loop threads (tests/torch_fleet_kit.py): a prefixed
request is submitted while its engine's loop is held at a tick head, and
engine death is armed inside a chosen token's delivery. The gravity pass
stops after its first spill (an idle prefix would otherwise spill again).
A wall clock only guards against a hang, and the idle thresholds are
lower bounds a sleep passes. One torch thread."""

import time

import numpy as np
import pytest
import torch

from tests.torch_fleet_kit import (
    JCFG,
    PAGE,
    PinPolicy,
    TickGate,
    both,
    clean,
    fleet_counters,
    held,
    make_weights,
    on_token,
    settle_clean,
    wait,
)
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.prefixdir import (
    LOGITS_PLANE as J_LOGITS_PLANE,
    PrefixDirectory as JPrefixDirectory,
    export_prefix as j_export_prefix,
    install_prefix as j_install_prefix,
    prefix_id as j_prefix_id,
)
from vtpu_torch.serving.prefixdir import (
    LOGITS_PLANE,
    PrefixDirectory,
    export_prefix,
    install_prefix,
    prefix_id,
)

STEPS = 8    # short streams for routing and movement
KSTEPS = 20  # long enough that an armed kill lands mid-stream
BASE = dict(slots=2, prefill_buckets=(8,), max_new_tokens=KSTEPS, kv_page=PAGE,
            prefill_chunk=8, kv_swap=8)
# the fleet tests' wide ladder, and a tiny queue-slot denominator: the
# route bonus (0.25 * plen * ms_per_token / queue_slot_ms) then dominates a
# resident's own pinned-block handicap on any host
FC = dict(probe_interval_ms=5.0, miss_ms=2000.0, suspect_misses=2, dead_misses=4,
          prefix_queue_slot_ms=0.01)
# PRE / OPRE: two full pages (no copy-on-write boundary); KPRE: one page,
# leaving room for a KSTEPS stream within max_seq (8 + 3 + 20 <= 32)
PRE = list(range(1, 17))
OPRE = list(range(17, 33))
KPRE = list(range(33, 41))
SUF = [50, 51, 52]

PACKAGES = {"jax": (JPrefixDirectory, j_prefix_id), "port": (PrefixDirectory, prefix_id)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def prefix_refs(weights):
    """The JAX single-engine streams: "prefix" for PRE + SUF (equal to the
    full prompt's), "other" for OPRE + SUF, "kill" for KPRE + SUF at
    KSTEPS."""
    eng = JServingEngine(weights[0], JCFG, JServingConfig(**BASE))
    eng.start()
    try:
        lid = eng.register_prefix(PRE)
        pre = list(eng.submit(SUF, prefix=lid, max_new_tokens=STEPS).stream())
        full = list(eng.submit(PRE + SUF, max_new_tokens=STEPS).stream())
        assert pre == full
        other = list(eng.submit(OPRE + SUF, max_new_tokens=STEPS).stream())
        klid = eng.register_prefix(KPRE)
        kill = list(eng.submit(SUF, prefix=klid, max_new_tokens=KSTEPS).stream())
        return {"prefix": pre, "other": other, "kill": kill}
    finally:
        eng.stop()


def run(weights, scenario):
    return both(weights, scenario, BASE, FC)


def _units(scenario) -> dict:
    """A directory scenario on both packages' PrefixDirectory/prefix_id."""
    return {side: scenario(*classes) for side, classes in PACKAGES.items()}


def _engine_prefix_stats(s: dict, names) -> dict:
    keys = ("prefix_hits", "prefix_install_copies", "prefix_tier_installs", "prefix_exports",
            "failover_prefix_reuses")
    return {n: {k: s["engines"][n][k] for k in keys} for n in names}


# ------------------------------------------------------- directory units


def test_prefix_id_content_addressing():
    """The pid is a function of the token VALUES only (list, int64 array or
    tensor alike) and equals the reference's for the same tokens."""
    def scenario(_, pid_of):
        a = pid_of([1, 2, 3])
        return {"same": [a == pid_of([1, 2, 3]), a == pid_of(np.asarray([1, 2, 3], np.int64)),
                         a == pid_of(torch.tensor([1, 2, 3], dtype=torch.int32))],
                "differs": [a != pid_of([1, 2, 4]), a != pid_of([1, 2])],
                "shape": (len(a), int(a, 16) >= 0), "ids": [a, pid_of(PRE), pid_of(KPRE)]}

    out = _units(scenario)
    held(out, {"same": [True] * 3, "differs": [True] * 2, "shape": (16, True)})


def test_directory_lifecycle_unit():
    """Register, hit, release and unregister walk the refcount state
    machine (re-register refreshes the local id, releases floor at zero, a
    route hit moves hits not refs, unknown engines are no-ops); a pid with
    no resident survives only in the host tier, through a fence-time
    engine drop."""
    def scenario(Directory, pid_of):
        d, seen = Directory(), []
        pid = pid_of([1, 2, 3])
        d.on_event("a", "register", pid, lid=7, tokens=[1, 2, 3], length=3)
        seen.append((d.residents(pid), d.tokens_of(pid)))
        d.on_event("a", "register", pid, lid=9)
        d.on_event("a", "hit", pid)
        d.on_event("a", "hit", pid)
        d.on_event("a", "release", pid)
        seen.append((d.residents(pid), d.stats()))
        d.on_event("a", "release", pid)
        d.on_event("a", "release", pid)
        d.note_route_hit(pid, "a")
        d.note_miss()
        seen.append(d.stats())
        d.on_event("a", "unregister", pid, lid=9)
        seen.append((d.residents(pid), d.tokens_of(pid), d.stats()))
        d.on_event("ghost", "release", pid)
        d.on_event("ghost", "unregister", pid)
        pid2 = pid_of([4, 5])
        d.on_event("b", "register", pid2, lid=1, tokens=[4, 5], length=2)
        d.put_host(pid2, {"tokens": [4, 5], "len": 2}, {"plane": None})
        d.drop_engine("b")
        seen.append((d.residents(pid2), d.in_host_tier(pid2), d.tokens_of(pid2),
                     d.get_host(pid2)[0]["len"], d.stats()))
        return {"seen": seen}

    out = _units(scenario)
    held(out, {})
    seen = out["port"]["seen"]
    assert seen[0] == ({"a": 7}, [1, 2, 3]) and seen[1][0] == {"a": 9}
    assert (seen[1][1]["prefix_directory_hits"], seen[1][1]["prefix_live_refs"]) == (2, 1)
    assert (seen[2]["prefix_directory_hits"], seen[2]["prefix_live_refs"],
            seen[2]["prefix_directory_misses"]) == (3, 0, 1)
    assert seen[3][:2] == ({}, None) and seen[3][2]["prefix_pids"] == 0
    assert seen[4][:4] == ({}, True, [4, 5], 2)
    assert (seen[4][4]["prefix_pids"], seen[4][4]["prefix_host_tier"]) == (1, 1)


def test_route_bonus_arithmetic():
    """Registrations feed a 0.7/0.3 EMA of the measured per-token build
    cost; the bonus converts avoided prefill into least-pressure score
    units at 0.25 per queue slot."""
    def scenario(Directory, pid_of):
        d = Directory(queue_slot_ms=50.0)
        out = [d.route_bonus(16), d.ms_per_token()]
        d.on_event("a", "register", pid_of(list(range(10))), lid=0, tokens=list(range(10)),
                   length=10, build_ms=100.0)
        out += [d.ms_per_token(), d.route_bonus(16)]
        d.on_event("a", "register", pid_of(list(range(5))), lid=1, tokens=list(range(5)),
                   length=5, build_ms=100.0)
        out += [d.ms_per_token(), d.route_bonus(8)]
        return {"values": out}

    out = _units(scenario)
    held(out, {})
    v = out["port"]["values"]
    assert v[:2] == [0.0, None]
    assert v[2:] == pytest.approx([10.0, 0.25 * 16 * 10.0 / 50.0, 13.0, 0.25 * 8 * 13.0 / 50.0])


def test_directory_hot_cold_candidates():
    """Hot needs hits, headroom under the replica cap and a routable
    non-resident; cold needs zero live refs and a last hit older than the
    idle time (a lower bound the sleep passes)."""
    def scenario(Directory, pid_of):
        d = Directory()
        pid = pid_of([1, 2, 3, 4])
        d.on_event("a", "register", pid, lid=3, tokens=[1, 2, 3, 4], length=4)
        out = [d.hot_candidate(1, 2, ["a", "b"])]
        d.on_event("a", "hit", pid)
        out += [d.hot_candidate(1, 2, ["a", "b"]), d.hot_candidate(2, 2, ["a", "b"]),
                d.hot_candidate(1, 1, ["a", "b"]), d.hot_candidate(1, 2, ["a"]),
                d.cold_candidate(0.0, ["a"])]
        d.on_event("a", "release", pid)
        time.sleep(0.01)
        out += [d.cold_candidate(0.005, ["a"]), d.cold_candidate(60.0, ["a"]),
                d.cold_candidate(0.0, ["b"])]
        return {"candidates": out, "pid": pid}

    out = _units(scenario)
    held(out, {})
    pid = out["port"]["pid"]
    assert out["port"]["candidates"] == [None, (pid, [1, 2, 3, 4], "a"), None, None, None, None,
                                         (pid, "a", 3), None, None]


# -------------------------------------------------- prefix-aware routing


def test_prefix_route_steers_to_resident_and_falls_back(weights, prefix_refs):
    """The bonus out-scores equal-pressure peers (the resident's pinned
    blocks included) and the stream ships suffix-only; a prefix that lives
    nowhere falls back to a token-equal full prompt. Each prefix-aware
    submit is exactly one directory hit or one miss."""
    def scenario(k):
        fleet, E = k.fleet()
        fleet.start()
        cpid = fleet.register_prefix(PRE, engine="b")
        res = sorted(fleet.prefixdir.residents(cpid))
        decisive = fleet.prefixdir.route_bonus(len(PRE)) > 0.25
        req = fleet.submit(SUF, prefix_tokens=PRE, max_new_tokens=STEPS)
        where = fleet._assigned[req]
        got = list(req.stream())
        s1 = fleet.stats()
        req2 = fleet.submit(SUF, prefix_tokens=OPRE, max_new_tokens=STEPS)
        where2 = fleet._assigned[req2]
        got2 = list(req2.stream())
        settle_clean(E["a"], E["c"])
        s2 = fleet.stats()
        fleet.stop()
        return {"residents": res, "measured": fleet.prefixdir.ms_per_token() is not None,
                "decisive": decisive, "where": [where, where2], "streams": [got, got2],
                "routes": [s1["prefix_routes"], s2["prefix_routes"]],
                "directory": [(s["prefix_directory_hits"], s["prefix_directory_misses"])
                              for s in (s1, s2)],
                "engines": _engine_prefix_stats(s2, ("a", "b", "c")),
                "counters": fleet_counters(fleet)}

    out = run(weights, scenario)
    held(out, {"residents": ["b"], "measured": True, "decisive": True, "where": ["b", "a"],
               "streams": [prefix_refs["prefix"], prefix_refs["other"]], "routes": [1, 1],
               "directory": [(1, 0), (1, 1)]})
    e = out["port"]["engines"]
    assert [e[n]["prefix_hits"] for n in "abc"] == [0, 1, 0]
    assert all(e[n]["prefix_install_copies"] == 0 for n in "abc")


def test_prefix_route_ties_break_by_name(weights, prefix_refs):
    """Two equal-pressure residents carry the same bonus: the name order
    decides."""
    def scenario(k):
        fleet, _ = k.fleet()
        fleet.start()
        fleet.register_prefix(PRE, engine="c")
        cpid = fleet.register_prefix(PRE, engine="b")
        res = sorted(fleet.prefixdir.residents(cpid))
        req = fleet.submit(SUF, prefix_tokens=PRE, max_new_tokens=STEPS)
        got = list(req.stream())
        s = fleet.stats()
        fleet.stop()
        return {"residents": res, "stream": got,
                "engines": _engine_prefix_stats(s, ("b", "c"))}

    out = run(weights, scenario)
    held(out, {"residents": ["b", "c"], "stream": prefix_refs["prefix"]})
    assert [out["port"]["engines"][n]["prefix_hits"] for n in "bc"] == [1, 0]


def test_pid_api_validation(weights, prefix_refs):
    """The content pid is the fleet-level name: registration is idempotent
    across the fleet, a pid-only submit resolves its tokens through the
    directory, and an unknown pid or a pid that disagrees with the tokens
    fails typed."""
    def scenario(k):
        fleet, _ = k.fleet(("a", "b"))
        fleet.start()
        cpid = fleet.register_prefix(PRE, engine="a")
        again = fleet.register_prefix(PRE)
        res = sorted(fleet.prefixdir.residents(cpid))
        got = list(fleet.submit(SUF, pid=cpid, max_new_tokens=STEPS).stream())
        errors = []
        for kw in (dict(pid="0123456789abcdef"), dict(prefix_tokens=PRE, pid=prefix_id(OPRE))):
            with pytest.raises(ValueError):
                fleet.submit(SUF, **kw)
            errors.append(sorted(kw))
        fleet.stop()
        return {"pid": cpid, "again": again == cpid, "residents": res, "stream": got,
                "errors": errors}

    out = run(weights, scenario)
    held(out, {"pid": prefix_id(PRE), "again": True, "residents": ["a"],
               "stream": prefix_refs["prefix"]})


# ------------------------------------------------- replication and spill


def test_hot_prefix_replicates_without_copies(weights, prefix_refs):
    """One hit past the threshold and the monitor rebuilds the prefix on
    the peer through chunked prefill: no staged install, no per-admission
    copy, the replica serves token-equal, and the cap stops further
    replication."""
    def scenario(k):
        fleet, _ = k.fleet(("a", "b"), fc={"prefix_replicate_hits": 1,
                                           "prefix_max_replicas": 2})
        fleet.start()
        cpid = fleet.register_prefix(PRE, engine="a")
        got = list(fleet.submit(SUF, prefix_tokens=PRE, max_new_tokens=STEPS).stream())
        wait(lambda: len(fleet.prefixdir.residents(cpid)) == 2, "the hot replication")
        capped = fleet.prefixdir.hot_candidate(1, 2, ["a", "b"]) is None
        req2 = fleet.submit(SUF, prefix_tokens=PRE, max_new_tokens=STEPS)
        where2 = fleet._assigned[req2]
        got2 = list(req2.stream())
        s = fleet.stats()
        fleet.stop()
        return {"streams": [got, got2], "capped": capped, "where2": where2,
                "replications": s["prefix_replications"],
                "engines": _engine_prefix_stats(s, ("a", "b"))}

    out = run(weights, scenario)
    held(out, {"streams": [prefix_refs["prefix"]] * 2, "capped": True, "replications": 1})
    for n in "ab":
        e = out["port"]["engines"][n]
        assert e["prefix_install_copies"] == e["prefix_tier_installs"] == 0


def test_export_install_token_equal(weights, prefix_refs):
    """The movement primitives, no fleet: an export snapshots the blocks
    (and the final logits plane) through the staging gather, an install
    lands them in another engine's pool under the same content pid, and
    the suffix stream is token-equal; a second install of the pid is
    answered idempotently. Under a payload whose upload fails, the install
    hands its blocks back."""
    def scenario(k):
        a, b = k.engine(), k.engine()
        a.start()
        b.start()
        ex, inst, plane = ((j_export_prefix, j_install_prefix, J_LOGITS_PLANE)
                           if k.side == "jax" else (export_prefix, install_prefix, LOGITS_PLANE))
        lid = a.register_prefix(PRE)
        meta, payload = ex(a, lid)
        res = inst(b, meta, payload)
        got = list(b.submit(SUF, prefix=res["lid"], max_new_tokens=STEPS).stream())
        res2 = inst(b, meta, payload)
        sa, sb = a.stats(), b.stats()
        return {"meta": (meta["pid"], meta["len"], meta["pad"], meta["tokens"]),
                "logits_plane": plane in payload, "installed": [res["installed"],
                                                                 res2["installed"]],
                "same_lid": res2["lid"] == res["lid"], "stream": got,
                "a": (sa["prefix_exports"],),
                "b": (sb["prefix_tier_installs"], sb["prefix_install_copies"],
                      sb["prefix_hits"])}

    out = run(weights, scenario)
    held(out, {"meta": (prefix_id(PRE), len(PRE), 16, PRE), "logits_plane": True,
               "installed": [True, False], "same_lid": True, "stream": prefix_refs["prefix"],
               "a": (1,), "b": (1, 0, 1)})


def test_port_install_failure_releases_blocks(weights):
    """The port's install takes its blocks from the pool before the upload;
    an upload that raises (a payload whose planes are missing) answers the ticket
    with the error and gives every block back."""
    from vtpu_torch.serving import MigrationError, ServingConfig, ServingEngine

    from tests.torch_fleet_kit import CFG
    a = ServingEngine(weights[1], CFG, ServingConfig(**BASE), device="cpu")
    b = ServingEngine(weights[1], CFG, ServingConfig(**BASE), device="cpu")
    a.start()
    b.start()
    try:
        meta, payload = export_prefix(a, a.register_prefix(PRE))
        free = b.stats()["kv_pool_free"]
        broken = {LOGITS_PLANE: payload[LOGITS_PLANE],
                  **{key: None for key in payload if key != LOGITS_PLANE}}
        with pytest.raises(MigrationError):
            install_prefix(b, meta, broken)
        assert b.stats()["kv_pool_free"] == free
        assert b.stats()["prefix_tier_installs"] == 0 and not b._pid_index
    finally:
        a.stop()
        b.stop()


def test_cold_spill_then_any_engine_installs(weights, prefix_refs):
    """An idle zero-ref prefix spills to the shared host tier (export, then
    unregister: the pool frees, the pid lives on in the tier); a later pid
    submit installs it on the engine that wins the route and streams
    token-equal, with no per-admission copy, as exactly one directory hit
    or miss."""
    def scenario(k):
        fleet, E = k.fleet(("a", "b"), fc={"prefix_spill_idle_s": 0.05})
        fleet.start()
        cpid = fleet.register_prefix(PRE, engine="a")
        wait(lambda: fleet.prefixdir.in_host_tier(cpid) and not fleet.prefixdir.residents(cpid),
             "the cold spill")
        # one spill: the tier install below would go idle and spill again
        fleet.fleet = type(fleet.fleet)(**{**FC, "prefix_spill_idle_s": None})
        s1 = fleet.stats()
        tokens = fleet.prefixdir.tokens_of(cpid)
        req = fleet.submit(SUF, pid=cpid, max_new_tokens=STEPS)
        where = fleet._assigned[req]
        got = list(req.stream())
        s2 = fleet.stats()
        fleet.stop()
        return {"spills": s1["prefix_spills"], "exports": s1["engines"]["a"]["prefix_exports"],
                "tokens": tokens, "where": where, "stream": got,
                "installs": s2["prefix_installs"],
                "engines": _engine_prefix_stats(s2, ("a", "b")),
                "accounted": s2["prefix_directory_hits"] + s2["prefix_directory_misses"],
                "residents": sorted(fleet.prefixdir.residents(cpid))}

    out = run(weights, scenario)
    held(out, {"spills": 1, "exports": 1, "tokens": PRE, "where": "a",
               "stream": prefix_refs["prefix"], "installs": 1, "accounted": 1,
               "residents": ["a"]})
    e = out["port"]["engines"]
    assert e["a"]["prefix_tier_installs"] == 1
    assert all(e[n]["prefix_install_copies"] == 0 for n in "ab")


# ----------------------------------------------------- fabric round-trips


def test_remote_prefix_install_token_equal(weights, prefix_refs):
    """Both wire paths: a payload-carrying ``prefix_in`` ask installs a
    locally exported prefix on a loopback remote (idempotent on a second
    install), and a wire ``register_prefix`` builds one host-side; each
    serves its suffix stream through the proxy, and the proxy mirrors the
    registration's tokens (what a failover rebuild replays)."""
    def scenario(k):
        ex, inst = ((j_export_prefix, j_install_prefix) if k.side == "jax"
                    else (export_prefix, install_prefix))
        t = k.remote()
        a = k.engine()
        a.start()
        lid = a.register_prefix(PRE)
        meta, payload = ex(a, lid)
        res = inst(t.rem, meta, payload)
        got = list(t.rem.submit(SUF, prefix=res["lid"], max_new_tokens=STEPS).stream())
        res2 = inst(t.rem, meta, payload)
        lid2 = t.rem.register_prefix(OPRE)
        got2 = list(t.rem.submit(SUF, prefix=lid2, max_new_tokens=STEPS).stream())
        sh = t.eng.stats()
        wait(lambda: clean(t.eng), "the host's pool reading free")
        return {"installed": [res["installed"], res2["installed"]],
                "same_lid": res2["lid"] == res["lid"], "pid": res["pid"],
                "streams": [got, got2], "mirror": t.rem._prefix_meta[lid2]["tokens"],
                "host": (sh["prefix_tier_installs"], sh["prefix_install_copies"],
                         sh["prefix_hits"])}

    out = run(weights, scenario)
    held(out, {"installed": [True, False], "same_lid": True, "pid": prefix_id(PRE),
               "streams": [prefix_refs["prefix"], prefix_refs["other"]], "mirror": OPRE,
               "host": (1, 0, 2)})


def test_remote_fleet_prefix_route(weights, prefix_refs):
    """A remote resident is a first-class route target: the wire
    registration mirrors into the directory (its build cost included), the
    pid submit steers to the proxy over an idle local peer, and the hit is
    stamped at route time (a remote's loop thread reports on its host)."""
    def scenario(k):
        t = k.remote()
        e1 = k.engine()
        fleet = k.Fleet({"r0": t.rem, "e1": e1}, k.FleetConfig(**FC))
        k.fleets.append(fleet)
        fleet.start()
        wait(lambda: t.rem._beat_ns != 0, "the remote's warm-up beat")
        cpid = fleet.register_prefix(PRE, engine="r0")
        res = sorted(fleet.prefixdir.residents(cpid))
        measured = fleet.prefixdir.ms_per_token() is not None
        req = fleet.submit(SUF, pid=cpid, max_new_tokens=STEPS)
        got = list(req.stream())
        s = fleet.stats(include_engines=False)
        fleet.stop()
        return {"residents": res, "measured": measured, "stream": got,
                "routes": s["prefix_routes"],
                "directory": (s["prefix_directory_hits"], s["prefix_directory_misses"]),
                "remote_engines": s["remote_engines"],
                "hops": [(h["kind"], h["engine"], h["host"])
                         for h in fleet.trace.journeys()[req.jid]["hops"]]}

    out = run(weights, scenario)
    held(out, {"residents": ["r0"], "measured": True, "stream": prefix_refs["prefix"],
               "routes": 1, "directory": (1, 0), "remote_engines": 1,
               "hops": [("route", "r0", "h0")]})


# --------------------------------------------------------------- failover


def test_failover_prefix_reuse(weights, prefix_refs):
    """A survivor already holding the dead engine's prefix rebuilds the
    session around it: the registered page is shared (never re-prefilled),
    only the private tail recomputes (the fault_recompute event's value is
    exactly the tail's length), and the stream stays token-equal; the fence
    swept the corpse's residency."""
    def scenario(k):
        plan = k.Plan()
        fleet, E = k.fleet(("a", "b"), faults_for={"a": plan},
                           fc={"route_policy": PinPolicy("a")})
        fleet.start()
        cpid = fleet.register_prefix(KPRE, engine="a")
        fleet.register_prefix(KPRE, engine="b")
        with TickGate(E["a"]):
            req = fleet.submit(SUF, prefix_tokens=KPRE, max_new_tokens=KSTEPS)
            on_token(req, 2, lambda: plan.arm("engine_death"))
        where = fleet._assigned[req]
        got = list(req.stream())
        wait(lambda: fleet.stats(include_engines=False)["failovers"] >= 1, "the failover")
        settle_clean(E["a"])
        sb = E["b"].stats()
        evs = [e for e in E["b"].trace.events() if e["event"] == "fault_recompute"]
        s = fleet.stats(include_engines=False)
        # the session's cache length at death, from the corpse's ledger census
        (entry,) = [c for c in fleet.trace.bundles()["a"]["ledger"] if c["jid"] == req.jid]
        fleet.stop()
        return {"where": where, "stream": got, "status": req.status,
                "reuses": sb["failover_prefix_reuses"], "shared": sb["prefix_blocks_shared"],
                "recomputes": [e["val"] for e in evs], "failovers": s["failovers"],
                "tail": entry["seq_len"] - len(KPRE),
                "injected": plan.snapshot()["injected"]["engine_death"],
                "residents": sorted(fleet.prefixdir.residents(cpid)),
                "counters": fleet_counters(fleet)}

    out = run(weights, scenario)
    held(out, {"where": "a", "stream": prefix_refs["kill"], "status": "OK", "reuses": 1,
               "failovers": 1, "injected": 1, "residents": ["b"]})
    assert out["port"]["shared"] >= 1
    # one rebuild, whose value is the tail alone: the prefix's positions
    # were shared, never recomputed
    assert out["port"]["recomputes"] == [out["port"]["tail"]]
    assert 0 < out["port"]["tail"] < len(SUF) + KSTEPS
