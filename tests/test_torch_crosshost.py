"""The port's fabric (``vtpu_torch.serving.fabric``) serving fleet members
across a transport, against vtpu's (CPU, f32), in the reference's
configuration (tests/test_crosshost.py: the tiny model, page 8, slots 2,
``kv_swap`` 8, the KILL and HEAL ladders).

Each loopback case runs one scenario on a JAX fleet (vtpu's EngineHost,
RemoteEngine and engines) and on a port fleet on the same weights, and
holds both runs to the same outcome: every stream equal to the JAX engine's
stream served alone, up to its first step whose top-1/top-2 margin (the
JAX trunk teacher-forced on that stream) is under 1e-4; the same fleet
counters, health states and host-tagged journey hops; clean pools. The
claims: a remote member streams as a local one does (exact and int8
pools); a partitioned LINK walks SUSPECT and heals with no failover, the
seq + resend protocol replaying what the blip swallowed; an ask on a dead
link or a dead engine fails typed at once; an ENGINE death behind a live
link fails over from the client-side mirror; a corrupted payload
downgrades a migration to recompute; a cancel swallowed by a partition is
re-sent on heal. The TCP case spawns one port child process (the port's
seeded init, on the CPU), SIGKILLs it mid-stream and holds the stream,
finished on a local survivor, to an in-proc port engine built from the
same seed.

Nothing races the loop threads (tests/torch_fleet_kit.py): the host-side
mirror of a request is caught while the host's loop is held at a tick
head, and every action (a partition, an engine death, a hold until a park
or a cancel arrives) runs inside that mirror's chosen delivery, on the
host's loop thread; a partition ends on an observed ladder state or
counter, never after a wall-clock length. The child's decode stalls from
its eighth fetch on (``delayed_fetch``, 30 s a fetch), so the SIGKILL
always lands mid-stream. A wall clock only guards against a hang. One
torch thread, and the child gets ``OMP_NUM_THREADS=1``."""

import importlib
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fleet_kit import (
    CFG,
    DIMS,
    JCFG,
    PAGE,
    Kit,
    PinPolicy,
    TickGate,
    both,
    catch_submits,
    clean,
    count_tokens,
    hold_until,
    make_weights,
    on_token,
    settle_clean,
    wait,
    watch_parks,
)
from vtpu.models import ModelConfig as JModelConfig
from vtpu.models.transformer import decode_step as j_decode_step, prefill as j_prefill
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.fabric.host import reap_corpse as j_reap_corpse
from vtpu_torch.models import ModelConfig, init_params
from vtpu_torch.serving import (
    EngineFleet,
    FleetConfig,
    ServingConfig,
    ServingEngine,
    Status,
    connect_host,
    spawn_host,
    tcp_connect,
)
from vtpu_torch.serving.fabric.host import reap_corpse

# the modules (each package's ``migrate`` name is the function)
j_migrate_mod = importlib.import_module("vtpu.serving.migrate")
p_migrate_mod = importlib.import_module("vtpu_torch.serving.migrate")

STEPS = 20
# two prefill buckets: a failed-over or payload-lost session rebuilds
# through prefill, its sequence possibly past the small bucket
BASE = dict(slots=2, prefill_buckets=(8, 32), max_new_tokens=STEPS, kv_page=PAGE, kv_swap=8)
# KILL declares a silent member DEAD ~2 s after its last beat; HEAL has a
# 500 ms miss window and a long SUSPECT stretch (300 probes) to heal inside
FC_KILL = dict(probe_interval_ms=5.0, miss_ms=2000.0, suspect_misses=2, dead_misses=4)
FC_HEAL = dict(probe_interval_ms=5.0, miss_ms=500.0, suspect_misses=2, dead_misses=300)
MARGIN = 1e-4
JCFG8 = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=True)
CFG8 = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=True)
# the child's decode stalls from this fetch on, long enough that the
# SIGKILL always finds the stream unfinished
STALL_AT, STALL_S = 8, 30.0


def _prompt(seed, n):
    return [int(t) for t in jax.random.randint(jax.random.key(seed), (n,), 1, DIMS["vocab"],
                                               jnp.int32)]


P1, P2, P3 = _prompt(1, 5), _prompt(2, 6), _prompt(3, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


_REFS: dict = {}


def _ref(weights, jcfg, prompt):
    """The JAX engine's greedy stream of ``prompt`` served alone, and each
    step's top-1/top-2 logit margin from the JAX trunk fed that stream."""
    key = (jcfg.kv_int8, tuple(prompt))
    if key not in _REFS:
        jp = weights[0]
        eng = JServingEngine(jp, jcfg, JServingConfig(**BASE))
        eng.start()
        try:
            stream = list(eng.submit(prompt, max_new_tokens=STEPS).stream())
        finally:
            eng.stop()
        logits, cache = j_prefill(jp, jcfg, jnp.asarray([prompt], jnp.int32))
        row = np.asarray(logits)[0, -1]
        margins = []
        for tok in stream:
            top2 = np.sort(row)[-2:]
            margins.append(float(top2[1] - top2[0]))
            logits, cache = j_decode_step(jp, jcfg, cache, jnp.asarray([tok], jnp.int32))
            row = np.asarray(logits)[0]
        _REFS[key] = (stream, margins)
    return _REFS[key]


def _agree(got, ref) -> int:
    """``got`` equals the reference stream up to its first step whose
    margin is under MARGIN; returns the tokens compared."""
    want, margins = ref
    assert len(got) == len(want), (got, want)
    compared = 0
    for a, b, m in zip(got, want, margins):
        if m < MARGIN:
            break
        assert a == b, (got, want)
        compared += 1
    return compared


def _mig(k):
    """(migrate module, reap_corpse) of the kit's side."""
    return (j_migrate_mod, j_reap_corpse) if k.side == "jax" else (p_migrate_mod, reap_corpse)


def _member_fleet(k, t, fc, n_local=2):
    """The remote proxy ``r0`` pinned, plus ``n_local`` local engines."""
    engines = {"r0": t.rem, **{f"e{i + 1}": k.engine() for i in range(n_local)}}
    fleet = k.Fleet(engines, k.FleetConfig(**fc, route_policy=PinPolicy("r0")))
    k.fleets.append(fleet)
    return fleet, engines


def _warm(t):
    wait(lambda: t.rem._beat_ns != 0, "the remote's warm-up beat")


def _hops(fleet, req) -> list:
    return [(h["kind"], h["host"]) for h in fleet.trace.journeys()[req.jid]["hops"]]


# -------------------------------------------------------- token equality


@pytest.mark.parametrize("layout", ["exact", "int8"])
def test_loopback_fleet_token_equal(weights, layout):
    """A fleet whose pinned member is remote streams the tokens an engine
    served alone does, for the exact and int8 pools (the wire carries ints;
    the layout lives host-side); the route hop carries the host's label and
    the heartbeat RTT reaches the proxy's signals."""
    cfgs = (JCFG8, CFG8) if layout == "int8" else (JCFG, CFG)
    ref = _ref(weights, cfgs[0], P1)

    def scenario(k):
        t = k.remote()
        fleet, E = _member_fleet(k, t, FC_HEAL, n_local=1)
        fleet.start()
        _warm(t)
        req = fleet.submit(P1, max_new_tokens=STEPS)
        got = list(req.stream())
        st = fleet.stats(include_engines=False)
        rtt = t.rem.signals().fabric_rtt_ms
        fleet.stop()
        return {"compared": _agree(got, ref), "status": req.status,
                "failovers": st["failovers"], "remote_engines": st["remote_engines"],
                "msgs": (st["fabric_msgs_sent"] > 0, st["fabric_msgs_recv"] > 0),
                "hops": _hops(fleet, req), "rtt": rtt is not None and rtt > 0,
                "clean": settle_clean(t.eng, E["e1"])}

    out = both(weights, scenario, BASE, FC_HEAL, cfgs)
    assert out["port"] == out["jax"]
    assert out["port"] == {"compared": STEPS, "status": "OK", "failovers": 0,
                           "remote_engines": 1, "msgs": (True, True),
                           "hops": [("route", "h0")], "rtt": True, "clean": True}


# ----------------------------------------------- link death != engine death


def test_partition_suspect_heal_no_failover(weights):
    """A partitioned link walks the remote to SUSPECT as a hung engine
    would; healed at that transition, the fresh pong restores HEALTHY with
    no failover. A partition mid-stream, while the host generates three
    tokens into it (their sends dropped), is survived token-exact: on heal
    the client sees the seq gap and the resend replays it."""
    ref = _ref(weights, JCFG, P2)

    def scenario(k):
        t = k.remote()
        fleet, E = _member_fleet(k, t, FC_HEAL)
        fleet.start()
        _warm(t)

        def state():
            return fleet.stats(include_engines=False)["engine_states"]["r0"]

        # quiet partition, healed inside the monitor's SUSPECT transition
        control = fleet.trace.control

        def heal_at_suspect(event, *a, **kw):
            control(event, *a, **kw)
            if event == "suspect" and kw.get("engine") == "r0":
                t.link.partition(False)

        fleet.trace.control = heal_at_suspect
        t.link.partition(True)
        wait(lambda: fleet.stats(include_engines=False)["suspects"] >= 1, "SUSPECT")
        wait(lambda: state() == "HEALTHY", "HEALTHY after the heal")
        fleet.trace.control = control
        quiet = fleet.stats(include_engines=False)
        # mid-stream: the client holds token 1 when the link drops; the
        # host's loop holds at token 4 until the heal
        caught, healed = catch_submits(t.eng), threading.Event()
        with TickGate(t.eng):
            req = fleet.submit(P2, max_new_tokens=STEPS)
            (mirror,) = caught
            dropped = t.host_chan.counters["msgs_dropped"]

            def blackout():
                wait(lambda: req.delivered >= 1, "token 1 on the client")
                t.link.partition(True)

            on_token(mirror, 1, blackout)
            on_token(mirror, 4, hold_until(healed.is_set))
        wait(lambda: t.host_chan.counters["msgs_dropped"] >= dropped + 3,
             "three tokens sent into the partition")
        t.link.partition(False)
        healed.set()
        got = list(req.stream())
        st = fleet.stats(include_engines=False)
        fleet.stop()
        return {"quiet": (quiet["suspects"], quiet["failovers"],
                          quiet["engine_states"]["r0"]),
                "compared": _agree(got, ref), "status": req.status,
                "failovers": st["failovers"], "resent": st["fabric_resends"] >= 1,
                "clean": settle_clean(t.eng, *(E[n] for n in ("e1", "e2")))}

    out = both(weights, scenario, BASE, FC_HEAL)
    assert out["port"] == out["jax"]
    assert out["port"] == {"quiet": (1, 0, "HEALTHY"), "compared": STEPS, "status": "OK",
                           "failovers": 0, "resent": True, "clean": True}


def test_dropped_link_ask_fails_typed_fast(weights):
    """Once the transport is KNOWN dead (a receive error, unlike a silent
    partition), a lifecycle ask fails with a typed MigrationError at once,
    on the dead-link path (never its 60 s timeout); the host's channel
    sweep cancels the session it served."""

    def scenario(k):
        mig, _ = _mig(k)
        t = k.remote()
        _warm(t)
        req = t.rem.submit(P1, max_new_tokens=STEPS)
        first = req.out.get()
        t.host_chan.close()
        wait(lambda: not t.client.link_ok, "the link marked broken")
        with pytest.raises(mig.MigrationError, match="link to h0 is down"):
            t.rem.ask("migrate_out", mig._Ticket(req), timeout=60.0)
        req.cancel()
        return {"first": isinstance(first, int), "timeouts": t.client.fabric_stats()["timeouts"],
                "clean": settle_clean(t.eng)}

    out = both(weights, scenario, BASE, FC_KILL)
    assert out["port"] == out["jax"] == {"first": True, "timeouts": 0, "clean": True}


def test_ask_on_dead_local_engine_fails_typed_fast(weights):
    """An ask on an engine whose loop died fails typed at once (the watched
    wait sees the corpse), not at its 60 s timeout; the host supervisor's
    corpse reap (``reap_corpse``, the fleet reap's sweep) leaves the pool,
    host tier and slots free."""

    def scenario(k):
        mig, reap = _mig(k)
        plan = k.Plan()
        eng = k.engine(faults=plan)
        eng.start()
        with TickGate(eng):
            req = eng.submit(P1, max_new_tokens=STEPS)
            on_token(req, 1, lambda: plan.arm("engine_death"))
        wait(lambda: eng._died, "the engine's death")
        with pytest.raises(mig.MigrationError, match="serving loop is dead"):
            mig._ask(eng, "migrate_out", mig._Ticket(req), timeout=60.0)
        before = clean(eng)
        reap(eng)
        return {"status": req.status, "delivered": req.delivered, "clean": (before, clean(eng))}

    out = both(weights, scenario, BASE, FC_KILL)
    assert out["port"] == out["jax"] == {"status": None, "delivered": 1,
                                         "clean": (False, True)}


def test_dead_engine_behind_live_link_fails_over(weights):
    """The host-side ENGINE dies (its loop gone, no cleanup) while the link
    stays healthy: the host-reported beat age goes stale, the ladder
    declares DEAD, and the stream finishes on a local survivor, rebuilt
    from the client-side mirror ledger; the journey's hops are tagged h0
    then local, conserved; the host reaps its corpse."""
    ref = _ref(weights, JCFG, P3)

    def scenario(k):
        plan = k.Plan()
        t = k.remote(faults=plan)
        fleet, E = _member_fleet(k, t, FC_KILL)
        fleet.start()
        _warm(t)
        caught = catch_submits(t.eng)
        with TickGate(t.eng):
            req = fleet.submit(P3, max_new_tokens=STEPS)
            on_token(caught[0], 2, lambda: plan.arm("engine_death"))
        got = list(req.stream())
        wait(lambda: fleet.stats(include_engines=False)["journeys_ended"] >= 1,
             "the journey's close")
        st = fleet.stats(include_engines=False)
        j = fleet.trace.journeys()[req.jid]
        link_ok = t.client.link_ok
        clean_after = settle_clean(t.eng, E["e1"], E["e2"])
        fleet.stop()
        return {"compared": _agree(got, ref), "status": req.status,
                "failovers": st["failovers"], "state": st["engine_states"]["r0"],
                "link_ok": link_ok, "hops": _hops(fleet, req), "conserved": j["conserved"],
                "clean": clean_after}

    out = both(weights, scenario, BASE, FC_KILL)
    assert out["port"] == out["jax"]
    assert out["port"] == {"compared": STEPS, "status": "OK", "failovers": 1, "state": "DEAD",
                           "link_ok": True, "hops": [("route", "h0"), ("failover", "local")],
                           "conserved": True, "clean": True}


# ----------------------------------------------------- payload integrity


def test_payload_corruption_downgrades_to_recompute(weights):
    """A migration payload whose chunk CRC fails in transit is dropped at
    decode (payload_lost) and the destination rebuilds the session through
    the recompute path: the stream stays equal, never wrong tokens. The
    intact run after it ships the pages and installs them resident, its
    bytes counted on the wire. Each session is still live on the host when
    its park is asked (the host's loop holds inside its first token until
    then), and moves once the park took effect and the client holds every
    token the host delivered: the reference's host sends the extract's
    reply without waiting for the session's pump, so a token still on its
    way is dropped with the client's mirror (the port's host ships it
    first)."""
    refs = {"corrupt": _ref(weights, JCFG, P2), "intact": _ref(weights, JCFG, P3)}

    def scenario(k):
        mig, _ = _mig(k)
        plan = k.Plan()
        t = k.remote(link_faults=plan)
        dst = k.engine()
        dst.start()
        _warm(t)
        asked, caught = watch_parks(t.eng), catch_submits(t.eng)
        out, moved = {}, {}
        for name, prompt in (("corrupt", P2), ("intact", P3)):
            held = threading.Event()
            with TickGate(t.eng):
                req = t.rem.submit(prompt, max_new_tokens=STEPS)
                seen = count_tokens(req)
                mirror = caught[-1]
                on_token(mirror, 1, hold_until(lambda m=mirror: m in asked, held))
            wait(held.is_set, "the host's loop held inside token 1")
            if name == "corrupt":
                plan.arm("fabric_payload_corrupt", count=1)
            t.rem.park(req)
            wait(lambda: seen[0] == mirror.delivered, "every delivered token at the client")
            rep = mig.migrate(req, t.rem, dst)
            got = list(req.stream())
            out[name] = (rep["path"], _agree(got, refs[name]), req.status)
            moved[name] = rep["bytes"]
        fs = t.client.fabric_stats()
        out["checksum_faults"] = fs["checksum_faults"]
        # the pages a session holds at its park are each package's own
        # count; the wire carried at least the intact payload's bytes
        out["bytes"] = (moved["corrupt"], fs["payload_bytes_recv"] >= moved["intact"] > 0)
        out["pools_free"] = settle_clean(t.eng, dst)
        return out

    out = both(weights, scenario, BASE, FC_KILL)
    assert out["port"] == out["jax"]
    assert out["port"]["corrupt"] == ("recompute", STEPS, "OK")
    assert out["port"]["intact"][0] in ("resident", "host")
    assert out["port"]["intact"][1:] == (STEPS, "OK")
    assert out["port"]["bytes"] == (0, True) and out["port"]["checksum_faults"] == 1
    assert out["port"]["pools_free"] is True


def test_cancel_swallowed_by_partition_retransmits_on_heal(weights):
    """A cancel sent into a partition is silently lost (the send succeeds
    onto a dead link). Cancels re-send until the terminal arrives, so after
    the heal one reaches the host and the host stops decoding: the stream
    ends CANCELLED, not after its whole budget. The host's loop holds
    inside the first token until the cancel has arrived; the heal follows
    two cancels sent into the partition."""

    def scenario(k):
        t = k.remote()
        _warm(t)
        caught = catch_submits(t.eng)
        with TickGate(t.eng):
            req = t.rem.submit(P1, max_new_tokens=STEPS)
            mirror = caught[-1]
            on_token(mirror, 1, hold_until(lambda: mirror.cancelled))
        first = req.out.get()
        lost, send = [], t.client.chan.send

        def counting(msg, payload=None):
            if msg.get("kind") == "cancel" and t.link.partitioned:
                lost.append(msg)
            return send(msg, payload)

        t.client.chan.send = counting
        t.link.partition(True)
        req.cancel()
        wait(lambda: len(lost) >= 2, "two cancels sent into the partition")
        t.link.partition(False)
        wait(lambda: req.status is not None, "the terminal after the heal")
        return {"first": isinstance(first, int), "status": req.status,
                "host_delivered": mirror.delivered, "pools_free": settle_clean(t.eng)}

    out = both(weights, scenario, BASE, FC_KILL)
    assert out["port"] == out["jax"] == {"first": True, "status": "CANCELLED",
                                         "host_delivered": 1, "pools_free": True}


def test_park_answers_once_its_command_took_effect():
    """The host answers a park ask only once the loop took the command and
    the session is parked with no park or resume pending: a session a
    migration just installed is in the parked set while its resume is
    queued, and an extract asked on an early answer would find it gone once
    the resume advanced (port only: the reference's host answers on the
    parked set alone)."""
    import queue
    from types import SimpleNamespace

    from vtpu_torch.serving.fabric.host import _park_settled

    req = object()
    eng = SimpleNamespace(_lifecycle_q=queue.Queue(), _parked={req: {}}, _want_park=set(),
                          _want_resume=[req])
    eng._lifecycle_q.put(("resume", req))
    eng._lifecycle_q.put(("park", req))
    assert not _park_settled(eng, req)  # the park is still queued
    eng._lifecycle_q = queue.Queue()
    assert not _park_settled(eng, req)  # the resume is still pending
    eng._want_resume.clear()
    eng._want_park.add(req)
    assert not _park_settled(eng, req)  # parking a live slot at a later tick head
    eng._want_park.clear()
    assert _park_settled(eng, req)
    eng._parked.clear()
    assert not _park_settled(eng, req)


def test_back_to_back_migration_through_a_remote(weights):
    """A session migrated local -> remote and straight back (the park asked
    while the install's resume may still be pending on the host) streams
    on, equal to the engine served alone, both moves resident. The host's
    loop is held from the first move's return until the park is queued, so
    the session is still live on the remote when it is asked (port only:
    see the previous case)."""
    ref = _ref(weights, JCFG, P2)
    k = Kit("port", weights, BASE, FC_KILL)
    try:
        t = k.remote()
        local = k.engine()
        local.start()
        _warm(t)
        asked, host_asked = watch_parks(local), watch_parks(t.eng)
        held = threading.Event()
        with TickGate(local):
            req = local.submit(P2, max_new_tokens=STEPS)
            on_token(req, 2, hold_until(lambda: req in asked, held))
        wait(held.is_set, "the local loop held inside token 2")
        gate = TickGate(t.eng)
        reps = [p_migrate_mod.migrate(req, local, t.rem)]
        with gate:
            back = {}
            mover = threading.Thread(
                target=lambda: back.setdefault("rep", p_migrate_mod.migrate(req, t.rem, local)),
                daemon=True)
            mover.start()
            wait(lambda: len(host_asked) == 1, "the park asked of the host")
        mover.join(60)
        reps.append(back["rep"])
        got = list(req.stream())
        assert [r["path"] for r in reps] == ["resident", "resident"]
        assert _agree(got, ref) == STEPS and req.status == Status.OK
        assert settle_clean(t.eng, local)
    finally:
        k.close()


# ------------------------------------------------------------ TCP + kill


def test_tcp_sigkill_child_failover_token_equal(weights):
    """A child process serving a port engine over TCP (the port's seeded
    init, ``"device": "cpu"``) is SIGKILLed mid-stream; the stream finishes
    on a local survivor, rebuilt from the client-side mirror, equal to an
    in-proc port engine's built from the same seed. The link reads down,
    the journey's hops are tagged h0 then local, and the survivors' pools
    are free."""
    cfg = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
    params = init_params(0, cfg, device="cpu")

    def engine():
        return ServingEngine(params, cfg, ServingConfig(**BASE), device="cpu")

    ref_eng = engine()
    ref_eng.start()
    try:
        want = list(ref_eng.submit(P1, max_new_tokens=STEPS).stream())
    finally:
        ref_eng.stop()
    spec = {"model": dict(DIMS, dtype="float32", use_kernels=True), "seed": 0,
            "device": "cpu",
            "engines": {"r0": dict(
                slots=2, prefill_buckets=[8, 32], max_new_tokens=STEPS, kv_page=PAGE,
                kv_swap=8, faults=[dict(seam="delayed_fetch", at=STALL_AT, count=100000,
                                        arg=STALL_S)])}}
    proc, port = spawn_host(spec, env={"OMP_NUM_THREADS": "1"})
    client = fleet = None
    try:
        client, engines = connect_host(tcp_connect("127.0.0.1", port), host="h0", proc=proc)
        rem = engines["r0"]
        assert rem._page == PAGE and rem._block_bytes > 0 and rem.mesh is None
        survivors = {"e1": engine(), "e2": engine()}
        fleet = EngineFleet({"r0": rem, **survivors}, FleetConfig(
            **FC_KILL, route_policy=PinPolicy("r0")))
        fleet.start()
        wait(lambda: rem._beat_ns != 0, "the child's warm-up beat")
        req = fleet.submit(P1, max_new_tokens=STEPS)
        it = iter(req.stream())
        got = [next(it), next(it), next(it)]
        os.kill(proc.pid, signal.SIGKILL)
        assert proc.wait() == -signal.SIGKILL
        got += list(it)
        assert got == want
        assert req.status == Status.OK
        wait(lambda: fleet.stats(include_engines=False)["journeys_ended"] >= 1,
             "the journey's close")
        st = fleet.stats(include_engines=False)
        assert (st["failovers"], st["fabric_links_down"]) == (1, 1)
        assert st["failover_blackout_p99_ms"] is not None
        assert _hops(fleet, req) == [("route", "h0"), ("failover", "local")]
        assert settle_clean(*survivors.values())
    finally:
        if fleet is not None:
            fleet.stop()
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
