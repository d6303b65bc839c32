"""The port's live migration and drain (``vtpu_torch.serving.migrate``,
``ServingEngine.drain``) against vtpu's on the same weights (CPU, f32), in
the reference's configuration (tests/test_migrate.py).

Every case runs one scenario twice, on a pair of JAX engines with
``vtpu.serving.migrate`` and on a pair of the port's engines with its
``migrate``, and holds both runs to the same outcome: streams equal to the
JAX engine's stay-put streams, the same report paths, equal migration
counters (sessions and payload bytes each way, ``migration_copies`` 0,
rebuilds, failures), clean pools and host tiers, and the trace's migrate
subsequences. The cases are tests/test_migrate.py's one-device cases:
mid-stream, parked and spilled, a waiting request, source death, payload
loss (rebuilt, and FAULTED where nothing can rebuild it), cancels before
the extract and between extract and install, the pair checks, drain, and
drain with a waiting prefix-backed request; and one of the port's own: an
engine under ``mesh=`` migrates and drains both ways, and two engines'
adapters cannot drive one process group.

Nothing races the loop thread. A park is asked inside the delivery of a
chosen token (``_on_token``); a request is made to wait by queueing it
before ``start()`` behind a full slot set; where drain must find a session
still decoding, that session's delivery holds the loop until drain's park
command is queued (``_hold_until_asked``), so the park settles at the
same token on both packages. No verdict hangs on a wall-clock threshold; a
waiting loop only guards against a hang. One torch thread."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.obs.trace import (
    MIGRATE_DST_SEQUENCE as J_DST_SEQUENCE, MIGRATE_SRC_SEQUENCE as J_SRC_SEQUENCE,
    subsequence as j_subsequence,
)
from vtpu.serving import (
    FaultPlan as JFaultPlan, FaultSpec as JFaultSpec, MigrationError as JMigrationError,
    ServingConfig as JServingConfig, ServingEngine as JServingEngine, migrate as j_migrate,
)
from vtpu.serving.migrate import _ask as j_ask, _Ticket as JTicket
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.obs.trace import (
    MIGRATE_DST_SEQUENCE, MIGRATE_SRC_SEQUENCE, subsequence,
)
from vtpu_torch.parallel import TpMesh
from vtpu_torch.serving import (
    FaultPlan, FaultSpec, MigrationError, ServingConfig, ServingEngine, migrate,
)
from vtpu_torch.serving.migrate import _ask, _Ticket

# the reference test's model and serving shape
DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=32, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
PAGE = 8
STEPS = 8
BASE = dict(slots=2, prefill_buckets=(8,), max_new_tokens=STEPS, kv_page=PAGE,
            prefill_chunk=8, kv_swap=8)
# the budget of a session drain must find still decoding: its delivery
# holds the loop until drain's park is queued, and the park settles within
# two tokens of that
LONG = 20
PREFIX = list(range(1, 17))  # two full pages, no copy-on-write boundary


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompt(seed, n=5):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


P1, P2, P3, P4 = _prompt(1, 5), _prompt(2, 6), _prompt(3, 5), _prompt(99, 5)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_numpy(tree, CFG, device="cpu")


@pytest.fixture(scope="module")
def refs(weights):
    """The JAX engine's stay-put streams (one engine, nothing moves):
    P1-P3 at STEPS, P1 at LONG, and the prefixed request."""
    eng = JServingEngine(weights[0], JCFG, JServingConfig(**BASE))
    eng.start()
    try:
        out = {i: list(eng.submit(p, max_new_tokens=STEPS).stream())
               for i, p in enumerate((P1, P2, P3))}
        out["long"] = list(eng.submit(P1, max_new_tokens=LONG).stream())
        pid = eng.register_prefix(PREFIX)
        out["prefixed"] = list(eng.submit([7, 8], max_new_tokens=4, prefix=pid).stream())
    finally:
        eng.stop()
    return out


class Kit:
    """One side of a scenario: the JAX package's engine and migration, or
    the port's, behind the same names. Every engine it builds stops when
    the scenario ends."""

    def __init__(self, side: str, weights):
        self.side = side
        self.engines = []
        if side == "jax":
            self._make = lambda sc: JServingEngine(weights[0], JCFG, sc)
            self.Config, self.Plan, self.Spec = JServingConfig, JFaultPlan, JFaultSpec
            self.migrate, self.Error = j_migrate, JMigrationError
            self.Ticket, self.ask = JTicket, j_ask
            self.seqs = (J_SRC_SEQUENCE, J_DST_SEQUENCE)
            self.subsequence = j_subsequence
        else:
            self._make = lambda sc: ServingEngine(weights[1], CFG, sc, device="cpu")
            self.Config, self.Plan, self.Spec = ServingConfig, FaultPlan, FaultSpec
            self.migrate, self.Error = migrate, MigrationError
            self.Ticket, self.ask = _Ticket, _ask
            self.seqs = (MIGRATE_SRC_SEQUENCE, MIGRATE_DST_SEQUENCE)
            self.subsequence = subsequence

    def engine(self, start=True, base=BASE, fault=None, **kw):
        if fault is not None:
            kw["faults"] = self.Plan([self.Spec(fault, at=0)])
        eng = self._make(self.Config(**{**base, **kw}))
        self.engines.append(eng)
        if start:
            eng.start()
        return eng

    def close(self):
        for eng in self.engines:
            eng.stop()

    def traces_hold(self, src, dst) -> bool:
        """The source's trace holds the migrate-out subsequence and the
        destination's the migrate-in one."""
        ev = lambda eng: [e["event"] for e in eng.trace.events()]  # noqa: E731
        return (self.subsequence(self.seqs[0], ev(src))
                and self.subsequence(self.seqs[1], ev(dst)))


def _both(weights, scenario):
    """Run ``scenario(kit)`` on the JAX package and on the port; returns
    {"jax": ..., "port": ...}. Every engine stops, whatever happens."""
    out = {}
    for side in ("jax", "port"):
        kit = Kit(side, weights)
        try:
            out[side] = scenario(kit)
        finally:
            kit.close()
        assert not EXPIRED_HOLDS, f"{side}: a held loop was never asked for its park"
    return out


def _on_token(req, n, action):
    """Run ``action()`` on the loop thread right after ``req``'s n-th token
    is put on its stream (inside that delivery)."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if isinstance(item, (int, np.integer)):
            seen[0] += 1
            if seen[0] == n:
                action()

    req.out.put = hook


# holds whose hang guard expired: the scenario lost its determinism
EXPIRED_HOLDS: list = []


def _hold_until_asked(eng, req, go: threading.Event, held: threading.Event = None):
    """A delivery action that holds the loop thread (setting ``held``)
    until the client has set ``go`` and drain has queued ``req``'s park:
    the park is taken at the next tick head, wherever the host's speed
    would have put it."""
    def asked():
        return any(kind == "park" and item is req for kind, item in list(eng._lifecycle_q.queue))

    def hold():
        if held is not None:
            held.set()
        t0 = time.perf_counter()
        while not (go.is_set() and asked()):
            if time.perf_counter() - t0 > 60:
                EXPIRED_HOLDS.append(req)  # a hang guard; _both fails the case
                return
            time.sleep(0.001)

    return hold


def _wait(cond, what, timeout=60.0):
    """A hang guard, never a verdict: poll ``cond`` until it holds."""
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, f"{what} did not happen within {timeout} s"
        time.sleep(0.002)


def _clean(eng) -> bool:
    s = eng.stats()
    return (s["kv_pool_free"] == s["kv_pool_blocks"] and s["parked_sessions"] == 0
            and s["active_slots"] == 0 and s["queued"] == 0
            and (not s["swap_host_blocks"] or s["swap_host_free"] == s["swap_host_blocks"]))


def _settle_clean(*engines):
    """Wait until every engine's pool, host tier, parked set and slots read
    free (a stream ends inside the delivery that retires it, before its
    blocks go back); a leak fails the hang guard."""
    for eng in engines:
        _wait(lambda: _clean(eng), "the pools reading free")
    return True


MIGRATE_KEYS = ("migrations_out", "migrations_in", "migrate_out_bytes", "migrate_in_bytes",
                "migration_copies", "migrate_recomputes", "migrate_failures")


def _counters(src, dst) -> dict:
    s, d = src.stats(), dst.stats()
    return {"src": {k: s[k] for k in MIGRATE_KEYS}, "dst": {k: d[k] for k in MIGRATE_KEYS}}


def _held(out, expect):
    """Both packages' runs equal, and equal to ``expect`` where given."""
    assert out["port"] == out["jax"]
    for key, want in expect.items():
        assert out["port"][key] == want, key


# ------------------------------------------------------------- happy path


def test_migrate_mid_stream_token_equal(weights, refs):
    """A session parked after its second token migrates with its pages
    resident: one snapshot on the source, one staged upload on the
    destination, a row remap at resume; the stream continues at exactly
    its next token, migration_copies is 0 on both engines, the payload
    bytes match each way, and both traces hold the handshake."""
    def scenario(k):
        src, dst = k.engine(), k.engine()
        r = src.submit(P1, max_new_tokens=STEPS)
        _on_token(r, 2, lambda: src.park(r))
        _wait(lambda: r in src._parked, "the park")
        rep = k.migrate(r, src, dst)
        got = list(r.stream())
        _settle_clean(src, dst)
        return {"stream": got, "status": str(r.status), "path": rep["path"],
                "bytes": rep["bytes"], "counters": _counters(src, dst),
                "traces": k.traces_hold(src, dst)}

    out = _both(weights, scenario)
    _held(out, {"stream": refs[0], "status": "OK", "path": "resident", "traces": True})
    c = out["port"]["counters"]
    assert c["src"]["migrations_out"] == c["dst"]["migrations_in"] == 1
    assert c["src"]["migrate_out_bytes"] == c["dst"]["migrate_in_bytes"] == out["port"]["bytes"]
    assert out["port"]["bytes"] > 0
    assert c["src"]["migration_copies"] == c["dst"]["migration_copies"] == 0


def test_migrate_while_parked_reads_spilled_payload(weights, refs):
    """A session parked and then evicted to the source's host tier (a pool
    of two blocks, a second session admitted) migrates from host memory:
    its payload is the spill, the source's host tier frees, and the stream
    stays token-equal."""
    def scenario(k):
        src, dst = k.engine(kv_pool_blocks=2), k.engine()
        r1 = src.submit(P1, max_new_tokens=STEPS)
        _on_token(r1, 1, lambda: src.park(r1))
        _wait(lambda: r1 in src._parked, "the park")
        r2 = src.submit(P2, max_new_tokens=STEPS)
        got2 = list(r2.stream())
        _wait(lambda: src.stats()["evicted_blocks"] > 0, "the eviction")
        rep = k.migrate(r1, src, dst)
        got1 = list(r1.stream())
        _settle_clean(src, dst)
        s = src.stats()
        return {"streams": [got1, got2], "path": rep["path"], "bytes": rep["bytes"],
                "swap_out_bytes": s["swap_out_bytes"], "evicted": s["evicted_blocks"],
                "counters": _counters(src, dst), "traces": k.traces_hold(src, dst)}

    out = _both(weights, scenario)
    _held(out, {"streams": [refs[0], refs[1]], "path": "resident", "traces": True})
    assert out["port"]["swap_out_bytes"] > 0 and out["port"]["bytes"] > 0


def test_migrate_of_waiting_request_requeues(weights, refs):
    """A request still in the source's waiting line (one slot, held by an
    earlier request) parks unstarted, migrates as metadata only and
    re-queues through the destination's admission: no bytes, its stream
    equal to a direct submit's."""
    def scenario(k):
        src, dst = k.engine(start=False, slots=1), k.engine()
        r0 = src.submit(P1, max_new_tokens=STEPS)
        rw = src.submit(P3, max_new_tokens=STEPS)
        _on_token(r0, 1, lambda: src.park(rw))
        src.start()
        _wait(lambda: rw in src._parked, "the park of the waiting request")
        rep = k.migrate(rw, src, dst)
        got = list(rw.stream())
        got0 = list(r0.stream())
        _settle_clean(src, dst)
        return {"streams": [got0, got], "path": rep["path"], "bytes": rep["bytes"],
                "counters": _counters(src, dst)}

    out = _both(weights, scenario)
    _held(out, {"streams": [refs[0], refs[2]], "path": "requeue", "bytes": 0})
    c = out["port"]["counters"]
    assert c["src"]["migrations_out"] == c["dst"]["migrations_in"] == 1
    assert c["src"]["migrate_out_bytes"] == c["dst"]["migrate_in_bytes"] == 0


# ---------------------------------------------------------- crash recovery


def test_migrate_src_death_rebuilds_from_history(weights, refs):
    """The source dies after the metadata handshake (migrate_src_death):
    the destination holds the token history and no payload, installs the
    entry dropped, and the prefill rebuild regenerates the KV; the stream
    goes on token-equal, with no FAULTED terminal."""
    def scenario(k):
        src, dst = k.engine(fault="migrate_src_death"), k.engine()
        r = src.submit(P1, max_new_tokens=STEPS)
        _on_token(r, 2, lambda: src.park(r))
        _wait(lambda: r in src._parked, "the park")
        rep = k.migrate(r, src, dst)
        got = list(r.stream())
        _settle_clean(src, dst)
        d = dst.stats()
        return {"stream": got, "status": str(r.status), "path": rep["path"],
                "src_died": rep["src_died"], "bytes": rep["bytes"],
                "fault_recomputes": d["fault_recomputes"], "counters": _counters(src, dst)}

    out = _both(weights, scenario)
    _held(out, {"stream": refs[0], "status": "OK", "path": "recompute", "src_died": True,
                "bytes": 0, "fault_recomputes": 1})
    c = out["port"]["counters"]
    assert c["dst"]["migrate_recomputes"] == 1 and c["dst"]["migrate_failures"] == 0
    assert c["src"]["migrate_out_bytes"] == c["dst"]["migrate_in_bytes"] == 0


def test_migrate_payload_loss_recomputes_or_faults(weights, refs):
    """A payload lost in transit (migrate_payload_loss at the install): (a)
    a session the destination can rebuild recomputes token-equal; (b) one
    it cannot (no chunked prefill, a bucket shorter than the sequence)
    ends with a typed FAULTED terminal after the tokens it had, every one
    of them equal to the stay-put stream, and nothing leaks on either
    engine."""
    def rebuilt(k):
        src, dst = k.engine(), k.engine(fault="migrate_payload_loss")
        r = src.submit(P2, max_new_tokens=STEPS)
        _on_token(r, 1, lambda: src.park(r))
        _wait(lambda: r in src._parked, "the park")
        rep = k.migrate(r, src, dst)
        got = list(r.stream())
        _settle_clean(src, dst)
        return {"stream": got, "path": rep["path"], "counters": _counters(src, dst)}

    out = _both(weights, rebuilt)
    _held(out, {"stream": refs[1], "path": "recompute"})
    assert out["port"]["counters"]["dst"]["migrate_recomputes"] == 1

    def faulted(k):
        src = k.engine()
        dst = k.engine(base=dict(slots=2, prefill_buckets=(8,), max_new_tokens=STEPS,
                                 kv_page=PAGE, kv_swap=0), fault="migrate_payload_loss")
        r = src.submit(P1, max_new_tokens=STEPS)
        # parked past its fifth token, the sequence (>= 9) outgrows dst's bucket
        _on_token(r, 5, lambda: src.park(r))
        _wait(lambda: r in src._parked, "the park")
        rep = k.migrate(r, src, dst)
        got = list(r.stream())
        _settle_clean(src, dst)
        d = dst.stats()
        return {"stream": got, "status": str(r.status), "path": rep["path"],
                "faulted_requests": d["faulted_requests"], "counters": _counters(src, dst)}

    out = _both(weights, faulted)
    _held(out, {"status": "FAULTED", "path": "faulted", "faulted_requests": 1})
    got = out["port"]["stream"]
    assert 5 <= len(got) < STEPS and got == refs[0][:len(got)]
    assert out["port"]["counters"]["dst"]["migrate_failures"] == 1


# ------------------------------------------------------------------- races


def test_cancel_racing_migrate_releases_both_engines(weights):
    """A cancel at either end of the transfer ends the stream CANCELLED and
    releases every block on both engines: (a) cancelled while parked,
    before the extract (the source's sweep or the extract releases it);
    (b) cancelled between the extract and the install (the destination
    refuses the install; the payload is host memory by then)."""
    def scenario(k):
        src, dst = k.engine(), k.engine()
        r = src.submit(P1, max_new_tokens=STEPS)
        _on_token(r, 1, lambda: src.park(r))
        _wait(lambda: r in src._parked, "the park")
        r.cancel()
        rep = k.migrate(r, src, dst)
        list(r.stream())
        r2 = src.submit(P2, max_new_tokens=STEPS)
        _on_token(r2, 1, lambda: src.park(r2))
        _wait(lambda: r2 in src._parked, "the park")
        out = k.ask(src, "migrate_out", k.Ticket(r2), 30.0)
        r2.cancel()
        res = k.ask(dst, "migrate_in", k.Ticket(r2, meta=out["meta"], payload=out["payload"]),
                    30.0)
        list(r2.stream())
        _settle_clean(src, dst)
        return {"a": rep["path"] in ("cancelled", "gone", "completed"),
                "statuses": [str(r.status), str(r2.status)], "out": out["status"],
                "in": res["path"], "dst_in": dst.stats()["migrations_in"]}

    out = _both(weights, scenario)
    _held(out, {"a": True, "statuses": ["CANCELLED", "CANCELLED"], "out": "ok",
                "in": "cancelled", "dst_in": 0})


def test_migrate_validation_errors(weights):
    """Pairs that can never exchange a session fail on the caller's thread
    with nothing transferred: self-migration, kv_swap off, another page
    size, an unstarted destination."""
    def scenario(k):
        eng = k.engine()
        req = eng.submit(P1, max_new_tokens=STEPS)
        no_swap = k.engine(base=dict(slots=2, prefill_buckets=(8,), max_new_tokens=STEPS,
                                     kv_page=PAGE, prefill_chunk=8))
        other_page = k.engine(kv_page=4)
        unstarted = k.engine(start=False)
        errors = []
        for dst, match in ((eng, "own engine"), (no_swap, "kv_swap"),
                           (other_page, "kv_page mismatch"), (unstarted, "not started")):
            with pytest.raises(k.Error, match=match):
                k.migrate(req, eng, dst)
            errors.append(match)
        got = list(req.stream())
        return {"errors": errors, "stream_len": len(got), "status": str(req.status),
                "moved": eng.stats()["migrations_out"]}

    out = _both(weights, scenario)
    _held(out, {"stream_len": STEPS, "status": "OK", "moved": 0})


def test_migrate_under_a_mesh_raises(weights, refs):
    """Under ``mesh=`` sessions migrate and drain as on one device (the
    reference refuses neither): a session parked on a one-rank-mesh engine
    moves to a one-device engine, one moves back, and a parked one is
    drained across, each stream equal to the JAX engine's stay-put stream,
    every move resident with its bytes equal each way. What still raises
    under a mesh is two engines' adapters driving one process group (their
    broadcasts would interleave on its followers): the second is refused,
    naming ``own_group``. A one-rank mesh builds without a process group,
    so the moves run without spawning ranks; tests/test_torch_tp_migrate.py
    holds them at tp=2."""
    from vtpu_torch.parallel import shard_params
    from vtpu_torch.serving.adapters import TransformerSlotModel

    mesh = TpMesh(rank=0, size=1, device=torch.device("cpu"))
    tp = ServingEngine(weights[1], CFG, ServingConfig(**BASE), mesh=mesh)
    one = ServingEngine(weights[1], CFG, ServingConfig(**BASE), device="cpu")
    tp.start()
    one.start()
    try:
        streams, reports = [], []
        for src, dst, p in ((tp, one, P1), (one, tp, P2)):
            req = src.submit(p, max_new_tokens=STEPS)
            _on_token(req, 2, lambda src=src, req=req: src.park(req))
            _wait(lambda: req in src._parked, "the park")
            reports.append(migrate(req, src, dst))
            streams.append(list(req.stream()))
        req = tp.submit(P3, max_new_tokens=STEPS)
        _on_token(req, 1, lambda: tp.park(req))
        _wait(lambda: req in tp._parked, "the park")
        drained = tp.drain(one)
        streams.append(list(req.stream()))
        _settle_clean(tp, one)
        assert streams == [refs[0], refs[1], refs[2]]
        assert [r["path"] for r in reports] == ["resident", "resident"]
        assert (drained["migrated"], drained["faulted"]) == (1, 0)
        assert tp.stats()["draining"] and tp.stats()["tp"] == 1
        c = _counters(tp, one)
        assert c["src"]["migrations_out"] == c["dst"]["migrations_in"] == 2
        assert c["src"]["migrations_in"] == c["dst"]["migrations_out"] == 1
        assert (c["src"]["migrate_out_bytes"] + c["dst"]["migrate_out_bytes"]
                == c["src"]["migrate_in_bytes"] + c["dst"]["migrate_in_bytes"] > 0)
        assert c["dst"]["migrate_out_bytes"] == reports[1]["bytes"] > 0
        assert c["src"]["migration_copies"] == c["dst"]["migration_copies"] == 0
    finally:
        tp.stop()
        one.stop()
    half = TpMesh(rank=0, size=2, device=torch.device("cpu"), group=object())
    shard = shard_params(weights[1], half)
    first = TransformerSlotModel(shard, CFG, kv_page=PAGE, mesh=half)
    with pytest.raises(ValueError, match="drives this process group.*own_group"):
        TransformerSlotModel(shard, CFG, kv_page=PAGE, mesh=half)
    assert first.mesh is half


# ------------------------------------------------------------------- drain


def test_drain_evacuates_live_parked_and_waiting(weights, refs):
    """ServingEngine.drain(dst): admission closes (submit raises), every
    session moves and completes on the destination token-equal (one still
    decoding, one parked, one that never admitted), and the source reads
    EMPTY: pool and host tier free, no slots, nothing parked or queued. A
    session the caller cancelled ends CANCELLED; drain ends no stream."""
    def scenario(k):
        src, dst = k.engine(start=False), k.engine(slots=4)
        go, held = threading.Event(), threading.Event()
        ra = src.submit(P1, max_new_tokens=LONG)   # decoding when drain starts
        rp = src.submit(P2, max_new_tokens=STEPS)  # parked
        rw = src.submit(P3, max_new_tokens=STEPS)  # never admitted

        def park_two():
            src.park(rp)
            src.park(rw)

        _on_token(rp, 1, park_two)
        _on_token(ra, 5, _hold_until_asked(src, ra, go, held))
        src.start()
        _wait(lambda: rp in src._parked and rw in src._parked and held.is_set(),
              "the parks and the hold")
        # submitted while the loop is held, cancelled before it can admit
        rc = src.submit(P4, max_new_tokens=STEPS)
        rc.cancel()
        go.set()
        report = src.drain(dst)
        with pytest.raises(RuntimeError, match="draining"):
            src.submit(P1)
        streams = [list(r.stream()) for r in (ra, rp, rw)]
        list(rc.stream())
        _settle_clean(src, dst)
        s = src.stats()
        return {"streams": streams, "statuses": [str(r.status) for r in (ra, rp, rw, rc)],
                "migrated": report["migrated"], "completed": report["completed"],
                "faulted": report["faulted"], "draining": [s["draining"],
                                                           dst.stats()["draining"]],
                "admitting": s["admitting_slots"], "counters": _counters(src, dst)}

    out = _both(weights, scenario)
    _held(out, {"streams": [refs["long"], refs[1], refs[2]],
                "statuses": ["OK", "OK", "OK", "CANCELLED"], "migrated": 3, "completed": 0,
                "faulted": 0, "draining": [True, False], "admitting": 0})
    c = out["port"]["counters"]
    assert c["src"]["migrations_out"] == c["dst"]["migrations_in"] == 3
    assert c["src"]["migrate_out_bytes"] == c["dst"]["migrate_in_bytes"] > 0


def test_drain_with_waiting_prefix_backed_request(weights, refs):
    """A prefix-backed request still WAITING cannot migrate (its prefix
    lives on the source), and drain must not livelock on it: it stays
    until a slot frees, admits, and then migrates (the prefix content
    rides the payload, private on arrival). A direct migrate() of the
    waiter fails fast with nothing transferred."""
    def scenario(k):
        src, dst = k.engine(start=False, slots=1), k.engine()
        go, held = threading.Event(), threading.Event()
        pid = src.register_prefix(PREFIX)
        r0 = src.submit(P1, max_new_tokens=STEPS)  # holds the only slot
        rp = src.submit([7, 8], max_new_tokens=4, prefix=pid)
        _on_token(r0, 2, _hold_until_asked(src, r0, go, held))
        # once admitted, rp parks after its first token (a hold here would
        # stall the extract of r0 that drain is waiting for): drain then
        # moves it from the parked set before it can finish on the source
        _on_token(rp, 1, lambda: src.park(rp))
        src.start()
        _wait(lambda: held.is_set() and rp in src._waiting,
              "the hold and the prefixed request waiting")
        with pytest.raises(k.Error, match="prefix"):
            k.migrate(rp, src, dst)
        go.set()
        report = src.drain(dst)
        g0, gp = list(r0.stream()), list(rp.stream())
        src.unregister_prefix(pid)
        _settle_clean(src, dst)
        return {"streams": [g0, gp], "statuses": [str(r0.status), str(rp.status)],
                "migrated": report["migrated"], "faulted": report["faulted"],
                "counters": _counters(src, dst)}

    out = _both(weights, scenario)
    _held(out, {"streams": [refs[0], refs["prefixed"]], "statuses": ["OK", "OK"],
                "migrated": 2, "faulted": 0})
