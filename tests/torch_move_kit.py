"""The migration round runner shared by the tensor-parallel migration
tests (tests/test_torch_tp_migrate.py, test_torch_tp_ops.py) and
chip_smoke.py's phase h9. ``move_round`` runs a round's steps on engines of
either package (the ServingEngine API: vtpu's in the test process, the
port's on a spawned rank 0); ``port_round`` is the ``Moves.runner`` a
world loads by import path (``torch_move_kit:port_round``), so this module
imports numpy and the port, never jax."""

import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np

# a loop held inside a delivery lets go after this long at most (a hang
# guard: the round then fails)
HOLD_S = 120.0
# a migration round's fleet: a heartbeat this stale counts as a miss, far
# above a tick, a move or a held delivery, so no live member is fenced
FLEET_MISS_MS = 60000.0


class PinRoute:
    """A route policy (duck-typed, so any fleet with the EngineFleet API
    loads it) that sends every submit to engine ``name``: a round's
    placement is fixed, whatever the load. A draining engine scores None,
    the others 0, so a fleet drain goes to a survivor."""

    def __init__(self, name: str):
        self.name = name

    def score(self, name, signals):
        if signals.draining:
            return None
        return 1.0 if name == self.name else 0.0


def _serving_engine(engines: dict):
    """The engine of ``engines`` whose loop thread this is (a delivery
    hook runs there)."""
    me = threading.current_thread()
    for eng in engines.values():
        if eng._thread is me:
            return eng
    raise RuntimeError("a delivery hook ran off every engine's loop thread")


def _park_asked(eng, req) -> bool:
    return any(kind == "park" and item is req for kind, item in list(eng._lifecycle_q.queue))


def _clean(eng) -> bool:
    s = eng.stats()
    return (s["kv_pool_free"] == s["kv_pool_blocks"] and s["parked_sessions"] == 0
            and s["active_slots"] == 0 and s["queued"] == 0
            and (not s["swap_host_blocks"] or s["swap_host_free"] == s["swap_host_blocks"]))


def move_round(engines: dict, prompts: Sequence, new_tokens: int, steps: Sequence,
               migrate: Callable, fleet=None) -> dict:
    """Run a migration round's ``steps`` on ``engines`` ({name: engine},
    any with the ServingEngine API; ``migrate`` the function of their
    package; ``fleet`` one over some of them, or None), in order on this
    thread. Every action on a stream runs inside a chosen token's delivery
    on its engine's loop thread, or waits for a state the loop reaches; a
    wall clock only guards against a hang. Steps:

      ("submit", i, name)   prompt i, ``new_tokens`` a stream, on engine
                            ``name``, or through the fleet with "fleet"
      ("park_at", i, n, *j) park session i (and each session j) inside
                            session i's n-th token's delivery, on its engine
      ("hold_at", i, n)     hold the loop inside session i's n-th token's
                            delivery until a park of it is queued there: a
                            move then parks it live, at the next tick head
      ("start",)            start the fleet and every engine outside it
      ("gate", name)        hold engine ``name``'s loop at its next tick
                            head, before it admits, until ("ungate", name)
      ("held", i)           wait until session i's hold has begun
      ("parked", i)         wait until session i's park_at park settled
      ("evicted", i)        wait until session i's parked pages left the
                            pool for its engine's host tier
      ("move", i, name)     migrate session i to engine ``name``
      ("resume", i)         resume session i on its engine
      ("end", i)            wait for session i's stream to end
      ("drain", src, dst)   drain engine src into dst (None: fleet.drain)

    Then every stream is read to its end and every engine waits until it
    reads empty (pool and host tier free, nothing parked, live or queued).
    Returns the ``streams``, ``statuses``, ``moves`` (session, from, to,
    path, bytes, ms each), ``drains`` (migrated, completed, faulted, ms
    each), every engine's ``stats`` and with a fleet its ``fleet`` stats."""
    reqs: dict = {}
    got: dict = {}
    where: dict = {}  # session -> the engine it was submitted on or moved to
    expired: list = []
    holding: set = set()
    gates: dict = {}
    parking: dict = {}  # session -> the engine its park_at hook asked
    moves, drains = [], []

    def wait(cond, what):
        t0 = time.monotonic()
        while not cond():
            if time.monotonic() - t0 > HOLD_S:
                raise RuntimeError(f"{what} never happened")
            time.sleep(0.001)

    def on_token(req, n, action):
        put, seen = req.out.put, [0]

        def hook(item):
            put(item)
            if isinstance(item, (int, np.integer)):
                seen[0] += 1
                if seen[0] == n:
                    action()

        req.out.put = hook

    def park(i):
        parking[i] = eng = _serving_engine(engines)
        eng.park(reqs[i])

    def hold(i):
        eng, req = _serving_engine(engines), reqs[i]
        holding.add(i)
        t0 = time.monotonic()
        while not _park_asked(eng, req):
            if time.monotonic() - t0 > HOLD_S:
                expired.append(req)
                return
            time.sleep(0.0005)

    def gate(name):
        eng, inner = engines[name], engines[name]._ledger_hook
        at, go = threading.Event(), threading.Event()

        def head(e):
            if inner is not None:
                inner(e)
            if not go.is_set():
                at.set()
                if not go.wait(HOLD_S):
                    expired.append(name)

        eng._ledger_hook = head
        gates[name] = (eng, inner, go)
        wait(at.is_set, f"engine {name}'s tick head")

    def ungate(name):
        eng, inner, go = gates.pop(name)
        eng._ledger_hook = inner
        go.set()

    def read(i):
        """Session i's stream to its terminal (anything but a token)."""
        if i in got:
            return
        toks = []
        while True:
            try:
                item = reqs[i].out.get(timeout=HOLD_S)
            except queue.Empty:
                raise RuntimeError(f"session {i}'s stream stalled for {HOLD_S:.0f} s") from None
            if not isinstance(item, (int, np.integer)):
                break
            toks.append(int(item))
        got[i] = toks

    def holder(i):
        name = where[i]
        return fleet._assigned[reqs[i]] if name == "fleet" else name

    for step in steps:
        kind, args = step[0], step[1:]
        if kind == "submit":
            i, name = args
            target = fleet if name == "fleet" else engines[name]
            reqs[i] = target.submit(list(prompts[i]), max_new_tokens=new_tokens)
            where[i] = name
        elif kind == "park_at":
            i, n, *also = args
            on_token(reqs[i], n, lambda who=(i, *also): [park(j) for j in who])
        elif kind == "hold_at":
            i, n = args
            on_token(reqs[i], n, lambda i=i: hold(i))
        elif kind == "start":
            if fleet is not None:
                fleet.start()
            for eng in engines.values():
                if eng._thread is None:
                    eng.start()
        elif kind == "gate":
            gate(args[0])
        elif kind == "ungate":
            ungate(args[0])
        elif kind == "held":
            wait(lambda: args[0] in holding, f"session {args[0]}'s hold")
        elif kind == "parked":
            i = args[0]
            wait(lambda: i in parking and reqs[i] in parking[i]._parked,
                 f"session {i}'s park")
            del parking[i]
        elif kind == "evicted":
            r = reqs[args[0]]

            def spilled():
                for eng in engines.values():
                    e = eng._parked.get(r)
                    if e is not None and e["host"] is not None:
                        return True
                return False

            wait(spilled, f"session {args[0]}'s eviction")
        elif kind == "move":
            i, name = args
            src = holder(i)
            rep = migrate(reqs[i], engines[src], engines[name])
            moves.append((i, src, name, rep["path"], rep["bytes"], rep["ms"]))
            where[i] = name
        elif kind == "resume":
            engines[holder(args[0])].resume(reqs[args[0]])
        elif kind == "end":
            read(args[0])
        elif kind == "drain":
            src, dst = args
            rep = (fleet.drain(src) if dst is None
                   else engines[src].drain(engines[dst]))
            drains.append((rep["migrated"], rep["completed"], rep["faulted"], rep["ms"]))
        else:
            raise ValueError(f"unknown round step {step!r}")
    for i in reqs:
        read(i)
    if expired:
        raise RuntimeError(f"a held loop was never asked to park sessions {expired}")
    for name, eng in engines.items():
        wait(lambda: _clean(eng), f"engine {name} reading empty")
    order = sorted(reqs)
    return {"streams": [got[i] for i in order],
            "statuses": [str(reqs[i].status) for i in order],
            "moves": moves, "drains": drains,
            "stats": {name: eng.stats() for name, eng in engines.items()},
            "fleet": None if fleet is None else fleet.stats(include_engines=False)}


def port_round(engines: dict, run) -> dict:
    """``Moves.runner`` of a world: ``move_round`` on rank 0's built
    engines with the port's ``migrate``, the Run's prompts and token budget
    and its ``Script.moves`` steps; with ``moves.fleet`` an EngineFleet
    over those engines pinned to the first (``PinRoute``), stopped after
    the round."""
    from vtpu_torch.serving import EngineFleet, FleetConfig, migrate

    moves = run.script.moves
    fleet = None
    if moves.fleet:
        fleet = EngineFleet({n: engines[n] for n in moves.fleet},
                            FleetConfig(route_policy=PinRoute(moves.fleet[0]),
                                        miss_ms=FLEET_MISS_MS))
    try:
        return move_round(engines, run.prompts, run.new_tokens, moves.steps, migrate, fleet)
    finally:
        if fleet is not None:
            fleet.stop()
