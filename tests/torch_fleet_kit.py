"""Shared kit of the port's fleet tests (tests/test_torch_fleet.py,
test_torch_prefixdir.py, test_torch_fleettrace.py): one scenario runs on a
fleet of JAX engines (``vtpu.serving``) and on a fleet of the port's engines
(``vtpu_torch.serving``) on the same weights, behind the same names.

How the scenarios avoid racing the loop threads:

- ``TickGate`` holds an engine's loop at its next tick head, inside the
  fleet's ledger hook (before the heartbeat and the pending drain), while
  the client submits and installs its delivery hooks; on release that tick
  head admits everything submitted, so what admits together and what waits
  is fixed, whatever the host's speed.
- ``on_token`` runs an action on the loop thread inside the delivery of a
  chosen token (arming ``engine_death``, asking a park, cancelling), and
  ``hold_until`` holds the loop there until the client's command is queued.
- ``ProbeGate`` holds the fleet's monitor before its probe rounds while
  the client places a request, so a probe_loss plan cannot walk an engine
  to SUSPECT before the placement it is meant to follow.
- A wall clock only guards against a hang (``wait``); no verdict rests on
  one. Death detection takes ``miss_ms`` of a stopped heartbeat, wide
  enough that a live loop is never fenced.
- A fabric member (``Kit.remote``) is an engine behind an in-proc
  ``EngineHost`` over a loopback link, proxied by a ``RemoteEngine``; the
  host-side mirror of a client's request is caught as the host engine's
  submit makes it (``catch_submits``), so a hook on its deliveries acts on
  the host's loop thread, ahead of anything the wire carries.
"""

import threading
import time
import types

import jax
import numpy as np
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.serving import (
    EngineFleet as JEngineFleet,
    FaultPlan as JFaultPlan,
    FaultSpec as JFaultSpec,
    FleetConfig as JFleetConfig,
    ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from vtpu.serving.fabric import (
    EngineHost as JEngineHost,
    connect_host as j_connect_host,
    loopback_pair as j_loopback_pair,
)
from vtpu.serving.fleet import load_route_policy as j_load_route_policy
from vtpu.serving.shed import EngineSignals as JEngineSignals
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.serving import (
    EngineFleet,
    EngineHost,
    FaultPlan,
    FaultSpec,
    FleetConfig,
    RoutePolicy,
    ServingConfig,
    ServingEngine,
    connect_host,
    load_route_policy,
    loopback_pair,
)
from vtpu_torch.serving.shed import EngineSignals

# the reference tests' model (tests/test_fleet.py:48-61)
DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=32, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jax.numpy.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
PAGE = 8
# hang guards (seconds): never a verdict
HANG_S = 60.0


def make_weights():
    """(JAX params, port params) from init_params(key 0)."""
    jp = j_init_params(jax.random.key(0), JCFG)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_numpy(tree, CFG, device="cpu")


def prompt(seed: int, n: int) -> list:
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


class PinPolicy(RoutePolicy):
    """Route everything to one named engine (deterministic placement
    through the front door); survivors rank by name when it is gone. Duck
    typed, so both packages' fleets load it."""

    def __init__(self, name="a"):
        self.name = name

    def score(self, name, signals):
        if signals.draining:
            return None
        return 1.0 if name == self.name else 0.0


class Kit:
    """One side of a scenario: the JAX package's engines and fleet, or the
    port's, behind the same names. Every fleet and engine it built stops
    when the scenario ends."""

    def __init__(self, side: str, weights, base: dict, fc: dict, cfgs=(JCFG, CFG)):
        self.side, self.base, self.fc = side, base, fc
        self.fleets, self.engines, self.links = [], [], []
        if side == "jax":
            self._make = lambda sc: JServingEngine(weights[0], cfgs[0], sc)
            self.Config, self.Plan, self.Spec = JServingConfig, JFaultPlan, JFaultSpec
            self.Fleet, self.FleetConfig = JEngineFleet, JFleetConfig
            self.Signals, self.load_route_policy = JEngineSignals, j_load_route_policy
            self._fabric = (JEngineHost, j_loopback_pair, j_connect_host)
        else:
            self._make = lambda sc: ServingEngine(weights[1], cfgs[1], sc, device="cpu")
            self.Config, self.Plan, self.Spec = ServingConfig, FaultPlan, FaultSpec
            self.Fleet, self.FleetConfig = EngineFleet, FleetConfig
            self.Signals, self.load_route_policy = EngineSignals, load_route_policy
            self._fabric = (EngineHost, loopback_pair, connect_host)

    def engine(self, **kw):
        eng = self._make(self.Config(**{**self.base, **kw}))
        self.engines.append(eng)
        return eng

    def fleet(self, names=("a", "b", "c"), faults_for=None, fc=None, engine_kw=None,
              **fleet_kw):
        """A fleet of fresh engines; ``faults_for`` maps an engine name to
        its FaultPlan (the engine-side seams), ``engine_kw`` to extra
        ServingConfig fields."""
        faults_for, engine_kw = faults_for or {}, engine_kw or {}
        engines = {n: self.engine(faults=faults_for.get(n), **engine_kw.get(n, {}))
                   for n in names}
        fleet = self.Fleet(engines, self.FleetConfig(**{**self.fc, **(fc or {})}, **fleet_kw))
        self.fleets.append(fleet)
        return fleet, engines

    def remote(self, name="r0", host="h0", link_faults=None, **engine_kw):
        """A started engine (``engine_kw``: ServingConfig fields) behind an
        in-proc EngineHost over a loopback link (``link_faults``: the link's
        FaultPlan), proxied as a RemoteEngine.
        Returns a namespace: the host-side engine ``eng``, the ``host``,
        the ``link`` (partition toggle), the host's end of it
        ``host_chan``, the ``client`` and the proxy ``rem``."""
        Host, pair, connect = self._fabric
        eng = self.engine(**engine_kw)
        eng.start()
        srv = Host({name: eng})
        a, b, link = pair(faults=link_faults, delay_s=0.0)
        threading.Thread(target=srv.serve_channel, args=(b,), daemon=True).start()
        client, engines = connect(a, host=host)
        t = types.SimpleNamespace(eng=eng, host=srv, link=link, host_chan=b, client=client,
                                  rem=engines[name])
        self.links.append(t)
        return t

    def close(self):
        for fleet in self.fleets:
            fleet.stop()
        for t in self.links:
            t.client.close()
            t.host.stop()
        for eng in self.engines:
            eng.stop()


def both(weights, scenario, base: dict, fc: dict, cfgs=(JCFG, CFG)) -> dict:
    """Run ``scenario(kit)`` on the JAX package and on the port (``cfgs``:
    each side's model config); returns {"jax": ..., "port": ...}.
    Everything stops, whatever happens."""
    out = {}
    for side in ("jax", "port"):
        kit = Kit(side, weights, base, fc, cfgs)
        try:
            out[side] = scenario(kit)
        finally:
            kit.close()
        assert not EXPIRED, f"{side}: a held loop was never released ({EXPIRED})"
    return out


def held(out: dict, expect: dict) -> None:
    """Both packages' runs equal, and equal to ``expect`` where given."""
    for key in out["jax"]:
        assert out["port"][key] == out["jax"][key], key
    assert set(out["port"]) == set(out["jax"])
    for key, want in expect.items():
        assert out["port"][key] == want, key


# holds whose hang guard expired: the scenario lost its determinism
EXPIRED: list = []


def wait(cond, what: str, timeout: float = HANG_S) -> None:
    """A hang guard, never a verdict: poll ``cond`` until it holds."""
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, f"{what} did not happen within {timeout} s"
        time.sleep(0.002)


def on_token(req, n: int, action) -> None:
    """Run ``action()`` on the loop thread right after ``req``'s n-th token
    is put on its stream (inside that delivery)."""
    on_token_when(req, lambda seen: seen == n, action)


def on_token_when(req, cond, action) -> None:
    """Run ``action()`` once, inside the first delivery of a token of
    ``req`` at which ``cond(tokens delivered so far)`` holds."""
    put, seen, fired = req.out.put, [0], [False]

    def hook(item):
        put(item)
        if isinstance(item, (int, np.integer)):
            seen[0] += 1
            if not fired[0] and cond(seen[0]):
                fired[0] = True
                action()

    req.out.put = hook


def count_tokens(req) -> list:
    """A one-element list counting the tokens put on ``req``'s stream from
    now on (install it before the first arrives)."""
    seen, put = [0], req.out.put

    def hook(item):
        put(item)
        if isinstance(item, (int, np.integer)):
            seen[0] += 1

    req.out.put = hook
    return seen


def catch_submits(eng) -> list:
    """The requests ``eng.submit`` makes, in order: on a fabric host, the
    server mirrors of clients' requests. Submit while the engine's loop is
    held (``TickGate``) and hook the caught request before releasing it."""
    caught, submit = [], eng.submit

    def catching(*args, **kw):
        req = submit(*args, **kw)
        caught.append(req)
        return req

    eng.submit = catching
    return caught


def hold_until(until, held_ev: threading.Event = None):
    """A delivery action that holds the loop thread (setting ``held_ev``)
    until ``until()`` holds."""
    def hold():
        if held_ev is not None:
            held_ev.set()
        t0 = time.perf_counter()
        while not until():
            if time.perf_counter() - t0 > HANG_S:
                EXPIRED.append(until)
                return
            time.sleep(0.001)

    return hold


def watch_parks(eng) -> set:
    """The requests whose park has been asked of ``eng`` (by a client, a
    drain, a migration or the rebalancer), each added once its command is
    queued: a delivery held until then lets the park settle at the next
    tick head."""
    asked, park = set(), eng.park

    def watched(req):
        park(req)
        asked.add(req)

    eng.park = watched
    return asked


class TickGate:
    """Hold ``eng``'s loop at its next tick head while the client acts:
    ``with TickGate(eng): ...``. It wraps the ledger hook the fleet
    installed at start(), so install it after ``fleet.start()``; the hold
    sits before the heartbeat, so keep it short against ``miss_ms``."""

    def __init__(self, eng):
        self.closed, self.at, self.go = threading.Event(), threading.Event(), threading.Event()
        inner = eng._ledger_hook

        def hook(e):
            if inner is not None:
                inner(e)
            if self.closed.is_set():
                self.at.set()
                if not self.go.wait(HANG_S):
                    EXPIRED.append(self)

        eng._ledger_hook = hook

    def __enter__(self):
        self.go.clear()
        self.closed.set()
        assert self.at.wait(HANG_S), "the loop did not reach a tick head"
        return self

    def __exit__(self, *exc):
        self.closed.clear()
        self.at.clear()
        self.go.set()
        return False


class ProbeGate:
    """Hold ``fleet``'s monitor before its next probe round while the
    client acts: ``with ProbeGate(fleet): ...``. Install it before
    ``fleet.start()`` so the first round waits too: a placement then sees
    every engine as the client left it, however slowly the client runs
    against ``probe_interval_ms``."""

    def __init__(self, fleet):
        self.go = threading.Event()
        probe = fleet._probe_round

        def gated():
            if not self.go.wait(HANG_S):
                EXPIRED.append(self)
            probe()

        fleet._probe_round = gated

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.go.set()
        return False


def clean(eng) -> bool:
    """Pool and host tier free but for registered prefixes' blocks (a
    corpse's registry is not reaped: it pins them as a stopped engine's
    does), nothing parked, live or queued."""
    s = eng.stats()
    pinned = sum(len(e["blocks"]) for e in list(eng._prefixes.values()))
    return (s["kv_pool_free"] + pinned == s["kv_pool_blocks"] and s["parked_sessions"] == 0
            and s["active_slots"] == 0 and s["queued"] == 0
            and (not s["swap_host_blocks"] or s["swap_host_free"] == s["swap_host_blocks"]))


def settle_clean(*engines) -> bool:
    """Wait until every engine reads clean (a stream ends inside the
    delivery that retires it, before its blocks go back; a corpse is reaped
    after the rebuilds); a leak fails the hang guard."""
    for eng in engines:
        wait(lambda: clean(eng), "the pools reading free")
    return True


def hops(fleet, req) -> list:
    """(kind, engine) of each hop of ``req``'s journey (read after stop)."""
    j = fleet.trace.journeys()[req.jid]
    return [(h["kind"], h["engine"]) for h in j["hops"]]


def journey(fleet, req) -> dict:
    """The timing-free shape of ``req``'s stitched journey: hops, the
    conservation verdict, blackout kinds and whether each has a window."""
    j = fleet.trace.journeys()[req.jid]
    assert sum(h["tokens"] for h in j["hops"]) == j["tokens"]
    return {"hops": [(h["kind"], h["engine"], h["host"]) for h in j["hops"]],
            "ended": j["ended"], "terminal": j["terminal"], "delivered": j["delivered"],
            "tokens": j["tokens"], "conserved": j["conserved"], "truncated": j["truncated"],
            "blackouts": [(b["kind"], b["from"], b["to"], b["ms"] is not None
                           and b["ms"] >= 0) for b in j["blackouts"]]}


FLEET_KEYS = ("failovers", "failover_sessions", "failover_faulted", "reroutes",
              "rebalance_migrations", "suspects", "prefix_routes", "prefix_replications",
              "prefix_installs", "prefix_directory_hits", "prefix_directory_misses",
              "healthy_engines", "suspect_engines", "dead_engines", "draining_engines",
              "fleet_engines", "journeys_ended", "journeys_conserved", "journeys_truncated",
              "journeys_open", "postmortem_bundles", "remote_engines")


def fleet_counters(fleet) -> dict:
    """The fleet counters and gauges that do not depend on timing, and the
    health states."""
    s = fleet.stats(include_engines=False)
    out = {k: s[k] for k in FLEET_KEYS}
    out["engine_states"] = dict(s["engine_states"])
    return out
