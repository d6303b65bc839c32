"""The port's fleet trace (``vtpu_torch.obs.fleettrace``) and the
exporter's fleet half (``vtpu_torch.obs.export``: ``FLEET_*``,
``fleet_families``, ``ServingCollector.register_fleet``) against vtpu's
(CPU), in the reference's configuration (tests/test_obs.py's three fleet
cases).

``FleetTrace``'s units run the same call sequence through both packages'
classes (each on its own ``RequestTrace``) and compare every answer but
the clock's: the bounded control ring and its drop accounting (counted by
a plain locked integer in the port, with no ``itertools.count``
pickling), journey stitching with per-hop tokens, blackouts and the
conservation verdict, a truncated stitch, the disabled plane, the flight
recorder's bundle and its JSON-lines dump, and the merged Chrome dump. The
exporter cases hold every ``EngineFleet.stats()`` key to a
``vtpu_serving_fleet_*`` family, the port fleet's keys to the JAX fleet's,
and one scrape of a registered port fleet to the JAX collector's scrape of
the same scenario: family names, labels, and every value that does not
depend on timing. One torch thread."""

import io
import json
import time
import warnings

import pytest
import torch

from tests.torch_fleet_kit import PAGE, both, make_weights, prompt, wait
from vtpu.obs import export as jexport
from vtpu.obs.fleettrace import FleetTrace as JFleetTrace, validate_bundle as j_validate_bundle
from vtpu.obs.trace import RequestTrace as JRequestTrace
from vtpu.serving.shed import EngineSignals as JEngineSignals
from vtpu_torch.obs import ServingCollector, export
from vtpu_torch.obs.fleettrace import FleetTrace, validate_bundle
from vtpu_torch.obs.trace import RequestTrace
from vtpu_torch.serving.shed import EngineSignals

PACKAGES = {"jax": (JFleetTrace, JRequestTrace, JEngineSignals, j_validate_bundle),
            "port": (FleetTrace, RequestTrace, EngineSignals, validate_bundle)}
BASE = dict(slots=2, prefill_buckets=(8,), max_new_tokens=4, kv_page=PAGE, kv_swap=2)
FC = dict(probe_interval_ms=5.0, miss_ms=2000.0, suspect_misses=2, dead_misses=4)
# fleet keys whose value depends on the host's timing (monitor rounds, the
# ledger as of the last tick head), not on what was served
TIMING_KEYS = {"probes", "ledger_sessions"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def _units(scenario) -> dict:
    return {side: scenario(*classes) for side, classes in PACKAGES.items()}


def _untimed(obj):
    """``obj`` with every clock reading (``*_ns``, ``ms``, ``ttft_ms``,
    ``itl_ms``, ``ts``, ``dur``) replaced by whether it was set."""
    if isinstance(obj, dict):
        return {k: (v is not None if (k.endswith("_ns") or k in ("ms", "ttft_ms", "ts", "dur"))
                    else [x >= 0 for x in v] if k == "itl_ms" else _untimed(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _journey_trace(FT, RT):
    """The reference test's synthetic two-engine journey: 2 tokens on 'a',
    then a failover hop to 'b' and 3 tokens there."""
    ft = FT(capacity=64)
    ta, tb = RT(capacity=64), RT(capacity=64)
    ft.attach("a", ta)
    ft.attach("b", tb)
    ta.record("submit", 0)
    ta.record("first_token", 0)
    ta.record("token", 0)
    jid = ft.begin_journey("a", 0)
    time.sleep(0.002)
    ft.hop(jid, "b", 5, "failover")
    for _ in range(3):
        tb.record("token", 5)
    tb.record("retire", 5)
    ft.end_journey(jid, delivered=5, terminal="OK")
    ft.end_journey(jid, delivered=99, terminal="FAULTED")  # idempotent
    return ft, jid


# ------------------------------------------------------------------- units


def test_fleettrace_ring_bounded_with_drop_accounting():
    """A ring of four holds the last four of ten control events, in order,
    with ten recorded and six dropped; seq numbers run from 0."""
    def scenario(FT, *_):
        ft = FT(capacity=4)
        for i in range(10):
            ft.control("probe_miss", engine="a", val=i)
        evs = ft.events()
        return {"recorded": ft.events_recorded, "dropped": ft.events_dropped,
                "vals": [e["val"] for e in evs], "seqs": [e["seq"] for e in evs],
                "keys": [sorted(e) for e in evs],
                "stats": {k: v for k, v in ft.stats().items() if "events" in k}}

    out = _units(scenario)
    assert out["port"] == out["jax"]
    assert (out["port"]["recorded"], out["port"]["dropped"]) == (10, 6)
    assert out["port"]["vals"] == out["port"]["seqs"] == list(range(6, 10))


def test_fleettrace_counts_without_itertools_pickling():
    """The port counts control events with a locked integer: reading
    ``events_recorded`` (and stats()) raises no DeprecationWarning, and a
    route event's score, bonus and signals ride along as the reference's
    do."""
    ft = FleetTrace(capacity=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        ft.control("route", engine="b", jid=3, score=1.5, bonus=0.25,
                   signals=EngineSignals(queue_depth=2))
        assert ft.events_recorded == 1 and ft.events_dropped == 0
        assert ft.stats()["fleet_trace_events_recorded"] == 1
    (e,) = ft.events()
    ref = JFleetTrace(capacity=8)
    ref.control("route", engine="b", jid=3, score=1.5, bonus=0.25,
                signals=JEngineSignals(queue_depth=2))
    (r,) = ref.events()
    assert _untimed(e) == _untimed(r)
    assert e["signals"]["queue_depth"] == 2 and e["bonus"] == 0.25


def test_fleettrace_journey_stitch():
    """A two-hop journey stitches the per-engine spans into one: per-hop
    tokens [2, 3] summing to the delivered 5, a failover blackout window,
    conserved and not truncated; the SLO histograms note once at its end
    (a second end is a no-op) and stats() reads the blackout back."""
    def scenario(FT, RT, *_):
        ft, jid = _journey_trace(FT, RT)
        j = ft.journeys()[jid]
        (b,) = j["blackouts"]
        s = ft.stats()
        return {"journey": _untimed(j), "hop_tokens": [h["tokens"] for h in j["hops"]],
                "window": b["ms"] > 0,
                "p50": s["failover_blackout_p50_ms"] == pytest.approx(b["ms"], rel=1e-3),
                "hists": (ft.failover_blackout_hist.count, ft.migration_blackout_hist.count,
                          ft.hops_snapshot()),
                "stats": {k: v for k, v in s.items() if not k.endswith("_ms")}}

    out = _units(scenario)
    assert out["port"] == out["jax"]
    p = out["port"]
    assert p["hop_tokens"] == [2, 3] and p["window"] and p["p50"]
    assert p["journey"]["conserved"] is True and p["journey"]["truncated"] is False
    assert p["hists"] == (1, 0, {2: 1})
    assert (p["stats"]["journeys_ended"], p["stats"]["journeys_conserved"]) == (1, 1)


def test_fleettrace_truncated_and_disabled():
    """A hop whose rid the ring never saw voids conservation honestly
    (truncated), a single-hop journey counts conserved by construction, and
    a disabled plane records nothing."""
    def scenario(FT, RT, *_):
        ft, _ = _journey_trace(FT, RT)
        j2 = ft.begin_journey("a", 777)
        ft.end_journey(j2, delivered=4, terminal="OK")
        j3 = ft.begin_journey("a", 888)
        ft.hop(j3, "b", 999, "rescue")
        ft.end_journey(j3, delivered=4, terminal="OK")
        j = ft.journeys()[j3]
        off = FT(capacity=0)
        off.control("route", engine="a")
        return {"truncated": (j["truncated"], j["conserved"]), "jids": [j2, j3],
                "stats": {k: v for k, v in ft.stats().items() if not k.endswith("_ms")},
                "off": (off.begin_journey("a", 0), off.events_recorded, off.journeys(),
                        off.events_dropped, off.flight_record("a", None, {}))}

    out = _units(scenario)
    assert out["port"] == out["jax"]
    assert out["port"]["truncated"] == (True, False)
    assert out["port"]["off"] == (-1, 0, {}, 0, None)
    assert out["port"]["stats"]["journeys_truncated"] == 1


class _Corpse:
    """What the flight recorder reads of a dead engine: its ring, stats()
    and signals()."""

    def __init__(self, RT, Signals):
        self.trace = RT(capacity=16)
        self.trace.record("submit", 4)
        self.trace.record("first_token", 4, 0)
        self._signals = Signals(queue_depth=1, active_slots=1)

    def stats(self):
        return {"generated_tokens": 2, "kv_pool_free": 7, "tick_phase_ms": {"fetch": (1, 2.5)}}

    def signals(self):
        return self._signals


class _Req:
    rid, jid, delivered = 4, 0, 2


def test_fleettrace_flight_record_and_dumps():
    """A fenced corpse's bundle is JSON that round-trips (validate_bundle),
    carries its stats, signals, a token-free ledger census and its ring,
    and dumps as JSON lines (header, events, Chrome fragment); the merged
    Chrome dump has the control track, each engine's pid and a blackout
    slice. validate_bundle refuses what the reference's refuses."""
    def scenario(FT, RT, Signals, validate):
        ft, jid = _journey_trace(FT, RT)
        ft.control("dead", engine="a", val=4)
        meta = {"unstarted": False, "tokens": [1, 2, 3], "pending": 5, "seq_len": 3,
                "n_pages": 1, "budget": 17, "priority": 0, "hist_exact": True}
        bundle = ft.flight_record("a", _Corpse(RT, Signals), {_Req(): meta})
        sio = io.StringIO()
        n = ft.dump_bundle("a", sio)
        lines = [json.loads(ln) for ln in sio.getvalue().splitlines()]
        doc = ft.chrome_trace()
        bad = [None, {"ledger": [1]}, {"events": [1]}, {"ledger": [1], "events": [object()]}]
        return {"bundle": _untimed({k: v for k, v in bundle.items() if k != "chrome"}),
                "valid": [validate(bundle)] + [validate(b) for b in bad],
                "dump": (n, [ln["kind"] for ln in lines]),
                "missing": ft.dump_bundle("zz", io.StringIO()),
                "bundles": sorted(ft.bundles()),
                "chrome": sorted({(e["ph"], e["pid"], e["name"]) for e in doc["traceEvents"]
                                  if e["pid"] == 1}),
                "pids": sorted({e["pid"] for e in doc["traceEvents"]}),
                "stats": ft.stats()["postmortem_bundles"]}

    out = _units(scenario)
    assert out["port"] == out["jax"]
    p = out["port"]
    assert p["valid"] == [True, False, False, False, False]
    assert p["dump"][0] == len(p["dump"][1]) and p["dump"][1][0] == "postmortem"
    assert p["dump"][1][-1] == "chrome" and p["missing"] == 0
    assert p["bundle"]["ledger"][0]["rid"] == 4 and "tokens" not in p["bundle"]["ledger"][0]
    assert p["pids"] == [1, 2, 3] and ("i", 1, "dead") in p["chrome"]
    assert any(ph == "X" and "blackout" in name for ph, _, name in p["chrome"])


# ---------------------------------------------------------------- exporter


@pytest.mark.parametrize("table", ["FLEET_COUNTERS", "FLEET_GAUGES", "FLEET_SPECIAL",
                                   "FLEET_ALLOWLIST", "_HEALTH_VALUE"])
def test_fleet_tables_carried_over_unchanged(table):
    """The exporter's fleet tables are the reference's, entry for entry, in
    its order."""
    ref, port = getattr(jexport, table), getattr(export, table)
    assert port == ref
    if isinstance(ref, dict):
        assert list(port) == list(ref)


def test_exporter_covers_every_fleet_stats_key(weights):
    """Every top-level key EngineFleet.stats() returns maps to a
    vtpu_serving_fleet_* family or is special, and the port fleet's keys
    are the JAX fleet's (the fabric's keys included, zero for an all-local
    fleet); every member's stats() key has its vtpu_serving_* family."""
    mapped = (set(export.FLEET_COUNTERS) | set(export.FLEET_GAUGES) | export.FLEET_SPECIAL
              | export.FLEET_ALLOWLIST)
    engine_mapped = (set(export.COUNTERS) | set(export.GAUGES) | set(export.HIST_COUNTERS)
                     | export.SPECIAL | export.ALLOWLIST)

    def scenario(k):
        fleet, _ = k.fleet(("a", "b"))
        s = fleet.stats()
        return {"keys": sorted(s), "fabric": {k_: v for k_, v in s.items()
                                             if k_.startswith(("fabric", "remote"))},
                "engine_keys": sorted(s["engines"]["a"])}

    out = both(weights, scenario, BASE, FC)
    assert out["port"]["keys"] == out["jax"]["keys"]
    assert out["port"]["fabric"] == out["jax"]["fabric"]
    missing = sorted(k for k in out["port"]["keys"] if k not in mapped)
    assert not missing, f"EngineFleet.stats() keys with no vtpu_serving_fleet_* family: {missing}"
    assert not [k for k in out["port"]["engine_keys"] if k not in engine_mapped]


def test_exporter_covers_a_remote_member(weights):
    """A fleet with a fabric member (an engine behind an in-proc host over a
    loopback link) reports the JAX fleet's keys, the fabric's counters
    counting the one remote member and its live link; the proxy's stats()
    are its host engine's keys, every one mapped, plus the two link keys the
    reference's proxy adds (``fabric_link_ok``, ``fabric_host``)."""
    mapped = (set(export.FLEET_COUNTERS) | set(export.FLEET_GAUGES) | export.FLEET_SPECIAL
              | export.FLEET_ALLOWLIST)
    engine_mapped = (set(export.COUNTERS) | set(export.GAUGES) | set(export.HIST_COUNTERS)
                     | export.SPECIAL | export.ALLOWLIST)

    def scenario(k):
        t = k.remote()
        fleet = k.Fleet({"r0": t.rem, "a": k.engine()}, k.FleetConfig(**k.fc))
        k.fleets.append(fleet)
        fleet.start()
        wait(lambda: t.rem._beat_ns != 0, "the remote's warm-up beat")
        got = list(fleet.submit(prompt(1, 5), max_new_tokens=4).stream())
        s = fleet.stats()
        fleet.stop()
        remote, local = set(s["engines"]["r0"]), set(s["engines"]["a"])
        return {"keys": sorted(s), "stream_len": len(got),
                "fabric": (s["remote_engines"], s["fabric_links_down"],
                           s["fabric_msgs_sent"] > 0, s["fabric_msgs_recv"] > 0,
                           s["fabric_rtt_ms"] > 0),
                "extra": sorted(remote - local), "missing": sorted(local - remote),
                "link": (s["engines"]["r0"]["fabric_link_ok"],
                         s["engines"]["r0"]["fabric_host"]),
                "unmapped": sorted(k_ for k_ in local if k_ not in engine_mapped)}

    out = both(weights, scenario, BASE, FC)
    assert out["port"] == {**out["jax"], "unmapped": out["port"]["unmapped"]}
    p = out["port"]
    assert not [k for k in p["keys"] if k not in mapped] and not p["unmapped"]
    assert p["fabric"] == (1, 0, True, True, True) and p["stream_len"] == 4
    assert p["extra"] == ["fabric_host", "fabric_link_ok"] and not p["missing"]
    assert p["link"] == (True, "h0")


def test_fleet_families_shape(weights):
    """A registered fleet exports twice: its members join the ordinary
    vtpu_serving_* families under "fleet/engine" labels, and its counters
    and health states export as vtpu_serving_fleet_* families. One scrape
    of a port fleet and one of a JAX fleet after the same four-token
    request: the same fleet family names, labels and (timing aside)
    values, a hop-count sample of one single-hop journey, the stitched-SLO
    histograms with bucket samples, no family name twice."""
    jcol, pcol = jexport.ServingCollector, ServingCollector

    def scenario(k):
        fleet, _ = k.fleet(("a", "b"))
        fleet.start()
        req = fleet.submit(prompt(1, 5), max_new_tokens=4)
        got = list(req.stream())
        wait(lambda: fleet.stats()["journeys_ended"] >= 1, "the journey's end")
        col = (jcol if k.side == "jax" else pcol)()
        col.register_fleet("f0", fleet)
        fams = list(col.collect())
        col.unregister_fleet("f0")
        after = [f.name for f in col.collect()]
        fleet.stop()
        names = [f.name for f in fams]
        by = {f.name: f for f in fams}
        fleet_fams = {n: sorted((tuple(sorted(s.labels.items())), s.name,
                                 None if any(t in n for t in TIMING_KEYS) or "_bucket" in s.name
                                 or s.name.endswith("_sum") else s.value)
                                for s in f.samples)
                      for n, f in by.items() if n.startswith("vtpu_serving_fleet_")}
        tokens = by["vtpu_serving_tokens_generated"].samples
        return {"stream_len": len(got), "unique": len(names) == len(set(names)),
                "fleet": fleet_fams,
                "engines": sorted(s.labels["engine"] for s in tokens),
                "tokens": sum(s.value for s in tokens),
                "ring": sorted(s.value for s in by["vtpu_serving_trace_ring_capacity"].samples),
                "slo_buckets": [any(s.name.endswith("_bucket") for s in by[
                    "vtpu_serving_" + f].samples) for f in (
                    "fleet_failover_blackout_seconds", "fleet_migration_blackout_seconds",
                    "fleet_rebuild_seconds")],
                "unregistered": not any(n.startswith("vtpu_serving_fleet_") for n in after)}

    out = both(weights, scenario, BASE, FC)
    assert out["port"] == out["jax"]
    p = out["port"]
    assert p["unique"] and p["engines"] == ["f0/a", "f0/b"] and p["tokens"] == 4.0
    assert p["ring"] == [16384.0, 16384.0] and p["slo_buckets"] == [True] * 3
    assert p["unregistered"]
    assert p["fleet"]["vtpu_serving_fleet_journey_hops"] == [
        ((("fleet", "f0"), ("hops", "1")), "vtpu_serving_fleet_journey_hops_total", 1.0)]
    assert p["fleet"]["vtpu_serving_fleet_engine_health"] == [
        ((("engine", "a"), ("fleet", "f0")), "vtpu_serving_fleet_engine_health", 1.0),
        ((("engine", "b"), ("fleet", "f0")), "vtpu_serving_fleet_engine_health", 1.0)]
    assert p["fleet"]["vtpu_serving_fleet_failovers"][0][2] == 0.0


def test_collector_renders_a_fleet():
    """A port ServingCollector with a registered fleet renders one
    exposition (each family once, the fleet's counters with a _total
    suffix); unregistering drops the fleet's samples."""
    from prometheus_client import CollectorRegistry, generate_latest

    class _Fleet:
        engines = {}

        def stats(self, include_engines=True):
            return {"failovers": 2, "engine_states": {"x": "SUSPECT"}, "fleet_engines": 1,
                    "engines": {}}

    col = ServingCollector(fleets={"f1": _Fleet()})
    reg = CollectorRegistry()
    reg.register(col)
    text = generate_latest(reg).decode()
    assert 'vtpu_serving_fleet_failovers_total{fleet="f1"} 2.0' in text
    assert 'vtpu_serving_fleet_engine_health{engine="x",fleet="f1"} 0.5' in text
    assert text.count("# HELP vtpu_serving_fleet_engines ") == 1
    col.unregister_fleet("f1")
    assert 'fleet="f1"' not in generate_latest(reg).decode()
