"""vtpu_torch.obs against vtpu.obs (CPU): the request trace and the tick
profiler on the same seeded event scripts and timings, and the engine's
trace and stats() against the reference engine's.

The unit cases are tests/test_obs.py's that touch nothing the port has not
reached (the ring's wraparound, the disabled ring's latency substrate, the
Chrome dump's pid/name override, the first/last token stamps, the
histogram buckets, the tick phases and their per-tick attribution), each
run through both packages under one fake clock and held equal; the engine
cases serve the same requests through both engines and hold the per-request
event sequences, the stats() keys of the ported features and the five tick
phases equal."""

import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.obs import tickprof as j_tickprof, trace as j_trace
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.obs import tickprof, trace
from vtpu_torch.serving import ServingConfig, ServingEngine, Status

DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq=32, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
PACKAGES = {"port": (trace, tickprof), "reference": (j_trace, j_tickprof)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def clock(monkeypatch):
    """A fake time.monotonic_ns both packages read: ``clock.at(ns)`` sets it."""

    class Clock:
        now = 1_000_000_000

        def at(self, ns):
            self.now = ns

    c = Clock()
    monkeypatch.setattr(time, "monotonic_ns", lambda: c.now)
    return c


def _run_script(clock, script, capacity):
    """The same (event, rid, slot, val, ts_ns) script recorded into a fresh
    RequestTrace of each package. Returns {package: trace}."""
    out = {}
    for name, (tr_mod, _) in PACKAGES.items():
        tr = tr_mod.RequestTrace(capacity=capacity)
        for event, rid, slot, val, ts in script:
            clock.at(ts)
            tr.record(event, rid, slot, val)
        out[name] = tr
    return out


def _seeded_script(seed: int, n_req: int = 6):
    """Interleaved lifecycles of ``n_req`` requests with seeded timings, in
    the event kinds the port's engine records (submit, queue_depart, admit,
    first_token, token, retire with a terminal code)."""
    rng = np.random.RandomState(seed)
    per_rid = []
    for rid in range(n_req):
        slot = int(rng.randint(0, 4))
        evs = [("submit", rid, -1, int(rng.randint(1, 30))), ("queue_depart", rid, -1, 0),
               ("admit", rid, slot, int(rng.randint(1, 30))), ("first_token", rid, slot, 0)]
        evs += [("token", rid, slot, 0)] * int(rng.randint(0, 8))
        evs.append(("retire", rid, slot, int(rng.choice([0, 0, 1]))))
        per_rid.append(evs)
    script, ts = [], 5_000_000
    while any(per_rid):
        live = [i for i, evs in enumerate(per_rid) if evs]
        i = live[int(rng.randint(0, len(live)))]
        ts += int(rng.randint(1, 3_000_000))
        script.append(per_rid[i].pop(0) + (ts,))
    return script


# ------------------------------------------------------------------- unit


@pytest.mark.parametrize("seed,capacity", [(0, 4096), (1, 4096), (2, 16)])
def test_seeded_script_snapshots_spans_and_dumps_match(clock, seed, capacity):
    """One seeded script through both traces: the snapshot, the derived
    spans, the JSONL dump and the Chrome dump are equal (a ring of 16 wraps
    and truncates the spans the same way)."""
    got = _run_script(clock, _seeded_script(seed), capacity)
    port, ref = got["port"], got["reference"]
    assert port.snapshot() == ref.snapshot()
    assert port.spans() == ref.spans()
    assert (port.events_recorded, port.events_dropped) == (ref.events_recorded,
                                                          ref.events_dropped)
    dumps = {}
    for name, tr in got.items():
        buf = io.StringIO()
        n = tr.to_jsonl(buf)
        dumps[name] = (n, buf.getvalue(), json.dumps(tr.chrome_trace()))
    assert dumps["port"] == dumps["reference"]
    if capacity == 16:
        assert port.events_dropped > 0


def test_trace_ring_bounded_wraparound(clock):
    script = [("token", i, -1, 0, 1_000 * (i + 1)) for i in range(20)]
    got = _run_script(clock, script, capacity=8)
    for tr in got.values():
        evs = tr.snapshot()
        assert len(evs) == 8
        assert [e[3] for e in evs] == list(range(12, 20))
        assert tr.events_recorded == 20 and tr.events_dropped == 12
    assert got["port"].snapshot() == got["reference"].snapshot()


def test_trace_disabled_ring_keeps_latency_substrate():
    views = {}
    for name, (tr_mod, _) in PACKAGES.items():
        tr = tr_mod.RequestTrace(capacity=0)
        tr.record("token", rid=1)
        assert tr.snapshot() == [] and tr.events_recorded == 0 and tr.events_dropped == 0
        tr.note_itl(0.002)
        tr.note_ttft(0.5)
        tr.note_queue_wait(0.1)
        tr.note_prefill_exec(0.3)
        views[name] = (tr.itl_gaps(), tr.ttft_samples(), tr.queue_wait_samples(),
                       tr.prefill_exec_samples(),
                       [h.snapshot() for h in (tr.itl_hist, tr.ttft_hist, tr.queue_wait_hist,
                                               tr.prefill_exec_hist)],
                       tr.itl_hist.counts)
    assert views["port"] == views["reference"]
    assert views["port"][:4] == ([0.002], [0.5], [0.1], [0.3])


def test_chrome_trace_pid_name_override(clock):
    script = [(ev, 3, -1, 0, 2_000 * (i + 1))
              for i, ev in enumerate(("submit", "admit", "first_token", "token", "retire"))]
    got = _run_script(clock, script, capacity=64)
    docs = {}
    for name, tr in got.items():
        default = tr.chrome_trace()
        assert json.dumps(default) == json.dumps(tr.chrome_trace(pid=1, name="vtpu-serving"))
        t0 = min(e[1] for e in tr.snapshot())
        shifted = tr.chrome_trace(pid=7, name="engine:b", t0_ns=t0 - 1_000_000)
        assert all(e["pid"] == 7 for e in shifted["traceEvents"])
        assert shifted["traceEvents"][0]["args"]["name"] == "engine:b"
        docs[name] = (json.dumps(default), json.dumps(shifted))
    assert docs["port"] == docs["reference"]


def test_span_first_last_token_stamps(clock):
    """migrate_in/resume stay in the port's vocabulary (the engine never
    records them): the spans derive the same stamps from them."""
    script = [("migrate_in", 4, -1, 0, 1_000), ("resume", 4, -1, 0, 2_000)]
    script += [("token", 4, -1, 0, 3_000 + 1_000_000 * i) for i in range(3)]
    script.append(("retire", 4, -1, 0, 9_000_000))
    got = _run_script(clock, script, capacity=64)
    s = got["port"].spans()[4]
    assert s["first_token_ns"] is None and s["tokens"] == 3
    assert s["last_tok_ns"] > s["first_tok_ns"]
    assert got["port"].spans() == got["reference"].spans()


def test_bounded_histogram_prom_buckets():
    out = {}
    for name, (_, tp_mod) in PACKAGES.items():
        h = tp_mod.BoundedHistogram(edges_ms=(1.0, 10.0, 100.0))
        for ms in (0.5, 5.0, 50.0, 500.0, 0.2):
            h.note_ms(ms)
        buckets, total_s = h.prom_buckets()
        assert [b[1] for b in buckets] == [2.0, 3.0, 4.0, 5.0] and buckets[-1][0] == "+Inf"
        assert total_s == pytest.approx(0.5557)
        out[name] = (buckets, total_s, h.snapshot(), h.counts)
    assert out["port"] == out["reference"]
    assert tickprof.PHASE_BUCKETS_MS == j_tickprof.PHASE_BUCKETS_MS
    assert tickprof.LATENCY_BUCKETS_MS == j_tickprof.LATENCY_BUCKETS_MS


@pytest.mark.parametrize("notes", [
    [("dispatch", 0.001, 1), ("dispatch", 0.003, 1), ("fetch", 0.0001, 1)],
    [("deliver", 0.004, 4), ("deliver", 0.004, 4), ("fetch", 0.002, 1)],
], ids=["phases", "per_tick_attribution"])
def test_tick_profiler_matches_reference(notes):
    snaps = {}
    for name, (_, tp_mod) in PACKAGES.items():
        prof = tp_mod.TickProfiler()
        for phase, sec, ticks in notes:
            prof.note(phase, sec, ticks=ticks)
        snaps[name] = prof.snapshot()
    assert snaps["port"] == snaps["reference"]
    assert tuple(snaps["port"]) == tickprof.PHASES == j_tickprof.PHASES
    if notes[0][0] == "deliver":
        assert snaps["port"]["deliver"]["mean_ms_per_tick"] == pytest.approx(1.0)
    else:
        assert snaps["port"]["dispatch"]["mean_ms"] == pytest.approx(2.0)


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_numpy(tree, CFG, device="cpu")


PROMPTS = [np.arange(1, 6), np.arange(3, 10), np.arange(2, 5)]

# stats() keys of what the port has reached: the trace views, the tick
# phases, the loop and the transfer contract
PORTED_KEYS = (
    "host_ms_per_tick", "admission_stall_ms", "itl_p50_ms", "itl_p99_ms", "ttft_p50_ms",
    "ttft_p95_ms", "ttft_p99_ms", "queue_wait_p50_ms", "queue_wait_p99_ms",
    "prefill_exec_p50_ms", "prefill_exec_p99_ms", "trace_enabled", "trace_events_recorded",
    "trace_events_dropped", "trace_ring_capacity", "trace_ring_utilization", "tick_phase_ms",
    "pipelined", "pipelined_ticks", "device_sampling", "batched_admission", "decode_ticks",
    "device_gets", "tick_fetches", "admission_fetches", "admission_syncs", "bytes_fetched",
    "device_gets_per_tick", "bytes_fetched_per_tick", "generated_tokens", "admissions",
)


def _serve(engine):
    reqs = [engine.submit(p, max_new_tokens=5) for p in PROMPTS]  # one admission sweep
    engine.start()
    try:
        outs = [list(r.stream()) for r in reqs]
        stats = engine.stats()
    finally:
        engine.stop()
    return reqs, outs, stats


@pytest.fixture(scope="module")
def served(weights):
    jp, tp = weights
    serving = dict(slots=2, prefill_buckets=(8,), max_new_tokens=5)
    port = ServingEngine(tp, CFG, ServingConfig(**serving), device="cpu")
    ref = JServingEngine(jp, JCFG, JServingConfig(**serving))
    return {"port": (port, *_serve(port)), "reference": (ref, *_serve(ref))}


def _kinds_by_request(engine, reqs):
    events = engine.trace.events()
    return [[e["event"] for e in events if e["rid"] == r.rid] for r in reqs]


def test_engine_trace_matches_reference_engine(served):
    """Three requests over two slots (one waits for a slot): each request's
    lifecycle events, in order, are the reference engine's, and its span
    carries the tokens it was delivered."""
    port, preqs, pouts, _ = served["port"]
    ref, rreqs, routs, _ = served["reference"]
    assert pouts == routs
    assert [r.status for r in preqs] == [Status.OK] * 3
    kinds = _kinds_by_request(port, preqs)
    assert kinds == _kinds_by_request(ref, rreqs)
    for seq in kinds:
        assert seq == ["submit", "queue_depart", "admit", "first_token"] + ["token"] * 4 + [
            "retire"]
    spans = port.trace.spans()
    for r in preqs:
        s = spans[r.rid]
        assert s["tokens"] == r.delivered == 5 and s["terminal"] == "OK"
        assert s["ttft_ms"] >= s["queue_wait_ms"] >= 0 and len(s["itl_ms"]) == 4


def test_engine_stats_keys_match_reference_engine(served):
    _, _, _, pst = served["port"]
    _, _, _, rst = served["reference"]
    missing = [k for k in PORTED_KEYS if k not in pst or k not in rst]
    assert not missing, missing
    assert set(pst["tick_phase_ms"]) == set(rst["tick_phase_ms"]) == set(tickprof.PHASES)
    for phase, snap in pst["tick_phase_ms"].items():
        assert set(snap) == set(rst["tick_phase_ms"][phase])
    for p in ("admission", "dispatch", "fetch", "deliver"):
        assert pst["tick_phase_ms"][p]["count"] > 0, p
    assert pst["tick_phase_ms"]["swap_drain"]["count"] == 0
    for k in ("decode_ticks", "tick_fetches", "generated_tokens", "admissions",
              "pipelined", "device_sampling", "batched_admission", "admission_syncs",
              "trace_enabled", "trace_events_recorded", "trace_ring_capacity"):
        assert pst[k] == rst[k], k
    assert pst["pipelined_ticks"] > 0 and pst["device_gets_per_tick"] == 1.0
    assert all(pst[k] is not None for k in ("host_ms_per_tick", "admission_stall_ms",
                                            "itl_p50_ms", "ttft_p99_ms", "queue_wait_p99_ms"))


def test_trace_off_engine_still_reports_percentiles(weights):
    """trace_events=0: no lifecycle events, but the ITL/TTFT/queue-wait
    percentiles keep flowing into stats()."""
    _, tp = weights
    eng = ServingEngine(tp, CFG, ServingConfig(slots=2, prefill_buckets=(8,), max_new_tokens=5,
                                               trace_events=0), device="cpu")
    _, outs, stats = _serve(eng)
    assert all(len(o) == 5 for o in outs)
    assert stats["trace_enabled"] is False and stats["trace_events_recorded"] == 0
    assert eng.trace.snapshot() == []
    assert stats["trace_ring_capacity"] == 0 and stats["trace_ring_utilization"] is None
    for k in ("itl_p50_ms", "ttft_p50_ms", "queue_wait_p50_ms"):
        assert stats[k] is not None, k
    assert stats["device_gets_per_tick"] == 1.0
    assert eng.tick_profile.snapshot() == stats["tick_phase_ms"]
