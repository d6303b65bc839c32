"""The serving loop's own timeline in the port's trace rings (CPU, f32): the
loop-phase spans on the engine-loop track (-1), the clock events that move
them onto the wall clock ``torch.profiler`` stamps in, the admission batches
with their rows, and the device time of each admission, decode tick and
MoE stage (on the CPU the timers take the host's clock: the ops run as
they are called).

Held: on every loop (pipelined, synchronous, device loop, fused) the phase
spans cover at least 95% of the loop thread's time and never overlap; a
fleet's hook is its own phase, never admission; a clock event converts a
stamp to within 1 ms of ``time.time_ns()``; every admitted request carries
``prefill_device_ms``, and an MoE model's stages move on its own
admissions only (chunked ones too); the loop still makes one fetch a tick
and no admission sync; the loop's events never push a request's lifecycle
off the request ring; with the ring off nothing is recorded and no timer
is made; the Chrome dump's request tracks
are unchanged by the loop track, and ``clock="profiler"`` moves every stamp
by the clock offset. One torch thread."""

import json
import time

import numpy as np
import pytest
import torch

from vtpu_torch.models import ModelConfig, MoEConfig, init_moe_params, init_params
from vtpu_torch.models.moe import MOE_STAGES
from vtpu_torch.obs import RequestTrace, devtime, tickprof
from vtpu_torch.serving import ServingConfig, ServingEngine
from vtpu_torch.serving import engine as engine_mod
from vtpu_torch.serving.adapters import MoeSlotModel

DIMS = dict(vocab=128, d_model=32, n_heads=2, n_layers=2, max_seq=128, head_dim=16)
CFG = ModelConfig(**DIMS, d_ff=64, dtype=torch.float32)
MCFG = MoEConfig(**DIMS, d_ff=32, n_experts=4, top_k=2, dtype=torch.float32)
LOOPS = {
    "pipelined": {},
    "sync": dict(pipeline_decode=False),
    "device_loop": dict(decode_loop_k=4),
    "fused": dict(decode_loop_k=4, spec_tokens=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    return init_params(11, CFG, device="cpu")


@pytest.fixture(scope="module")
def moe_params():
    return init_moe_params(12, MCFG, device="cpu")


def _serving(**kw):
    return ServingConfig(**{**dict(slots=2, prefill_buckets=(16, 32), max_new_tokens=12), **kw})


def _prompts(seed, n=5):
    rs = np.random.RandomState(seed)
    # periodic prompts give the n-gram drafts of the fused loop something
    return [np.tile(rs.randint(1, CFG.vocab, 4), 6)[:int(rs.randint(6, 24))] for _ in range(n)]


def _serve(eng, prompts, budgets, gap_s=0.01):
    """Start, submit with small gaps (admissions land while others decode),
    drain every stream, let the loop go idle, stop. Returns (requests,
    streams, stats read while running, window (ns) the loop ran)."""
    eng.start()
    t0 = time.monotonic_ns()
    try:
        reqs = []
        for p, n in zip(prompts, budgets):
            reqs.append(eng.submit(p, max_new_tokens=n))
            time.sleep(gap_s)
        outs = [list(r.stream()) for r in reqs]
        time.sleep(0.1)
        st = eng.stats()
    finally:
        eng.stop()
    return reqs, outs, st, (t0, time.monotonic_ns())


def _phases(eng, window):
    a, b = window
    return sorted((p for p in eng.trace.spans()[-1]["loop_phases"] if p[1] >= a and p[2] <= b),
                  key=lambda p: p[1])


def _covered(phases) -> float:
    """Share of the loop's time from its first phase's start to its last
    phase's end that the phases cover."""
    span = phases[-1][2] - phases[0][1]
    return sum(e - s for _, s, e in phases) / span


# ------------------------------------------------------------------ loops


@pytest.mark.parametrize("loop", list(LOOPS))
def test_phase_spans_cover_the_loop(params, loop):
    """The phase spans cover >= 95% of the loop thread's time over a short
    run, never overlap, and name the loop's phases; each phase's span time
    is its histogram's total (the admission span of each tick head is one
    piece without swap-outs)."""
    eng = ServingEngine(params, CFG, _serving(**LOOPS[loop]), device="cpu")
    _, outs, st, window = _serve(eng, _prompts(1), [5, 9, 3, 12, 7])
    assert [len(o) for o in outs] == [5, 9, 3, 12, 7]
    phases = _phases(eng, window)
    assert _covered(phases) >= 0.95
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))  # no overlap
    assert {p[0] for p in phases} >= {"admission", "dispatch", "fetch", "deliver", "idle"}
    assert "hook" not in {p[0] for p in phases}
    snap = eng.tick_profile.snapshot()
    spans_ms = {}
    for name, s, e in eng.trace.spans()[-1]["loop_phases"]:
        spans_ms[name] = spans_ms.get(name, 0.0) + (e - s) / 1e6
    for name in ("admission", "dispatch", "fetch", "deliver", "idle"):
        assert spans_ms[name] == pytest.approx(snap[name]["total_ms"], rel=1e-3, abs=1e-3), name
    assert st["device_gets_per_tick"] == (1.0 if loop in ("pipelined", "sync") else 0.25)


def test_an_idle_engine_keeps_a_served_requests_lifecycle(params):
    """The loop's own events go to a ring of their own: an engine idling
    long enough to wrap its loop ring many times over still holds an
    earlier request's whole lifecycle, and its request ring took no event
    while it idled."""
    eng = ServingEngine(params, CFG, _serving(trace_events=32), device="cpu")
    eng.start()
    try:
        req = eng.submit(_prompts(9, 1)[0], max_new_tokens=4)
        assert len(list(req.stream())) == 4
        time.sleep(0.1)
        served = eng.stats()["trace_events_recorded"]
        events = eng.trace.snapshot()
        time.sleep(1.5)  # ~30 idle passes
        st = eng.stats()
    finally:
        eng.stop()
    assert st["trace_events_recorded"] == served and eng.trace.snapshot() == events
    loop = eng.trace.loop_snapshot()
    assert len(loop) == 32 and loop[-1][0] >= 2 * 32  # the loop ring wrapped twice
    span = eng.trace.spans()[req.rid]
    assert None not in (span["submit_ns"], span["queue_depart_ns"], span["admit_ns"],
                        span["first_token_ns"], span["retire_ns"])
    assert span["tokens"] == 4 and span["terminal"] is not None


def test_hook_is_its_own_phase(params):
    """A fleet's ledger hook that takes 60 ms a tick head: its time is the
    hook phase's, as a histogram and as spans, and no admission sample or
    span holds it."""
    eng = ServingEngine(params, CFG, _serving(), device="cpu")
    eng._ledger_hook = lambda e: time.sleep(0.06)
    _, _, _, window = _serve(eng, _prompts(3, 3), [4, 4, 4])
    snap = eng.tick_profile.snapshot()
    assert snap["hook"]["count"] > 0
    assert snap["hook"]["total_ms"] >= 60.0 * snap["hook"]["count"]
    assert snap["admission"]["max_ms"] < 60.0
    phases = _phases(eng, window)
    hooks = [p for p in phases if p[0] == "hook"]
    assert hooks and all(e - s >= 60_000_000 for _, s, e in hooks)
    assert all(e - s < 60_000_000 for name, s, e in phases if name == "admission")
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    assert _covered(phases) >= 0.95


def test_clock_events_convert_to_the_wall_clock(params):
    """The ring's first clock event is recorded at start, and a stamp
    moved by the nearest one reads within 1 ms of time.time_ns()."""
    eng = ServingEngine(params, CFG, _serving(), device="cpu")
    _serve(eng, _prompts(4, 2), [3, 3])
    clock = eng.trace.spans()[-1]["clock"]
    assert clock
    mono = time.monotonic_ns()
    wall = time.time_ns()
    ts, off = min(clock, key=lambda c: abs(c[0] - mono))
    assert abs(mono + off - wall) < 1_000_000


def test_clock_events_once_a_second_at_most():
    tr = RequestTrace(capacity=64)
    for _ in range(3):
        tr.record_clock()
    marks = tr.spans()[-1]["clock"]
    assert len(marks) == 3 and all(abs(t + off - time.time_ns()) < 1e9 for t, off in marks)
    assert RequestTrace(capacity=0).spans() == {}


# -------------------------------------------------------------- admission


@pytest.mark.parametrize("case", ["batched", "serial", "chunked", "prefix"])
def test_every_admitted_request_has_its_device_time(params, case):
    """Each admitted request's span carries prefill_device_ms, the sum of
    admission_device_ms over its batches; the batched path's admit_batch
    events name its rows in order; the loop keeps one fetch a tick and the
    serial path's syncs stay those of a ring-off engine."""
    kw = {"batched": {}, "serial": dict(async_admission=False),
          "chunked": dict(prefill_chunk=8, prefill_buckets=(16,)),
          "prefix": dict(prefill_chunk=8)}[case]
    prompts = _prompts(5, 4)
    if case == "chunked":
        prompts = [np.arange(1, 21 + 3 * i) % CFG.vocab for i in range(4)]
    runs = {}
    for ring in (16384, 0):
        eng = ServingEngine(params, CFG, _serving(**kw, trace_events=ring), device="cpu")
        if case == "prefix":
            pid = eng.register_prefix(np.arange(1, 9))
            eng.start()
            try:
                reqs = [eng.submit(p[:6], max_new_tokens=4, prefix=pid) for p in prompts]
                reqs.append(eng.submit([], max_new_tokens=3, prefix=pid))
                outs = [list(r.stream()) for r in reqs]
                st = eng.stats()
            finally:
                eng.stop()
        else:
            reqs, outs, st, _ = _serve(eng, prompts, [4, 6, 3, 5], gap_s=0)
        runs[ring] = (eng, reqs, outs, st)
    eng, reqs, outs, st = runs[16384]
    _, _, base_outs, base_st = runs[0]
    assert outs == base_outs
    spans = eng.trace.spans()
    got = [spans[r.rid].get("prefill_device_ms") for r in reqs]
    assert all(v is not None and v >= 0 for v in got), got
    assert st["admission_device_ms"] > 0 and base_st["admission_device_ms"] == 0.0
    assert st["admission_syncs"] == base_st["admission_syncs"]
    assert st["device_gets_per_tick"] == base_st["device_gets_per_tick"] == 1.0
    batches = spans[-1]["admissions"]
    if case == "batched":
        assert sorted(rid for _, _, rids in batches for rid in rids) == sorted(
            r.rid for r in reqs)
        assert {bucket for _, bucket, _ in batches} <= {16, 32}
        for ts, _, rids in batches:
            assert [spans[rid]["admit_ns"] >= ts for rid in rids] == [True] * len(rids)
        # a batch's rows share its one dispatch's time
        for _, _, rids in batches:
            assert len({spans[rid]["prefill_device_ms"] for rid in rids}) == 1
    else:
        assert batches == []


@pytest.mark.parametrize("case", ["batched", "chunked"])
def test_moe_stages_move_on_admission_not_on_decode(moe_params, case):
    """An MoE admission laps the four stages of every layer's block, a
    chunked one in each chunk; the eager decode ticks that follow move
    decode_device_ms and leave the stages where they were; the stages sum
    to at most the admissions' device time."""
    model = MoeSlotModel(moe_params, MCFG, kv_page=8, device="cpu")
    kw = dict(prefill_chunk=8, prefill_buckets=(16,)) if case == "chunked" else {}
    eng = ServingEngine(model=model, serving=_serving(max_new_tokens=40, **kw))
    eng.start()
    try:
        # past the one bucket, the chunked engine admits in chunks of 8
        first = eng.submit(np.arange(1, 12 if case == "batched" else 22), max_new_tokens=40)
        stream = first.stream()
        next(stream)
        st1 = eng.stats()
        rest = list(stream)
        st2 = eng.stats()
    finally:
        eng.stop()
    assert len(rest) == 39
    stages1, stages2 = st1["moe_stage_device_ms"], st2["moe_stage_device_ms"]
    assert set(stages1) == set(MOE_STAGES) and all(v > 0 for v in stages1.values())
    assert stages2 == stages1
    assert st2["decode_device_ms"] > st1["decode_device_ms"]
    assert sum(stages1.values()) <= st1["admission_device_ms"] + 1e-3
    assert st1["prefill_chunks"] == (3 if case == "chunked" else 0)


def test_two_engines_on_one_moe_model_time_their_own_stages(moe_params):
    """Each admission hands the model a stage timer of its own: two
    engines built on one MoE adapter each count their own admissions'
    stages, never the other's."""
    model = MoeSlotModel(moe_params, MCFG, kv_page=8, device="cpu")
    engs = [ServingEngine(model=model, serving=_serving(max_new_tokens=3)) for _ in range(2)]
    zero = dict.fromkeys(MOE_STAGES, 0.0)
    for i, eng in enumerate(engs):
        _, outs, _, _ = _serve(eng, [np.arange(1, 12)], [3])
        assert [len(o) for o in outs] == [3]
        assert all(v > 0 for v in eng.stats()["moe_stage_device_ms"].values())
        if i == 0:
            assert engs[1].stats()["moe_stage_device_ms"] == zero
    assert engs[0].stats()["moe_stage_device_ms"] != engs[1].stats()["moe_stage_device_ms"]


def test_stage_timer_laps_its_stages_and_sums_them():
    """lap() opens the first stage where it is called, each call closes
    one and opens the next; ms() sums each stage over every lap function
    the timer gave (one a layer)."""
    timer = devtime.StageTimer(MOE_STAGES, cuda=False)
    assert timer.ms() == dict.fromkeys(MOE_STAGES, 0.0)
    for _ in range(3):
        lap = timer.lap()
        for stage in MOE_STAGES:
            time.sleep(0.002 if stage == "route" else 0)
            lap(stage)
    ms = timer.ms()
    assert set(ms) == set(MOE_STAGES) and ms["route"] >= 6.0
    assert all(v >= 0 for v in ms.values())


def test_ring_off_records_nothing_and_makes_no_timer(params, moe_params, monkeypatch):
    """trace_events=0: no loop-track event, no DeviceTimer or StageTimer
    made, the device-ms counters stay 0 (the MoE's stages too), and the
    histograms still fill."""
    made = []

    class Counting(devtime.DeviceTimer):
        def __init__(self, cuda):
            made.append(cuda)
            super().__init__(cuda)

    class CountingStages(devtime.StageTimer):
        def __init__(self, stages, cuda):
            made.append(stages)
            super().__init__(stages, cuda)

    monkeypatch.setattr(engine_mod, "DeviceTimer", Counting)
    monkeypatch.setattr(engine_mod, "StageTimer", CountingStages)
    model = MoeSlotModel(moe_params, MCFG, kv_page=8, device="cpu")
    for eng in (ServingEngine(params, CFG, _serving(trace_events=0), device="cpu"),
                ServingEngine(model=model, serving=_serving(trace_events=0))):
        _, outs, st, _ = _serve(eng, _prompts(6, 3), [4, 5, 6])
        assert [len(o) for o in outs] == [4, 5, 6]
        assert eng.trace.snapshot() == eng.trace.loop_snapshot() == []
        assert st["trace_events_recorded"] == 0
        assert st["admission_device_ms"] == st["decode_device_ms"] == 0.0
        assert st["tick_phase_ms"]["fetch"]["count"] > 0
    assert made == []
    assert st["moe_stage_device_ms"] == dict.fromkeys(MOE_STAGES, 0.0)
    # and with the ring on, the same engines make their timers
    ServingEngine(params, CFG, _serving(), device="cpu")._device_timer().stop().ms()
    assert made == [False]


# ------------------------------------------------------------------ dumps


def _scripted(clock_off=0):
    """A ring with a request's lifecycle, loop phases around it and two
    clock events, stamps set explicitly."""
    tr = RequestTrace(capacity=256)
    script = [("submit", 3, -1, 0, 1_000_000), ("queue_depart", 3, -1, 0, 1_500_000),
              ("admit", 3, 0, 5, 2_000_000), ("first_token", 3, 0, 0, 3_000_000),
              ("token", 3, 0, 0, 4_000_000), ("retire", 3, 0, 0, 5_000_000)]
    loop = [("clock", -1, -1, clock_off, 900_000), ("clock", -1, -1, clock_off, 4_900_000)]
    loop += [("loop_phase", -1, tickprof.PHASES.index(p), 400_000, 1_200_000 + 600_000 * i)
             for i, p in enumerate(("admission", "dispatch", "fetch", "deliver", "idle"))]
    return tr, script, loop


def test_chrome_trace_request_tracks_unchanged_by_the_loop_track():
    """The same request events with and without the loop's events between
    them in time: against one origin the dumps differ only by the
    engine-loop track (tid -1), which holds one X slice a phase at its own
    times."""
    with_loop, script, loop = _scripted()
    plain = RequestTrace(capacity=256)
    for tr in (with_loop, plain):
        for ev in script:
            tr.record_at(ev[4], ev[0], ev[1], ev[2], ev[3])
    for ev in loop:
        with_loop.record_loop(ev[0], ev[2], ev[3], ts_ns=ev[4])
    t0 = 500_000
    got = with_loop.chrome_trace(t0_ns=t0)["traceEvents"]
    want = plain.chrome_trace(t0_ns=t0)["traceEvents"]
    assert json.dumps([e for e in got if e.get("tid") != -1]) == json.dumps(want)
    track = [e for e in got if e.get("tid") == -1]
    assert track[0]["args"]["name"] == "engine loop"
    slices = [(e["name"], e["ts"], e["dur"]) for e in track if e["ph"] == "X"]
    assert slices == [(p, (1_200_000 + 600_000 * i - 400_000 - t0) / 1e3, 400.0)
                      for i, p in enumerate(("admission", "dispatch", "fetch", "deliver",
                                             "idle"))]
    # the default origin is the earliest stamp, a phase's start included
    assert min(e["ts"] for e in with_loop.chrome_trace()["traceEvents"] if "ts" in e) == 0.0
    assert json.dumps(plain.chrome_trace()) == json.dumps(plain.chrome_trace(clock="monotonic"))


def test_chrome_trace_in_the_profilers_clock():
    """clock="profiler" moves every stamp by the clock offset onto the wall
    clock, origin 0 of that clock unless t0_ns says otherwise; a ring
    without a clock event refuses."""
    off = 1_700_000_000_000_000_000
    tr, script, loop = _scripted(off)
    for ev in script:
        tr.record_at(ev[4], ev[0], ev[1], ev[2], ev[3])
    for ev in loop:
        tr.record_loop(ev[0], ev[2], ev[3], ts_ns=ev[4])
    mono = tr.chrome_trace(t0_ns=0)["traceEvents"]
    wall = tr.chrome_trace(clock="profiler")["traceEvents"]
    assert len(mono) == len(wall)
    for m, w in zip(mono, wall):
        if "ts" in m:
            assert w["ts"] == pytest.approx(m["ts"] + off / 1e3)
            assert w.get("dur") == m.get("dur")
    shifted = tr.chrome_trace(clock="profiler", t0_ns=off)["traceEvents"]
    assert [e.get("ts") for e in shifted] == [e.get("ts") for e in mono]
    bare = RequestTrace(capacity=16)
    bare.record_at(5, "submit", 1)
    with pytest.raises(ValueError, match="no clock event"):
        bare.chrome_trace(clock="profiler")
    with pytest.raises(ValueError, match="clock must be"):
        bare.chrome_trace(clock="tai")


def test_spans_derive_the_loop_track():
    """loop_phases as (phase, start, end), clock as (ts, offset),
    admissions as (ts, bucket, rids of the admits that follow), and a
    request's prefill_device_ms from the events on the loop track."""
    tr = RequestTrace(capacity=64)
    tr.record_at(100, "submit", 7)
    tr.record_at(110, "submit", 8)
    tr.record_loop("admit_batch", 2, 32, ts_ns=200)
    tr.record_at(201, "admit", 7, 0, 20)
    tr.record_at(202, "admit", 8, 1, 30)
    tr.record_loop("loop_phase", tickprof.PHASES.index("hook"), 40, ts_ns=250)
    tr.record_loop("clock", -1, 99, ts_ns=260)
    tr.record_loop("prefill_device", 7, 2_500_000, ts_ns=300)
    tr.record_loop("prefill_device", 8, 2_500_000, ts_ns=300)
    tr.record_at(400, "admit", 9, 2, 3)  # a serial admission: no batch
    spans = tr.spans()
    loop = spans[-1]
    assert tr.snapshot() == [e for e in tr.snapshot() if e[3] >= 0]  # requests only
    assert loop["loop_phases"] == [("hook", 210, 250)]
    assert loop["clock"] == [(260, 99)]
    assert loop["admissions"] == [(200, 32, [7, 8])]
    assert spans[7]["prefill_device_ms"] == spans[8]["prefill_device_ms"] == 2.5
    assert "prefill_device_ms" not in spans[9]


# ------------------------------------------------------------------- card


@pytest.mark.cuda
def test_captured_decode_leaves_moe_stages_alone():
    """On a card the decode tick replays a CUDA graph captured at
    construction; the stage timer laps nothing inside it (no capture
    records a lap, and decode passes no timer), so the stages move on
    admissions only while decode_device_ms moves every tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    cfg = MoEConfig(**{**DIMS, "head_dim": 128, "d_model": 256}, d_ff=64, n_experts=4, top_k=2,
                    dtype=torch.bfloat16)
    params = init_moe_params(12, cfg, device="cuda")
    model = MoeSlotModel(params, cfg, kv_page=16, device="cuda")
    eng = ServingEngine(model=model, serving=_serving(kv_page=16, max_new_tokens=40))
    assert eng.stats()["graphs_captured"] > 0
    eng.start()
    try:
        stream = eng.submit(np.arange(1, 12), max_new_tokens=40).stream()
        next(stream)
        st1 = eng.stats()
        assert len(list(stream)) == 39
        st2 = eng.stats()
    finally:
        eng.stop()
    assert all(v > 0 for v in st1["moe_stage_device_ms"].values())
    assert st2["moe_stage_device_ms"] == st1["moe_stage_device_ms"]
    # the first token may ride its own fetch, before any tick is delivered
    assert st2["decode_device_ms"] > st1["decode_device_ms"]
    assert st2["device_gets_per_tick"] == 1.0
