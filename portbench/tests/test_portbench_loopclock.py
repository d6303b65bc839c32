"""The loop's timeline on the device's clock (``loopclock.py``) and the
readers of the engine's new spans and counters, on a synthetic run: one
traced stretch of 100 ms, ten ticks, whose device stamps sit on the wall
clock (or leave it), the loop's phases on the monotonic clock with clock
events between the two."""

import types

import pytest

from portbench import catalog, loopclock
from portbench.harness import QUIET_MARGIN_NS, RunData
from portbench.loopclock import BETWEEN

MS = 1_000_000
OFF = 1_760_000_000_000_000_000  # wall clock - monotonic clock
H0 = 5_000 * MS  # the stretch on the monotonic clock
COPY = "Memcpy DtoH (Device -> Pinned)"
# ten ticks of 10 ms, each (phase, start ms, end ms) into its tick; the
# last half millisecond of a tick lies in no phase
TICK = [("admission", 0, 2), ("dispatch", 2, 3), ("fetch", 3, 8), ("deliver", 8, 9.5)]
LOOP = [(n, 10 * k + s, 10 * k + e) for k in range(10) for n, s, e in TICK]
# the card's operations (name, start ms, end ms): each tick's kernels, then
# the copy its fetch waits for, ending as the fetch does
OPS = [op for k in range(10) for op in (("kernel", 10 * k + 1.5, 10 * k + 7.9),
                                        (COPY, 10 * k + 7.9, 10 * k + 8))]


def _run(shift_ns=0, loop=True, stats=None, drift_ns=0, step=None):
    """A traced run; ``shift_ns`` moves the device's stamps off the
    clock events' mapping, ``drift_ns`` moves them by that much more at
    the stretch's end than at its start, ``step`` = (ms, ns) by ns more
    from that ms on."""
    def dev(ms):
        jump = step[1] if step is not None and ms >= step[0] else 0
        return H0 + OFF + int(ms * MS) + shift_ns + int(drift_ns * ms / 100) + jump

    spans = {-1: {"loop_phases": [(n, H0 + int(s * MS), H0 + int(e * MS)) for n, s, e in LOOP],
                  "clock": [(H0 - 900 * MS, OFF), (H0 + 50 * MS, OFF)], "admissions": []}}
    if not loop:
        spans = {}
    run = RunData("w", 1, 1.0, {}, {}, 0, 0, 0.0, [], [], stats or {}, stats or {}, {}, {}, [],
                  0, spans=spans)
    run.ops = [(name, dev(s), dev(e)) for name, s, e in OPS]
    # the markers: launched at 0 and at 100 ms on the monotonic clock, and
    # run there on the card
    run.host_trace = (H0, H0 + 100 * MS)
    run.dev_window = (dev(0), dev(100))
    return run


def _read(name, run):
    return catalog.reader(name)(run)


def test_split_attributes_each_idle_gap_to_its_phase():
    """Each tick's idle gap [8, 11.5) lies in deliver for 1.5 ms, in no
    phase for 0.5 ms and in the next tick's admission for 1.5 ms; the
    stretch opens with 1.5 ms of admission and ends in a deliver."""
    got = loopclock.split(_run())
    assert got == {"admission": 15 * MS, "deliver": 15 * MS, BETWEEN: 5 * MS}
    run = _run()
    assert _read("idle_host_share.chat", run) == pytest.approx(30.0)
    assert _read("idle_host_share.decode", run) == _read("idle_host_share.chat", run)
    assert _read("idle_admission_share.chat", run) == pytest.approx(15.0)
    assert loopclock.covered(run) == pytest.approx(0.95)


def test_shares_nest_inside_the_idle_share():
    run = _run()
    adm, host = _read("idle_admission_share.chat", run), _read("idle_host_share.chat", run)
    assert 0 < adm <= host <= _read("idle_share.chat", run) == pytest.approx(35.0)


def test_each_blocked_fetch_reads_its_copys_offset():
    """The n-th fetch of the stretch is the n-th copy: each blocked fetch
    gives the offset at its end, and the clock events alone already agree."""
    run = _run()
    got = loopclock.anchors(run, run.spans[-1])
    assert got == [(H0 + (10 * k + 8) * MS, 0) for k in range(10)]
    run = _run(shift_ns=int(1.5 * MS))
    assert [o for _, o in loopclock.anchors(run, run.spans[-1])] == [int(1.5 * MS)] * 10


@pytest.mark.parametrize("shift_ms,drift_ms,step", [
    (1.5, 0, None), (-1.5, 0, None), (0, -5.8, None), (0, 15.0, None), (0.5, -8.6, None),
    (0, 0, (45, -4 * MS))])
def test_device_stamps_that_leave_the_host_are_followed_by_the_fetches(shift_ms, drift_ms, step):
    """The device's stamps off the clock events' mapping, by a constant,
    a ramp over the stretch or a step between two ticks: the fetches' offsets
    move the phases with them, the markers sit inside their brackets, and
    the split is the one of a run whose clocks agreed (a step moves the
    tick it falls in: to within its 3.5 ms of idle time)."""
    base = loopclock.split(_run())
    run = _run(shift_ns=int(shift_ms * MS), drift_ns=int(drift_ms * MS), step=step)
    loop = run.spans[-1]
    assert max(abs(e) for e in loopclock.marker_errors(run, loop)) > 0.4 * MS
    assert max(abs(e) for e in loopclock.marker_errors(run, loop, loopclock.mover(run, loop))) \
        < 0.2 * MS
    got = loopclock.split(run)
    span = run.dev_window[1] - run.dev_window[0]
    room = 3.5 * MS if step else 0.002 * span
    # as shares of the stretch (a ramp stretches the device's durations)
    assert all(abs(got.get(k, 0) / span - base.get(k, 0) / (100 * MS)) * span <= room
               for k in set(got) | set(base)), (got, base)
    if step is None:
        assert set(got) == set(base)


def test_a_fetch_woken_late_does_not_move_the_mapping():
    """One fetch returning 0.6 ms after its copy ended (its thread was
    descheduled): the median of five keeps every offset at 0."""
    run = _run()
    loop = run.spans[-1]
    n = next(i for i, p in enumerate(loop["loop_phases"]) if p[0] == "fetch" and p[1] > H0 + 40 * MS)
    name, s, e = loop["loop_phases"][n]
    loop["loop_phases"][n] = (name, s, e + int(0.6 * MS))
    assert [o for _, o in loopclock.anchors(run, loop)] == [0] * 10


def test_a_marker_past_the_refusal_bound_raises():
    """The fetches' mapping puts the end marker 1.5 ms after its launch
    returned: the mapping and the markers disagree, and the readers raise."""
    run = _run()
    run.dev_window = (run.dev_window[0], run.dev_window[1] + int(1.5 * MS))
    with pytest.raises(RuntimeError, match="no longer share a clock"):
        _read("idle_host_share.chat", run)


@pytest.mark.parametrize("case", ["far", "no copies", "no blocked fetch"])
def test_fetches_that_find_no_copy_raise(case):
    """Where the stretch opens, the clock events must place a blocked
    fetch within 10 ms of a copy's end, and the trace must hold copies."""
    run = _run(shift_ns=10 * MS + 400_000) if case == "far" else _run()
    if case == "far":
        # the copies sit at 8.4 ms into each 10-ms tick against the fetches'
        # ends at 8: off by 10.4 or 0.4 ms, the nearest pairs with the wrong
        # copy, and the markers (10.4 ms off their launches) refuse it
        with pytest.raises(RuntimeError, match="no longer share a clock"):
            _read("idle_host_share.chat", run)
        return
    if case == "no copies":
        run.ops = [op for op in run.ops if op[0] != COPY]
    else:
        loop = run.spans[-1]
        loop["loop_phases"] = [(n, s, s + 100_000 if n == "fetch" else e)
                               for n, s, e in loop["loop_phases"]]
    with pytest.raises(RuntimeError, match="found the copy it waited for"):
        _read("idle_host_share.chat", run)


def test_a_marker_is_judged_against_its_launchs_bracket():
    """The start marker's stamp is taken before its launch and the hook
    phase holding it ends after the launch returns: a marker that runs
    2.1 ms after the stamp misses by 0.1 ms after the hook's end, and by
    2.1 ms without the hook phase. The end marker's bracket opens with the
    hook phase that holds its stamp."""
    run = _run()
    loop = run.spans[-1]
    a0, b0 = run.dev_window
    run.dev_window = (a0 + int(2.1 * MS), b0 + 3_000)
    assert loopclock.marker_errors(run, loop) == [int(2.1 * MS), 3_000]
    loop["loop_phases"].append(("hook", H0 - 3_000 * MS, H0 + 2 * MS))
    loop["loop_phases"].append(("hook", H0 + 99 * MS, H0 + 100 * MS + 30_000 * MS))
    assert loopclock.brackets(run, loop) == [(H0, H0 + 2 * MS), (H0 + 99 * MS, H0 + 100 * MS)]
    assert loopclock.marker_errors(run, loop) == [int(0.1 * MS), 3_000]
    assert loopclock.phases(run)
    run.dev_window = (run.dev_window[0], H0 + OFF + 98 * MS)  # before its launch began
    assert loopclock.marker_errors(run, loop)[1] == -1 * MS


def test_a_program_without_the_loop_track_reads_nothing():
    """The parent's ring has no loop phases and its stats() none of the
    new counters: every new reader returns None and none raises."""
    run = _run(loop=False, stats={"decode_ticks": 10})
    for name in ("idle_host_share.chat", "idle_host_share.decode", "idle_admission_share.chat",
                 "prefill_device_p95_ms.chat", "prefill_device_p95_ms.itl",
                 "decode_device_ms.decode", "moe_route_share.itl"):
        assert _read(name, run) is None, name
    untraced = _run()
    untraced.ops = untraced.dev_window = None
    assert loopclock.split(untraced) is None


def _record(rid, due_ns):
    return types.SimpleNamespace(kind="mix", in_window=True, due_ns=due_ns,
                                 req=types.SimpleNamespace(rid=rid), rid=rid)


def test_prefill_device_p95_reads_the_quiet_requests():
    """p95 over the requests due before the profiler of the trace ring's
    prefill_device_ms; requests without it (or due in the stretch) do not
    count."""
    quiet_end = 1_000 * MS
    recs = [_record(i, quiet_end - QUIET_MARGIN_NS - (i + 1) * MS) for i in range(20)]
    recs.append(_record(99, quiet_end))  # due inside the traced stretch
    spans = {i: {"prefill_device_ms": float(i)} for i in range(19)}
    spans[19] = {}
    spans[99] = {"prefill_device_ms": 1e6}
    run = RunData("w", 1, 1.0, {}, {}, 0, 2_000 * MS, 0.0, recs, [], {}, {}, {}, {}, [],
                  quiet_end, spans=spans)
    assert _read("prefill_device_p95_ms.chat", run) == pytest.approx(17.1)
    assert _read("prefill_device_p95_ms.itl", run) == pytest.approx(17.1)


def test_decode_device_ms_and_moe_route_share_read_the_window_deltas():
    s0 = {"decode_ticks": 100, "decode_device_ms": 2400.0,
          "moe_stage_device_ms": {"route": 10.0, "dispatch": 1.0, "experts": 5.0, "combine": 1.0}}
    s1 = {"decode_ticks": 300, "decode_device_ms": 7200.0,
          "moe_stage_device_ms": {"route": 80.0, "dispatch": 6.0, "experts": 25.0,
                                  "combine": 6.0}}
    run = RunData("w", 1, 1.0, {}, {}, 0, 0, 0.0, [], [], s0, s1, {}, {}, [], 0)
    assert _read("decode_device_ms.decode", run) == pytest.approx(24.0)
    assert _read("moe_route_share.itl", run) == pytest.approx(100.0 * 80 / 100)
    dense = {"decode_ticks": 1, "decode_device_ms": 1.0, "moe_stage_device_ms": None}
    assert _read("moe_route_share.itl",
                 RunData("w", 1, 1.0, {}, {}, 0, 0, 0.0, [], [], dense, dense, {}, {}, [],
                         0)) is None
