#!/usr/bin/env python3
"""One run of a cell, read through the serving loop's own timeline.

    python3 portbench/loopsplit.py --workload <name> --seed <n> --seconds <s> [--ring-off]

From the root of a checkout. By default a traced run (``run.py --trace 1``):
its result line, then one JSON line ``{"loopsplit": ...}`` with the card's
idle time in the traced stretch split by the loop phase it fell in (ms and
percent of the stretch, ``loopclock.split``; by the length of the gap too),
the share of the stretch the loop's phases cover, the correction the
fetches apply to the clock events' mapping, and how far the stretch's two
markers sit from their launches by the clock events alone and by the
mapping the readers use. ``--ring-off`` makes an untraced run with the
engine's trace ring off (``trace_events=0``: no lifecycle events, no loop
spans, no device timers), against which an untraced ``run.py`` run, on
the engine's default ring, gives what the instrumentation costs end to
end. Nothing here is part of a cell's result.
"""

import time

T_START_NS = time.monotonic_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)
os.environ["TEARDOWN_CUPTI"] = "0"  # as run.py: set before torch loads

from portbench import catalog, harness, loopclock, system  # noqa: E402
from portbench.run import WATCHDOG_S, card_line  # noqa: E402


def timeline(run) -> dict:
    """The traced stretch seen through the loop's phases."""
    loop = loopclock.loop_track(run)
    if loop is None:
        return {"loop_track": False}
    a, b = run.dev_window
    span = b - a
    clock = sorted(loop["clock"])
    anchors = loopclock.anchors(run, loop) or []
    fetches = [e for name, _, e in loop["loop_phases"]
               if name == "fetch" and a <= loopclock.to_device(clock, e) <= b]
    out = {"loop_track": True, "stretch_ms": span / 1e6,
           # each marker outside its launch's bracket, ms: by the clock
           # events alone, and by the fetches' mapping the readers use
           "marker_errors_ms": [e / 1e6 for e in loopclock.marker_errors(run, loop)],
           "fetches_in_stretch": len(fetches),
           "copies_in_stretch": sum(a <= e <= b for e in loopclock.copy_ends(run)),
           "anchors": len(anchors),
           # the correction the fetches apply: the device clock's offset
           # from the clock events' mapping at each blocked fetch, ms
           "correction_ms": ({"first": anchors[0][1] / 1e6, "last": anchors[-1][1] / 1e6,
                              "min": min(o for _, o in anchors) / 1e6,
                              "max": max(o for _, o in anchors) / 1e6,
                              "every_50th": [[(t - run.host_trace[0]) / 1e9, o / 1e6]
                                             for t, o in anchors[::50]]}
                             if anchors else None),
           "clock_events": len(clock),
           # each clock event's offset, from the first, against its time
           # from the stretch's start (s, ms)
           "clock_drift_ms": [((t - run.host_trace[0]) / 1e9, (o - clock[0][1]) / 1e6)
                              for t, o in clock
                              if run.host_trace[0] - 3e9 <= t <= run.host_trace[1] + 3e9]}
    try:
        move = loopclock.mover(run, loop)
        out["mapped_marker_errors_ms"] = [e / 1e6 for e in loopclock.marker_errors(run, loop, move)]
        # each marker's launch bracket on the device's clock against its
        # start there, ms
        out["marker_brackets_ms"] = [
            [(move(lo) - d) / 1e6, (move(hi) - d) / 1e6]
            for (lo, hi), d in zip(loopclock.brackets(run, loop), run.dev_window)]
        parts = loopclock.split(run)
    except RuntimeError as exc:
        out["error"] = str(exc)
        return out
    out["covered"] = loopclock.covered(run)
    # each phase's idle ms by the length of the idle gap it lies in: a
    # tick's bubbles between kernels are microseconds, a mapping a
    # millisecond off would show as whole gaps in the wrong phase
    edges = ((10_000, "<10us"), (100_000, "10-100us"), (1_000_000, "0.1-1ms"),
             (float("inf"), ">=1ms"))
    by_gap = {}
    for name, ns, gap in loopclock.pieces(run):
        label = next(lab for edge, lab in edges if gap < edge)
        row = by_gap.setdefault(name, dict.fromkeys([lab for _, lab in edges], 0.0))
        row[label] += ns / 1e6
    out["idle_ms_by_gap"] = by_gap
    out["idle_ms"] = {k: v / 1e6 for k, v in sorted(parts.items(), key=lambda kv: -kv[1])}
    out["idle_pct"] = {k: 100.0 * v / span for k, v in parts.items()}
    busy = {}
    for name, s, e in loopclock.phases(run):
        busy[name] = busy.get(name, 0) + min(e, b) - max(s, a)
    out["phase_ms"] = {k: v / 1e6 for k, v in sorted(busy.items(), key=lambda kv: -kv[1])}
    s0, s1 = run.stats0, run.stats1
    ticks = s1["decode_ticks"] - s0["decode_ticks"]
    out["quiet_window"] = {
        "decode_ticks": ticks, "admissions": s1["admissions"] - s0["admissions"],
        "admission_device_ms": s1["admission_device_ms"] - s0["admission_device_ms"],
        "decode_device_ms": s1["decode_device_ms"] - s0["decode_device_ms"],
        "moe_stage_device_ms": ({k: s1["moe_stage_device_ms"][k] - s0["moe_stage_device_ms"][k]
                                 for k in s1["moe_stage_device_ms"]}
                                if s1.get("moe_stage_device_ms") else None)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--ring-off", action="store_true")
    args = ap.parse_args()
    bench = catalog.benchmark()
    cell = catalog.cell(args.workload, bench)
    cell["bench"] = bench
    runs, errors = [], {}
    read = catalog.reader

    def reader(name):
        fn = read(name)

        def noted(run):
            # the run's data for the timeline; a reader's refusal (a clock
            # mapping off its markers) is shown rather than ending the run
            if not runs:
                runs.append(run)
            try:
                return fn(run)
            except RuntimeError as exc:
                errors[name] = str(exc)
                return None

        return noted

    catalog.reader = reader
    if args.ring_off:
        build = system.build_engine
        system.build_engine = lambda cfg, params, device, trace_events=None: build(
            cfg, params, device, 0)
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, not args.ring_off, T_START_NS,
                              watchdog_s=WATCHDOG_S)
    result["card"] = card
    result["ring"] = "off" if args.ring_off else "on"
    result["reader_errors"] = errors
    print(json.dumps(result), flush=True)
    if not args.ring_off and runs:
        print(json.dumps({"loopsplit": timeline(runs[0]), "workload": args.workload,
                          "seed": args.seed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
