#!/usr/bin/env python3
"""Find an open-loop cell's knee: the highest offered rate the engine
sustains without a growing backlog.

    python3 portbench/sweep.py --workload <open-loop cell> --seeds <n>[,<n>...] \
        --seconds <s> --rates 4,6,8 [--out <file>.json]

One engine is built and warmed as a run does (weights from the first
seed); then each rate in turn is offered once for each seed's schedule,
its warm-up and ``--seconds`` of the mix at that rate, and the engine is
drained before the next. Per rate: the offered
and the completed rate over the window (requests submitted in it, and
requests that ended in it, over its seconds), the backlog (submitted and
not yet given a first token) at the window's start and end, TTFT p50 and
p95 and ITL p95 over the requests due in it.

A rate is sustained (``judge``) when the backlog at the end is no longer
than at the start (with one request of slack) and the median TTFT stays
under twice the median at the lowest rate offered on that seed: the
backlog is one reading at each end and can miss a line that stands
through the window, which the median wait shows. The completed rate is
reported but not judged: requests outlast a window of tens of seconds (512
tokens at 40-100 ms), and after a short warm-up the engine is still
filling its slots, so completions trail submissions with no line formed.
The knee is the highest rate at and below which every rate offered was
sustained on every seed. This is a tool for defining a cell (its rate is
4/5 of the knee); the runs of the benchmark never call it.
"""

import time

T_START_NS = time.monotonic_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def backlog(recs, at: int) -> int:
    return sum(1 for r in recs if r.submit_ns < at and not (r.q.stamps and r.q.stamps[0] < at))


def outstanding(recs, at: int) -> int:
    return sum(1 for r in recs if r.submit_ns < at and not (r.q.end_ns and r.q.end_ns < at))


def judge(rows: list[dict]):
    """Mark each row ``sustained``; return the knee (None if the lowest
    rate already failed)."""
    base = {}
    for r in sorted(rows, key=lambda r: r["rate"]):
        base.setdefault(r["seed"], r["ttft_p50_ms"])
    for r in rows:
        r["sustained"] = (r["backlog_end"] <= r["backlog_start"] + 1
                          and r["ttft_p50_ms"] < 2 * base[r["seed"]])
    failed = min((r["rate"] for r in rows if not r["sustained"]), default=float("inf"))
    return max((r["rate"] for r in rows if r["rate"] < failed), default=None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    seeds = [int(x) for x in args.seeds.split(",")]

    import torch

    from portbench import catalog, system, traffic
    from portbench.client import Clients
    from portbench.harness import _sleep_until, mix_buckets
    from portbench.yardstick import percentile

    cell = catalog.cell(args.workload)
    cfg, mix = cell["cfg"], cell["mix"]
    if mix["loop"] != "open":
        raise SystemExit("the knee is an open loop's")
    params = system.make_params(cfg, seeds[0], "cuda")
    eng = system.build_engine(cfg, params, "cuda")
    clients = Clients(eng)
    sizes = [n for n in cfg["serving"]["prefill_batch_sizes"] if n <= eng.serving.slots]
    clients.warm_shapes(traffic.warm_shapes(mix_buckets(cfg, mix), sizes, seeds[0],
                                            cfg["vocab_size"]))
    eng.start()
    clients.wait(clients.records, time.monotonic_ns() + int(300e9))
    print(f"set-up {(time.monotonic_ns() - T_START_NS) / 1e9:.1f} s", file=sys.stderr)
    rows = []
    try:
        for rate, seed in [(float(x), s) for x in args.rates.split(",") for s in seeds]:
            plan = traffic.open_loop(mix, rate, args.seconds, seed, cfg["vocab_size"])
            first = len(clients.records)
            start = time.monotonic_ns() + 50_000_000
            t0 = start + int(mix["warmup_s"] * 1e9)
            t1 = t0 + int(args.seconds * 1e9)
            feeder = clients.open_loop(plan, start, threading.Event())
            _sleep_until(t1)
            feeder.join()
            recs = clients.records[first:]
            b0, b1 = backlog(recs, t0), backlog(recs, t1)
            offered = sum(1 for r in recs if t0 <= r.submit_ns < t1) / args.seconds
            done = sum(1 for r in recs if r.q.end_ns is not None and t0 <= r.q.end_ns < t1)
            clients.wait(recs, time.monotonic_ns() + int(mix["drain_s"] * 1e9))
            win = [r for r in recs if r.in_window and r.q.stamps]
            ttft = [(r.q.stamps[0] - r.due_ns) / 1e6 for r in win]
            itl = [(b - a) / 1e6 for r in win for a, b in zip(r.q.stamps, r.q.stamps[1:])]
            row = {"rate": rate, "seed": seed, "offered_per_s": offered, "completed_per_s": done / args.seconds,
                   "backlog_start": b0, "backlog_end": b1,
                   "outstanding_start": outstanding(recs, t0),
                   "outstanding_end": outstanding(recs, t1),
                   "ttft_p50_ms": percentile(ttft, 50), "ttft_p95_ms": percentile(ttft, 95),
                   "itl_p95_ms": percentile(itl, 95), "requests": len(win),
                   "lateness_p95_ms": percentile(clients.lateness_ns[-len(plan):], 95) / 1e6}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    finally:
        eng.stop()
        clients.close()
    out = {"workload": args.workload, "seeds": seeds, "seconds": args.seconds,
           "card": torch.cuda.get_device_name(0), "rates": rows, "knee_per_s": judge(rows)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
