#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (a stretch of the window under
``torch.profiler``). The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the reference beside its limit); the same numbers end standard error. Exits
non-zero, printing no result, without the CUDA cards the cell asks for,
or when the JAX package or JAX is loaded at the end.
"""

import time

T_START_NS = time.monotonic_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, heads the module path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

# a --trace 1 run's profiler leaves CUPTI attached when it stops, as
# torch's own profiler does under CUDA graphs before CUDA 12.6: detaching
# it while graphs replay can crash or hang (set before torch loads)
os.environ["TEARDOWN_CUPTI"] = "0"
# after the engine is built, a run ends within this (a first run in a
# checkout builds the kernels before it): a hang prints every thread's
# stack and exits 1 rather than running into the run's time limit
WATCHDOG_S = 300.0


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    def stage(what: str) -> None:
        print(f"{(time.monotonic_ns() - T_START_NS) / 1e9:8.2f} s  {what}", file=sys.stderr,
              flush=True)

    from portbench import catalog

    bench = catalog.benchmark()
    cell = catalog.cell(args.workload, bench)
    cell["bench"] = bench

    import torch

    stage("torch imported")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    stage("cards counted")
    from portbench import harness

    stage("the program imported")
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START_NS,
                              watchdog_s=WATCHDOG_S)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"modules that may not be loaded are: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
