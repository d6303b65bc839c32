#!/usr/bin/env python3
"""Read a cell's comparison and its control on several seeds, at the
cell's own size and load.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--out <file>.json]

Each seed is one run of the cell as ``run.py`` makes it (a shorter window
will do: the sample is drawn from what finished), and then, at the same
positions of the same sampled requests, the control: the reference with
every matmul in float8 e4m3. Prints and writes, per seed, the widest and
the mean gap of the served tokens (what a run compares) and of the
control's first choices. The limit of a cell lies between the program's largest
reading and the control's smallest (PERF.md gives both). The benchmark's
runs never compute the control.
"""

import time

T_START_NS = time.monotonic_ns()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from portbench import catalog, harness

    cell = catalog.cell(args.workload)
    rows = []
    for seed in [int(x) for x in args.seeds.split(",")]:
        r = harness.run_cell(cell, seed, args.seconds, False, time.monotonic_ns(),
                             control=True)
        c = r["checks"]
        row = {"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
               "failed": r["failed"], "tokens": c["served_tokens_compared"]["value"],
               **{k: c[k]["value"] for k in ("max_logit_gap", "mean_logit_gap",
                                              "control_max_logit_gap",
                                              "control_mean_logit_gap")}}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    out = {"workload": args.workload, "seconds": args.seconds,
           "card": torch.cuda.get_device_name(0), "seeds": rows,
           **{f"{k}_max": max(r[k] for r in rows) for k in ("max_logit_gap", "mean_logit_gap")},
           **{f"{k}_min": min(r[k] for r in rows)
              for k in ("control_max_logit_gap", "control_mean_logit_gap")}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
