#!/usr/bin/env python3
"""int8-KV against bf16-KV serving on the card: the measurement behind
``vtpu_torch.serving.engine.choose_kv_int8``.

    python3 hack/torch_int8_ab.py [--out INT8_AB_H100.json] [--tiny]

The same engine wave is served once with ``kv_int8=False`` and once with
``kv_int8=True``, the two arms interleaved (bf16 then int8 on even repeats,
int8 then bf16 on odd ones) on two engines built side by side for the
cell. The model is chip_smoke.py's flagship (bf16, 12 layers) with
``max_seq`` set to the cell's window. A wave fills every slot with a
prompt of (window - 160) tokens and decodes 128 new tokens, so the decode
reads close to the whole window. Each arm runs the ``ServingConfig``
default loop (pipelined, on CUDA graphs) with one prefill bucket of the
window.

Cells: slots {4, 8, 16, 32, 64} x window {1024, 2048} x pool {the dense
ring (``kv_page=None``), paged (``kv_page=128``)}.

Each engine serves one warm-up wave, then both arms serve settle rounds
(not counted) until the bf16 arm's decode rate moves less than 2% from one
round to the next (at most 6): after an engine build the card's rate
drifts up over the first waves, which otherwise lands in the first
repeats of both arms.

Per arm and repeat: decode tokens/s (the decode phase alone: the tokens
delivered after the tick that delivered the wave's last first token, over
the time from that delivery to the last one), ms per decode step over the
same ticks, and TTFT p50 (submit to first token). Every delivery is
stamped on the loop thread (a wrapped ``Request.out.put``) with the time
and the engine's tick count. Per arm: their median and min-max over the
repeats, and the device busy share of one more wave under torch.profiler
(device activity only, summed kernel time over the wave's wall time); per
cell also each repeat's int8/bf16 ratio of the pair served back to back.

Verdict: a cell is "int8" when int8's median decode rate is at least
bf16's x (1 - tie), the tie being the larger of the two arms' relative
spreads ((max - min) / median) with a floor of 3%. A cell whose larger
spread is above 10% gets more interleaved repeats, up to 10, before it is
decided; the record says which cells did.

Writes every cell, with both arms' repeats, medians, spreads, TTFT, busy
share, the verdict and the tie used, and the card's name and power limit
(nvidia-smi), to ``--out``. ``--tiny`` runs a toy model and grid on the
CPU (a rehearsal; its numbers mean nothing).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vtpu_torch.models import ModelConfig, init_params  # noqa: E402
from vtpu_torch.serving import ServingConfig, ServingEngine, Terminal  # noqa: E402

SEED = 0
# chip_smoke.py's flagship (bench.py's tenants' model); max_seq is the cell's
FLAGSHIP = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=12, d_ff=4096, head_dim=128)
SLOTS = (4, 8, 16, 32, 64)
WINDOWS = (1024, 2048)
PAGES = (None, 128)
NEW_TOKENS = 128
HEADROOM = 160  # a prompt is window - HEADROOM tokens
TIE_FLOOR = 0.03  # hack/int8_ab.py's tie within run noise
SPREAD_LIMIT = 0.10
REPEATS = 5
MAX_REPEATS = 10
SETTLE_TOL = 0.02
SETTLE_MAX = 6
TINY = dict(model=dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, head_dim=16),
            slots=(2, 4), windows=(64,), pages=(None, 16), new_tokens=8, headroom=24)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured (nvidia-smi unavailable)"


def spread(vals: list) -> float:
    """(max - min) / median."""
    return (max(vals) - min(vals)) / statistics.median(vals)


def wave(eng, prompts, new_tokens: int) -> dict:
    """Serve ``prompts`` at once on the running engine; every delivery is
    stamped (monotonic ns, the engine's decode tick count) on the loop
    thread. Returns the wave's decode rate, ms per decode step and TTFTs."""
    stamps: list = [[] for _ in prompts]
    stats = eng._stats
    reqs = []
    for p, mine in zip(prompts, stamps):
        req = eng.submit(p, max_new_tokens=new_tokens)
        put = req.out.put

        def stamped(item, *a, _put=put, _mine=mine, **kw):
            if item is not None and not isinstance(item, Terminal):
                _mine.append((time.monotonic_ns(), stats["decode_ticks"]))
            return _put(item, *a, **kw)

        req.out.put = stamped
        reqs.append(req)
    toks = [list(r.stream()) for r in reqs]
    for req, got, mine in zip(reqs, toks, stamps):
        if req.status != "OK" or len(got) != new_tokens or len(mine) != new_tokens:
            raise AssertionError(f"a stream ended {req.status} with {len(got)} tokens "
                                 f"({len(mine)} stamped) of {new_tokens}")
    # the decode phase: after the delivery of the wave's last first token
    t0, c0 = max(s[0] for s in stamps)
    after = [t for s in stamps for t, c in s if c > c0]
    t1, c1 = max((t, c) for s in stamps for t, c in s)
    if not after or t1 <= t0:
        raise AssertionError("no decode tick after the wave's last first token")
    return {"decode_tokens_per_s": len(after) / ((t1 - t0) / 1e9),
            "ms_per_decode_step": (t1 - t0) / 1e6 / (c1 - c0),
            "decode_tokens": len(after), "decode_ticks": c1 - c0,
            "ttft_ms": sorted((s[0][0] - r.t_submit_ns) / 1e6 for s, r in zip(stamps, reqs))}


def busy_share(eng, prompts, new_tokens: int) -> float | None:
    """The device busy share of one more wave under torch.profiler (device
    activity only; None when it recorded none, as on the CPU)."""
    if not torch.cuda.is_available():
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wave(eng, prompts, new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9
    return busy / wall if busy else None


def arm_summary(runs: list) -> dict:
    rates = [r["decode_tokens_per_s"] for r in runs]
    steps = [r["ms_per_decode_step"] for r in runs]
    ttft = [statistics.median(r["ttft_ms"]) for r in runs]
    return {"decode_tokens_per_s": rates, "median_decode_tokens_per_s": statistics.median(rates),
            "min_decode_tokens_per_s": min(rates), "max_decode_tokens_per_s": max(rates),
            "spread": spread(rates),
            "ms_per_decode_step": steps, "median_ms_per_decode_step": statistics.median(steps),
            "ttft_p50_ms": ttft, "median_ttft_p50_ms": statistics.median(ttft),
            "min_ttft_p50_ms": min(ttft), "max_ttft_p50_ms": max(ttft),
            "decode_ticks": [r["decode_ticks"] for r in runs]}


def cell(params, dims: dict, dtype, slots: int, window: int, page, new_tokens: int,
         headroom: int, device: str, log) -> dict:
    """One cell: both arms' engines built, warmed by one wave each and the
    settle rounds, then REPEATS interleaved waves (more while the larger
    spread is above SPREAD_LIMIT, up to MAX_REPEATS), then one profiled
    wave each."""
    t_cell = time.perf_counter()
    rs = np.random.RandomState(SEED + slots + window)
    prompts = [rs.randint(0, dims["vocab"], (window - headroom,)).astype(np.int32)
               for _ in range(slots)]
    serving = ServingConfig(slots=slots, prefill_buckets=(window,), max_new_tokens=new_tokens,
                            kv_page=page)
    engines = {}
    try:
        for kv in ("bf16", "int8"):
            cfg = ModelConfig(**dims, max_seq=window, dtype=dtype, use_kernels=True,
                              kv_int8=kv == "int8")
            eng = ServingEngine(params, cfg, serving, device=device)
            eng.start()
            engines[kv] = eng
            wave(eng, prompts, new_tokens)  # warm-up, not counted
        order = ("bf16", "int8")
        # settle, not counted: both arms in turn until the bf16 arm's decode
        # rate moves under SETTLE_TOL from one round to the next (the card's
        # rate drifts up over the first waves after an idle engine build)
        settle, last = 0, None
        while settle < SETTLE_MAX:
            settle += 1
            rate = [wave(engines[kv], prompts, new_tokens)["decode_tokens_per_s"]
                    for kv in order][0]
            if last is not None and abs(rate / last - 1) < SETTLE_TOL:
                break
            last = rate
        runs = {"bf16": [], "int8": []}
        while True:
            for kv in order if len(runs["bf16"]) % 2 == 0 else order[::-1]:
                runs[kv].append(wave(engines[kv], prompts, new_tokens))
            n = len(runs["bf16"])
            worst = max(spread([r["decode_tokens_per_s"] for r in runs[kv]]) for kv in runs)
            if n >= REPEATS and (worst <= SPREAD_LIMIT or n >= MAX_REPEATS):
                break
        busy = {kv: busy_share(eng, prompts, new_tokens) for kv, eng in engines.items()}
    finally:
        for eng in engines.values():
            eng.stop()
    for kv, eng in engines.items():
        if eng.loop_error is not None:
            raise RuntimeError(f"the {kv} engine's loop failed: {eng.loop_error!r}")
    arms = {kv: {**arm_summary(runs[kv]), "device_busy_share": busy[kv]} for kv in runs}
    b, q = (arms[kv]["median_decode_tokens_per_s"] for kv in ("bf16", "int8"))
    tie = max(TIE_FLOOR, arms["bf16"]["spread"], arms["int8"]["spread"])
    pairs = [r8["decode_tokens_per_s"] / r16["decode_tokens_per_s"]
             for r16, r8 in zip(runs["bf16"], runs["int8"])]
    out = {"slots": slots, "window": window, "pool": "dense" if page is None else "paged",
           "kv_page": page, "prompt_tokens": window - headroom, "new_tokens": new_tokens,
           "settle_rounds": settle, "repeats": len(runs["bf16"]),
           "repeated": len(runs["bf16"]) > REPEATS,
           "paired_int8_over_bf16": pairs,
           "int8_over_bf16": q / b, "tie": tie, "verdict": "int8" if q >= b * (1 - tie) else "bf16",
           "bf16": arms["bf16"], "int8": arms["int8"], "seconds": time.perf_counter() - t_cell}
    log(f"slots {slots:3d} window {window} {out['pool']:5s}: bf16 {b:9.1f} "
        f"[{arms['bf16']['min_decode_tokens_per_s']:.1f}, "
        f"{arms['bf16']['max_decode_tokens_per_s']:.1f}] int8 {q:9.1f} "
        f"[{arms['int8']['min_decode_tokens_per_s']:.1f}, "
        f"{arms['int8']['max_decode_tokens_per_s']:.1f}] decode tokens/s, int8/bf16 "
        f"{q / b:.3f} (pairs {min(pairs):.3f}-{max(pairs):.3f}), tie {tie:.3f} -> "
        f"{out['verdict']} ({settle} settle rounds, {out['repeats']} repeats); TTFT p50 "
        f"{arms['bf16']['median_ttft_p50_ms']:.1f} / {arms['int8']['median_ttft_p50_ms']:.1f} "
        f"ms; busy {busy['bf16']} / {busy['int8']}; {out['seconds']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="INT8_AB_H100.json")
    ap.add_argument("--tiny", action="store_true",
                    help="a toy model and grid on the CPU (a rehearsal; its numbers mean nothing)")
    args = ap.parse_args()
    device = "cpu" if args.tiny else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("torch_int8_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.tiny:
        dims, dtype = TINY["model"], torch.float32
        grid = (TINY["slots"], TINY["windows"], TINY["pages"])
        new_tokens, headroom = TINY["new_tokens"], TINY["headroom"]
    else:
        dims, dtype = FLAGSHIP, torch.bfloat16
        grid, new_tokens, headroom = (SLOTS, WINDOWS, PAGES), NEW_TOKENS, HEADROOM
    if device == "cuda":
        from vtpu_torch.ops import _build

        _build.build_all()
    card = gpu_line() if device == "cuda" else "cpu (a rehearsal)"

    def log(msg: str) -> None:
        print(msg, flush=True)

    log(f"card: {card}; torch {torch.__version__}")
    t_all = time.perf_counter()
    params = init_params(SEED, ModelConfig(**dims, max_seq=max(grid[1]), dtype=dtype),
                         device=device)
    cells = []
    for window in grid[1]:
        for page in grid[2]:
            for slots in grid[0]:
                cells.append(cell(params, dims, dtype, slots, window, page, new_tokens,
                                  headroom, device, log))
                gc.collect()
                if device == "cuda":
                    torch.cuda.empty_cache()
    out = {"what": "int8-KV against bf16-KV serving, the same wave on two engines built side by "
                   "side, arms interleaved; decode tokens/s of the decode phase alone",
           "script": "hack/torch_int8_ab.py", "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "model": {**dims, "dtype": str(dtype)},
           "loop": "ServingConfig default (pipelined, on CUDA graphs)",
           "tie_floor": TIE_FLOOR, "spread_limit": SPREAD_LIMIT, "max_repeats": MAX_REPEATS,
           "min_repeats": REPEATS, "seconds": time.perf_counter() - t_all, "cells": cells}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    log(json.dumps({"cells": len(cells), "int8": [(c["slots"], c["window"], c["pool"])
                                                  for c in cells if c["verdict"] == "int8"],
                    "seconds": round(out["seconds"], 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
