#!/usr/bin/env python3
"""Probe the multi-tick flush's graph capture after the smoke's earlier phases.

    python3 hack/torch_loop_capture_probe.py [--tries 10] [--json PATH]
    compute-sanitizer --tool memcheck \
        python3 hack/torch_loop_capture_probe.py --chunk-only --layers 2

One call of chip_smoke.py failed once at phase g's first graph capture (the
``decode_loop_k=8`` flush) with CUBLAS_STATUS_EXECUTION_FAILED, after phases
a-f had passed in the same process. This probe runs chip_smoke.py's kernel
checks and phases a-f in one process on the card (the main path with bf16
and int8 KV, the loop comparison, the host-sampler wave, chunked + prefix,
the dense decode study), then builds phase g's ``decode_loop_k=8`` engine ``--tries`` times
(each capture of its flush graphs is that first capture again) and serves
one wave on each, its streams held against the plain trunk. It prints one
line a try and, last, a JSON summary: the tries, how many built and served,
and each failure's text.

``--chunk-only`` runs phase e (chunked prefill and a registered prefix, the
one path PR 13 changed before phase g) alone with the flagship cut to
``--layers`` layers: the shape to run under compute-sanitizer, where every
kernel is slow.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def loop_engine_tries(log, params, tries: int, refs: list) -> dict:
    """Build phase g's decode_loop_k=8 engine ``tries`` times; serve the
    main path's wave of 16 tokens on each, held against ``refs``."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.serving import ServingConfig, ServingEngine

    cfg = ModelConfig(**cs.FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    serving = ServingConfig(slots=4, prefill_buckets=(1024,), max_new_tokens=16, kv_page=128,
                            decode_loop_k=cs.LOOP_K)
    prompts = cs.wave_prompts(cfg.vocab)
    out = {"tries": tries, "built": 0, "served": 0, "failures": []}
    for i in range(tries):
        t0 = time.perf_counter()
        try:
            eng = ServingEngine(params, cfg, serving)
            out["built"] += 1
            build_s = time.perf_counter() - t0
            eng.start()
            try:
                recs, wall = cs.stream_all(eng, prompts)
            finally:
                eng.stop()
            if eng.loop_error is not None:
                raise AssertionError(f"loop failed: {eng.loop_error!r}")
            compared, ties = cs.check_streams([r["toks"] for r in recs], refs, f"try {i}")
            torch.cuda.synchronize()
            out["served"] += 1
            log(f"try {i}: built in {build_s:.2f} s ({len(eng._graph_sets())} graph sets), "
                f"served {sum(len(r['toks']) for r in recs)} tokens in {wall:.2f} s, "
                f"{compared} compared equal, {ties} cut at a near-tie")
            del eng
        except Exception as exc:  # the probe's boundary: record, go on
            out["failures"].append(f"try {i}: {exc!r}")
            log(f"try {i} FAILED after {time.perf_counter() - t0:.2f} s:\n"
                + traceback.format_exc())
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tries", type=int, default=10)
    ap.add_argument("--chunk-only", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--json", help="also write the summary to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    from vtpu_torch.models import ModelConfig, init_params
    from vtpu_torch.ops import _build

    def log(msg: str) -> None:
        print(msg, flush=True)

    card = cs.gpu_line()
    log(f"card: {card}")
    if args.layers:
        cs.FLAGSHIP = dict(cs.FLAGSHIP, n_layers=args.layers)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(cs.SEED, ModelConfig(**cs.FLAGSHIP, dtype=torch.bfloat16))
    summary: dict = {"card": card, "phases_s": {}}
    t0 = time.perf_counter()
    if args.chunk_only:
        cs.chunked_prefix_path(log, card, params)
        summary["phases_s"]["chunked + prefix"] = time.perf_counter() - t0
    else:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        cs.check_flash(gen, log)
        for check in (cs.check_paged, cs.check_decode, cs.check_paged_tp):
            for int8 in (False, True):
                check(gen, log, int8)
        main_path = cs.serving_path(log, card, params, kv_int8=False)
        int8 = cs.serving_path(log, card, params, kv_int8=True)
        refs = {"bf16": main_path.pop("refs"), "int8": int8.pop("refs")}
        for kv in ("bf16", "int8"):
            cs.loop_comparison(log, card, params, kv == "int8", refs[kv])
        cs.host_sampler_path(log, card, params, refs["bf16"], main_path["tokens_per_s"])
        cs.chunked_prefix_path(log, card, params)
        cs.study_path(gen, log)
        summary["phases_s"]["a-f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary.update(loop_engine_tries(log, params, args.tries, refs["bf16"]))
        summary["phases_s"]["tries"] = time.perf_counter() - t0
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 1 if summary.get("failures") else 0


if __name__ == "__main__":
    sys.exit(main())
