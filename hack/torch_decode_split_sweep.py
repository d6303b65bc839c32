#!/usr/bin/env python3
"""Time the port's dense decode kernel (vtpu_torch/csrc/decode_attention.cu)
over tile size x ring depth x split plan, beside SDPA, on one CUDA card.

    python3 hack/torch_decode_split_sweep.py [--json PATH]

Each variant is the committed source with DENSE_TILE (32 or 64 keys) and
SPLIT_STAGES (3 or 4 ring slots) substituted, built with the port's nvcc
flags into build/decode_split_sweep/. Each split plan is
``dense_split_plan`` under a (SPLIT_BLOCKS, SPLIT_MAX_TILES) pair; the
shipped kernel is tile 32, ring 3 under the module's own pair. At every
study cell (batch 8/32 x window 1024/2048, H 8, Dh 128, T = 1, bf16 and
int8, inputs as chip_smoke.py makes them) each variant is checked against
the plain version (atol 2e-2) and timed in three interleaved rounds with
SDPA (min of the rounds, device ms per call). Needs a card; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import STUDY_CELLS, STUDY_DH, STUDY_H, dequant, gpu_line, study_inputs, time_ms  # noqa: E402
from vtpu_torch.ops import _build, decode_attn  # noqa: E402

VARIANTS = [(32, 3), (32, 4), (64, 3), (64, 4)]  # (keys per tile, ring slots)
PLANS = [(decode_attn.SPLIT_BLOCKS, decode_attn.SPLIT_MAX_TILES), (528, 10**6), (1056, 10**6),
         (2112, 10**6)]  # (SPLIT_BLOCKS, SPLIT_MAX_TILES); the first is the shipped plan
COLD_BYTES = 150e6  # input sets per cell cycle through more than the 50 MB L2


def build() -> dict:
    csrc = _build.CSRC
    out = ROOT / "build" / "decode_split_sweep"
    procs = {}
    for tile, stages in VARIANTS:
        d = out / f"t{tile}s{stages}"
        d.mkdir(parents=True, exist_ok=True)
        src = re.sub(r"constexpr int DENSE_TILE = \d+;", f"constexpr int DENSE_TILE = {tile};",
                     (csrc / "decode_attention.cu").read_text())
        hdr = re.sub(r"constexpr int SPLIT_STAGES = \d+;",
                     f"constexpr int SPLIT_STAGES = {stages};",
                     (csrc / "decode_tiles.cuh").read_text())
        (d / "decode_attention.cu").write_text(src)
        (d / "decode_tiles.cuh").write_text(hdr)
        procs[(tile, stages)] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "decode_attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        fn = ctypes.CDLL(str(out / f"t{key[0]}s{key[1]}" / "lib.so")).vtpu_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def n_splits(b: int, h: int, s: int, tile: int, plan: tuple) -> int:
    """``dense_split_plan`` for a tile size and a (SPLIT_BLOCKS,
    SPLIT_MAX_TILES) pair."""
    n_tiles = -(-s // tile)
    want = max(-(-plan[0] // (b * h)), -(-n_tiles // plan[1]))
    return max(1, min(want, n_tiles // 2))


def launch(fn, x: dict, n: int) -> torch.Tensor:
    q, k, v, lens = x["q"], x["k"], x["v"], x["kv_len"]
    b, t, h, dh = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    acc = torch.empty((n, b, t, h, dh), dtype=torch.float32, device="cuda") if n > 1 else None
    ml = torch.empty((n, b, t, h, 2), dtype=torch.float32, device="cuda") if n > 1 else None
    int8 = "k_scale" in x
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             x["k_scale"].data_ptr() if int8 else None, x["v_scale"].data_ptr() if int8 else None,
             lens.data_ptr(), out.data_ptr(), None if acc is None else acc.data_ptr(),
             None if ml is None else ml.data_ptr(), 1, int(int8), b, t, h, dh, s, s, n,
             1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention variant")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = gpu_line()
    print(f"card: {card}", flush=True)
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for int8 in (False, True):
        for b, s in STUDY_CELLS:
            per_set = b * s * STUDY_H * STUDY_DH * (1 if int8 else 2) * 2
            sets = study_inputs(gen, b, s, 1, int8, copies=max(1, -(-int(COLD_BYTES) // per_set)))
            want = decode_attn.decode_attention_ref(**sets[0]).float()
            mask = (torch.arange(s, device="cuda")[None, :] < sets[0]["kv_len"])[:, None, None]

            def sdpa(i):
                x = sets[i % len(sets)]
                k, v = ((dequant(x[key], x[f"{key}_scale"]) if int8 else x[key]) for key in "kv")
                return F.scaled_dot_product_attention(x["q"].transpose(1, 2), k.transpose(1, 2),
                                                      v.transpose(1, 2), attn_mask=mask)

            times: dict[str, list] = {}
            for rnd in range(3):
                for (tile, stages), fn in fns.items():
                    for plan in PLANS:
                        n = n_splits(b, STUDY_H, s, tile, plan)
                        if rnd == 0:
                            err = float((launch(fn, sets[0], n).float() - want).abs().max())
                            if not err <= 2e-2:
                                raise AssertionError(f"variant t{tile}s{stages} plan {plan}: "
                                                     f"max_abs_err {err}")
                        ms, _ = time_ms(lambda i: launch(fn, sets[i % len(sets)], n), 30)
                        times.setdefault(f"t{tile}s{stages} {plan[0]}/{plan[1]} n{n}", []).append(ms)
                times.setdefault("SDPA", []).append(time_ms(sdpa, 30)[0])
            best = {key: min(v) for key, v in times.items()}
            rows.append({"kv": "int8" if int8 else "bf16", "batch": b, "window": s, "ms": best})
            print(f"{'int8' if int8 else 'bf16'} ({b}, {s}): "
                  + "; ".join(f"{key} {ms:.4f}" for key, ms in best.items()), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
