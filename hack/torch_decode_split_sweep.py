#!/usr/bin/env python3
"""Time the port's split-walk decode kernels (vtpu_torch/csrc/
decode_attention.cu, the dense study kernel, and paged_decode_attention.cu,
the serving path's) over tile size x ring depth x launch mode x split plan,
beside one PyTorch call, on one CUDA card.

    python3 hack/torch_decode_split_sweep.py [--kernels dense,paged]
        [--tiles 16,32,64] [--stages 3,4] [--pdl 1] [--blocks 528,512,640]
        [--json PATH]

Each variant is the committed source with its tile constant (DENSE_TILE or
PAGED_TILE), SPLIT_STAGES (ring slots) and SPLIT_PDL (programmatic
dependent launch of the walk and the combine) substituted, built with the
port's nvcc flags into build/decode_split_sweep/. Each split plan is the
port's split rule (``decode_attn._split_plan``) under another
(SPLIT_BLOCKS, SPLIT_MAX_TILES) pair; the first is the shipped pair, and
``--blocks`` replaces the others by SPLIT_BLOCKS values at the shipped
SPLIT_MAX_TILES.

- dense (default tiles 32/64): every study cell (batch 8/32 x window
  1024/2048, H 8, Dh 128, T = 1, bf16 and int8, inputs as chip_smoke.py
  makes them), beside SDPA (int8: dequantize + SDPA);
- paged (default tiles 16/32/64, SPLIT_BLOCKS {shipped 528, 640, 256,
  1056}: at the serving tick's 32 (row, head) pairs and 32-key tiles, 16
  splits (one resident wave), 20 (the cap of two tiles a split, 640
  blocks), 8, and 20 again): the serving tick (chip_smoke.serving_tick over the
  [12, 41, 128, 8, 128] pool), the ragged T=4 copy-on-write chunk
  (chip_smoke.cow_chunk), and rank 0's head shard at tp=2 (whose shipped
  plan takes the full head count), bf16 and int8, beside gather + SDPA
  (int8: gather + dequantize + SDPA).

Every variant is checked against the plain version (atol 2e-2) and timed
in three interleaved rounds (min of the rounds and their spread, device ms
per call, the layer planes cycled so operands come from beyond the L2).
Needs a card; imports no jax.
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

from chip_smoke import (  # noqa: E402
    ATOL, STUDY_CELLS, STUDY_DH, STUDY_H, TP, cow_chunk, dequant, gpu_line, paged_pools,
    serving_tick, study_inputs, time_ms,
)
from vtpu_torch.ops import _build, decode_attn  # noqa: E402
from vtpu_torch.ops.attention import gather_kv_pages  # noqa: E402
from vtpu_torch.parallel import TpMesh, head_shard  # noqa: E402

SHIPPED = (decode_attn.SPLIT_BLOCKS, decode_attn.SPLIT_MAX_TILES)
# kind -> (source, tile constant, default tiles, default split plans as
# (SPLIT_BLOCKS, SPLIT_MAX_TILES), entry points -> (pointer, int) args)
KINDS = {
    "dense": ("decode_attention", "DENSE_TILE", (32, 64),
              [SHIPPED, (640, SHIPPED[1]), (528, 10**6), (1056, 10**6), (2112, 10**6)],
              {"vtpu_decode_attention": (9, 9)}),
    "paged": ("paged_decode_attention", "PAGED_TILE", (16, 32, 64),
              [SHIPPED, (640, SHIPPED[1]), (256, SHIPPED[1]), (1056, SHIPPED[1])],
              {"vtpu_paged_decode_attention": (8, 10),
               "vtpu_paged_decode_attention_int8kv": (10, 10)}),
}
COLD_BYTES = 150e6  # input sets per cell cycle through more than the 50 MB L2


def build(variants: dict) -> dict:
    """{(kind, tile, stages, pdl): {entry point: ctypes function}} for
    ``variants`` ({kind: [(tile, stages, pdl), ...]}), every variant's nvcc
    started at once."""
    csrc = _build.CSRC
    procs = {}
    for kind, keys in variants.items():
        source, const = KINDS[kind][:2]
        for tile, stages, pdl in keys:
            d = ROOT / "build" / "decode_split_sweep" / f"{kind}_t{tile}s{stages}p{pdl}"
            d.mkdir(parents=True, exist_ok=True)
            src = re.sub(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {tile};",
                         (csrc / f"{source}.cu").read_text())
            hdr = re.sub(r"constexpr int SPLIT_STAGES = \d+;",
                         f"constexpr int SPLIT_STAGES = {stages};",
                         (csrc / "decode_tiles.cuh").read_text())
            hdr = re.sub(r"constexpr bool SPLIT_PDL = \w+;",
                         f"constexpr bool SPLIT_PDL = {'true' if pdl else 'false'};", hdr)
            (d / f"{source}.cu").write_text(src)
            (d / "decode_tiles.cuh").write_text(hdr)
            procs[(kind, tile, stages, pdl)] = d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / f"{source}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    fns = {}
    for key, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        fns[key] = {}
        for sym, (n_ptr, n_int) in KINDS[key[0]][4].items():
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[key][sym] = fn
    return fns


def n_splits(bh: int, n_tiles: int, plan: tuple) -> int:
    """``decode_attn._split_plan`` over ``n_tiles`` tiles and B x H blocks
    under a (SPLIT_BLOCKS, SPLIT_MAX_TILES) pair."""
    shipped = decode_attn.SPLIT_BLOCKS, decode_attn.SPLIT_MAX_TILES
    decode_attn.SPLIT_BLOCKS, decode_attn.SPLIT_MAX_TILES = plan
    try:
        return decode_attn._split_plan(bh, n_tiles)
    finally:
        decode_attn.SPLIT_BLOCKS, decode_attn.SPLIT_MAX_TILES = shipped


def launch_dense(fns: dict, x: dict, n: int) -> torch.Tensor:
    q, k, v, lens = x["q"], x["k"], x["v"], x["kv_len"]
    b, t, h, dh = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    acc, ml = decode_attn._partials(n, q)  # held until the launch is enqueued
    int8 = "k_scale" in x
    err = fns["vtpu_decode_attention"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        x["k_scale"].data_ptr() if int8 else None, x["v_scale"].data_ptr() if int8 else None,
        lens.data_ptr(), out.data_ptr(), decode_attn._ptr(acc), decode_attn._ptr(ml), 1,
        int(int8), b, t, h, dh, s, s, n, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention variant")
    return out


def launch_paged(fns: dict, q, pools: list, table, kv_len, layer: int, n: int) -> torch.Tensor:
    b, t, h, dh = q.shape
    out = torch.empty_like(q)
    acc, ml = decode_attn._partials(n, q)  # held until the launch is enqueued
    nb, page = pools[0].shape[1:3]
    tail = (decode_attn._ptr(acc), decode_attn._ptr(ml), 1, b, t, h, dh, nb, page,
            table.shape[1], layer, n, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    if len(pools) == 4:
        err = fns["vtpu_paged_decode_attention_int8kv"](
            q.data_ptr(), *(x.data_ptr() for x in pools), table.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), *tail)
    else:
        err = fns["vtpu_paged_decode_attention"](
            q.data_ptr(), *(x.data_ptr() for x in pools), table.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), *tail)
    _build.check(err, "paged_decode_attention variant")
    return out


def sweep(times: dict, label: str, fn, want: torch.Tensor, rnd: int) -> None:
    """Check ``fn`` against ``want`` in round 0, then time it into ``times``."""
    if rnd == 0:
        err = float((fn(0).float() - want.float()).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"{label}: max_abs_err {err}")
    times.setdefault(label, []).append(time_ms(fn, 30)[0])


def sweep_dense(fns: dict, plans: list, gen) -> list:
    rows = []
    for int8 in (False, True):
        for b, s in STUDY_CELLS:
            per_set = b * s * STUDY_H * STUDY_DH * (1 if int8 else 2) * 2
            sets = study_inputs(gen, b, s, 1, int8, copies=max(1, -(-int(COLD_BYTES) // per_set)))
            want = decode_attn.decode_attention_ref(**sets[0])
            mask = (torch.arange(s, device="cuda")[None, :] < sets[0]["kv_len"])[:, None, None]

            def sdpa(i):
                x = sets[i % len(sets)]
                k, v = ((dequant(x[key], x[f"{key}_scale"]) if int8 else x[key]) for key in "kv")
                return F.scaled_dot_product_attention(x["q"].transpose(1, 2), k.transpose(1, 2),
                                                      v.transpose(1, 2), attn_mask=mask)

            times: dict[str, list] = {}
            for rnd in range(3):
                for (kind, tile, stages, pdl), fn in fns.items():
                    if kind != "dense":
                        continue
                    for plan in plans:
                        n = n_splits(b * STUDY_H, -(-s // tile), plan)
                        sweep(times, f"t{tile}s{stages}p{pdl} {plan[0]}/{plan[1]} n{n}",
                              lambda i: launch_dense(fn, sets[i % len(sets)], n), want, rnd)
                times.setdefault("SDPA", []).append(time_ms(sdpa, 30)[0])
            rows.append(report("dense", f"{'int8' if int8 else 'bf16'} ({b}, {s})", times))
    return rows


def sweep_paged(fns: dict, plans: list, gen) -> list:
    rows = []
    n_layers, h, dh, page = 12, 8, 128, 128
    mesh = TpMesh(rank=0, size=TP, device=torch.device("cuda"))
    for int8 in (False, True):
        kv = "int8" if int8 else "bf16"
        pools, wp = paged_pools(gen, n_layers, page, h, int8)
        table, kv1, _ = serving_tick(wp, page)
        cow, kv4 = cow_chunk(wp, page)
        axes = (-2, -1, -2, -1) if int8 else (-2, -2)
        local = [head_shard(x, ax, mesh) for x, ax in zip(pools, axes)]
        shapes = [("serving tick", pools, table, kv1, 1, None),
                  ("T=4 COW chunk", pools, cow, kv4, 4, None),
                  (f"head-local tp={TP} tick", local, table, kv1, 1, mesh)]
        for what, ps, tab, kvl, t, m in shapes:
            q = torch.randn((4, t, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
            if m is not None:
                q = head_shard(q, -2, m)
            ref = (decode_attn.paged_decode_attention_int8kv_ref if int8
                   else decode_attn.paged_decode_attention_ref)
            want = ref(q, *ps, tab, kvl, 0, mesh=m)
            mask = (torch.arange(wp * page, device="cuda")[None, :] < kvl[:, -1:])[:, None, None]
            causal = (torch.arange(wp * page, device="cuda")[None, None, :]
                      < kvl[:, :, None])[:, None]  # [B, 1, T, W]

            def library(i, ps=ps, tab=tab, q=q, t=t):
                l = i % n_layers
                if int8:
                    k = dequant(gather_kv_pages(ps[0][l], tab), gather_kv_pages(ps[1][l], tab))
                    v = dequant(gather_kv_pages(ps[2][l], tab), gather_kv_pages(ps[3][l], tab))
                else:
                    k, v = gather_kv_pages(ps[0][l], tab), gather_kv_pages(ps[1][l], tab)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask if t == 1 else causal)

            times: dict[str, list] = {}
            bh = 4 * h  # the full head count: the shipped plan of a mesh call too
            for rnd in range(3):
                for (kind, tile, stages, pdl), fn in fns.items():
                    if kind != "paged":
                        continue
                    n_tiles = wp * (page // math.gcd(page, tile))
                    for plan in plans:
                        n = n_splits(bh, n_tiles, plan)
                        sweep(times, f"t{tile}s{stages}p{pdl} {plan[0]}/{plan[1]} n{n}",
                              lambda i, fn=fn, n=n, ps=ps, tab=tab, kvl=kvl, q=q: launch_paged(
                                  fn, q, ps, tab, kvl, i % n_layers, n), want, rnd)
                times.setdefault("gather + SDPA", []).append(
                    time_ms(library, 20 if int8 else 30)[0])
            rows.append(report("paged", f"{kv} {what}", times))
    return rows


def report(kind: str, cell: str, times: dict) -> dict:
    best = {key: min(v) for key, v in times.items()}
    spread = {key: max(v) - min(v) for key, v in times.items()}
    print(f"{kind} {cell}: " + "; ".join(f"{key} {ms:.4f}" for key, ms in best.items()),
          flush=True)
    return {"kind": kind, "cell": cell, "ms": best, "spread_ms": spread}


def ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="dense,paged",
                    help="comma-separated kinds to sweep (dense, paged)")
    ap.add_argument("--tiles", type=ints, help="keys per tile (default: the kind's own list)")
    ap.add_argument("--stages", type=ints, default=[3, 4], help="ring slots")
    ap.add_argument("--pdl", type=ints, default=[1],
                    help="programmatic dependent launch off (0) and/or on (1)")
    ap.add_argument("--blocks", type=ints,
                    help="SPLIT_BLOCKS values swept beside the shipped plan")
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args()
    kinds = [k for k in args.kernels.split(",") if k]
    if not kinds or any(k not in KINDS for k in kinds):
        ap.error(f"--kernels takes a list of {sorted(KINDS)}")
    if not torch.cuda.is_available():
        print("torch_decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = gpu_line()
    print(f"card: {card}", flush=True)
    variants = {k: [(t, st, p) for t in (args.tiles or KINDS[k][2]) for st in args.stages
                    for p in args.pdl] for k in kinds}
    plans = {k: [SHIPPED] + [(b, SHIPPED[1]) for b in args.blocks] if args.blocks
             else KINDS[k][3] for k in kinds}
    fns = build(variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    if "dense" in kinds:
        rows += sweep_dense(fns, plans["dense"], gen)
    if "paged" in kinds:
        rows += sweep_paged(fns, plans["paged"], gen)
    if args.json:
        Path(args.json).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
