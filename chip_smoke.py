#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vtpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json PATH]

Phases, any failure exits nonzero:
1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel in vtpu_torch/csrc (one nvcc per source, all
   started together);
2. every kernel against its plain PyTorch version at its path's shapes
   plus ragged cases (flash also at S = 1 and 1000; the dense decode kernel
   also at a bucket below S and with every row's keys in its first split;
   the paged kernels at the serving tick and a ragged T=4 copy-on-write
   chunk over pages of 128, 16 and 48 keys, the null block poisoned), with
   kernel, plain and library times, their ratio, the least time the card
   could take for the same work, and each kernel's tile and split count;
   flash is timed at the serving shape and at a one-row admission, the
   dense decode kernel at the study's four T=1 cells; the paged kernels
   (bf16, int8) also on each tp=2 head shard, against their plain versions
   and, bit for bit, the head slice of the full-pool call;
3. the paths, each with every launch count set to 0 just before it and
   read just after:
   a. the main path: the flagship ModelConfig served by ServingEngine on a
      paged bf16 pool with the default ServingConfig loop (pipelined, its
      decode step replayed from CUDA graphs captured under
      set_sync_debug_mode("error")), six requests streamed, greedy streams
      checked against the port's plain trunk (use_kernels=False) under a
      logit-margin rule, launch counts showing both kernels ran (graph
      replays included: paged launches = 12 x decode ticks); then one more
      wave under torch.profiler for the device's busy share;
   b. the int8 serving path: the same model and wave with kv_int8=True,
      every decode tick through the int8 paged kernel, streams checked
      against the plain int8 trunk;
   c. the loop comparison: the same model with 128 new tokens a request,
      the wave served by the synchronous eager loop and by the pipelined
      loop on graphs, interleaved, three times each, bf16 and int8 KV:
      tokens/s, TTFT p50, host_ms_per_tick and the tick phases per loop
      with their spread, the device busy share of one profiled wave each,
      streams held against the plain trunk;
   d. the dense decode study: decode_attention over the study's four T=1
      cells in bf16 and in int8;
   e. tensor-parallel serving: two spawned ranks (NCCL, one card each,
      where there are two cards; else gloo, both on card 0) serve the
      main path's wave with bf16 and then int8 KV on the pipelined loop
      (eager: no graphs under a mesh), every decode tick through the
      head-local paged kernel on each rank, streams checked against the
      plain trunk of the same KV type; given four cards, four ranks over
      NCCL serve the same waves after them;
4. a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last line
   ``{"ok": true, "device": {...}}``.
Needs a CUDA device and the repo checkout; refuses to run without either.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# bf16 outputs: kernel and plain version both round P and the output to
# bf16 but sum in different orders, so a value near a rounding boundary
# may land one bf16 ulp apart (2^-6 ~ 1.6e-2 for |o| < 4)
ATOL = 2e-2
# a greedy step whose plain-trunk top-1/top-2 logit margin is below this
# may flip under bf16 rounding: the stream comparison stops there. The same
# margin holds for int8 KV: a K/V value that bf16 rounding moves across a
# quantization boundary changes one code of 127 (a 0.8% step of that
# head's absmax on one element), smaller than the bf16 noise already
# allowed for
MARGIN = 0.05
SEED = 0
# new tokens a request in the loop comparison, and its repeats per loop
COMPARE_TOKENS = 128
REPEATS = 3
# the flagship serving model of bench.py (bench_scale, TPU branch)
FLAGSHIP = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=12, d_ff=4096, max_seq=1280,
                head_dim=128)
# tensor-parallel ranks of the TP phases (the reference's tp=2 serving mesh)
TP = 2
# the dense decode study's cells (hack/decode_attn_bench.py): batch x window
STUDY_CELLS = ((8, 1024), (8, 2048), (32, 1024), (32, 2048))
STUDY_H, STUDY_DH = 8, 128
# bytes one timed input set should exceed so that calls cycling through the
# sets find their operands outside the 50 MB L2, as the trunk's layer walk does
COLD_BYTES = 150e6
# the H100's highest SM clock: a sleep of n * 1e6 * this many cycles lasts at
# least n ms
MAX_CLOCK_GHZ = 1.98


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2, hold: bool = True) -> tuple[float, float]:
    """(device ms, host ms) per call over ``iters`` calls. With ``hold`` the
    stream waits behind a device-side sleep while the host enqueues every
    call, so the CUDA events time the device work back to back rather than
    the host's Python between launches (the hold is sized from one steady
    call). The plain versions launch thousands of small ops per call,
    which would fill the launch queue during a hold: they are timed without
    one, host gaps included. The second number is the host's enqueue time
    per call."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # one steady call, device included, sizes the hold
    fn(0)
    torch.cuda.synchronize()
    hold_ms = max(200.0, 3e3 * (time.perf_counter() - t0) * iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(hold_ms * MAX_CLOCK_GHZ * 1e6))
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    if hold and host * iters > hold_ms:
        raise AssertionError(f"enqueue took {host * iters:.0f} ms, longer than the "
                             f"{hold_ms:.0f} ms hold: the device time would include host gaps")
    return start.elapsed_time(end) / iters, host


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_flash(gen, log) -> dict:
    """flash_attention against its plain version at the serving shape, a
    ragged S, one key and a long ragged S; then kernel, plain and library
    (SDPA causal) times at the serving shape [4, 1024, 8, 128] and at the
    one-row admission [1, 1024, 8, 128], each beside SDPA in this call. The
    entry's numbers are the serving shape's."""
    import torch.nn.functional as F

    from vtpu_torch.ops.attention import FLASH_BLOCK, flash_attention, flash_attention_ref

    errs = []
    for shape in [(4, 1024, 8, 128), (2, 200, 8, 128), (2, 1, 8, 128), (1, 1000, 8, 128)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = max_err(got, flash_attention_ref(q, k, v))
        log(f"flash_attention {shape} bf16: max_abs_err {err:.3e} (atol {ATOL})")
        if not (err <= ATOL and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
        errs.append(err)
    shapes = {}
    for b in (4, 1):
        # three input sets per shape (> the 50 MB L2 at batch 4)
        s, h, dh = 1024, 8, 128
        sets = [tuple(torch.randn((b, s, h, dh), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(3)) for _ in range(3)]
        ms, host = time_ms(lambda i: flash_attention(*sets[i % 3]), 30)
        plain, _ = time_ms(lambda i: flash_attention_ref(*sets[i % 3]), 3, warmup=1,
                           hold=False)
        lib, _ = time_ms(lambda i: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in sets[i % 3]), is_causal=True), 30)
        nbytes = 4 * b * s * h * dh * 2
        flops = 4 * b * h * dh * s * (s + 1) / 2
        bms, by = bound_ms(nbytes, flops)
        shapes[b] = {"shape": [b, s, h, dh], "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bms, "bound_by": by, "host_ms": host,
                     "tflops": flops / ms / 1e9}
        log(f"flash_attention [{b}, {s}, {h}, {dh}]: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.0f} TFLOP/s), SDPA {lib:.4f} ms (kernel/SDPA "
            f"{ms / lib:.2f}x), plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    top = shapes[4]
    return {"name": "flash_attention", "route": "cuda",
            "source": "vtpu_torch/csrc/flash_attention.cu",
            "replaces": "vtpu/ops/attention.py:210", "max_abs_err": max(errs),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "host_ms": top["host_ms"], "shapes": [shapes[4], shapes[1]],
            "tile": FLASH_BLOCK, "n_split": None}


def serving_tick(wp: int, page: int):
    """The page table and lengths of a decode tick at the serving shape: 4
    slots, prompts of 600..1024 plus generated tokens (every row ending
    inside a 32-key tile), private pages, null-padded rows. Returns (table
    [4, wp] int32, kv_len [4, 1] int32, the lengths)."""
    table = torch.zeros((4, wp), dtype=torch.int32, device="cuda")
    lens1 = [1040, 700, 613, 1024]
    nxt = 1
    for r, ln in enumerate(lens1):
        n = -(-ln // page)
        table[r, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    kv1 = torch.tensor(lens1, dtype=torch.int32, device="cuda")[:, None].contiguous()
    return table, kv1, lens1


def cow_chunk(wp: int, page: int):
    """A verify-shaped chunk: T = 4, ragged lengths (5-8 keys in one row,
    ~1000 in another, so most of a row's splits are empty), rows 0 and 1
    sharing their leading (prefix) pages and diverging at a copied boundary
    page. Returns (table [4, wp] int32, kv_len [4, 4] int32)."""
    lens = [[300, 301, 302, 303], [290, 291, 292, 293], [5, 6, 7, 8], [1000, 1001, 1002, 1003]]
    n = [-(-row[-1] // page) for row in lens]
    shared = min(n[0], n[1]) - 1
    rows = [list(range(1, n[0] + 1))]
    nxt = n[0] + 1
    rows.append(rows[0][:shared] + list(range(nxt, nxt + n[1] - shared)))
    nxt += n[1] - shared
    for k in n[2:]:
        rows.append(list(range(nxt, nxt + k)))
        nxt += k
    table = torch.zeros((4, wp), dtype=torch.int32, device="cuda")
    for r, ids in enumerate(rows):
        table[r, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return table, torch.tensor(lens, dtype=torch.int32, device="cuda")


# pages the paged kernels are held at besides the serving pool's 128: one
# 16-key tile a page, and three (48 is no multiple of the 32-key tile)
EDGE_PAGES = (16, 48)


def paged_pools(gen, n_layers: int, page: int, h: int, int8: bool) -> tuple[list, int]:
    """Pools of the serving pool's size in tokens (41 blocks of 128) for
    ``page``: [k, v] bf16, or [kq, k_scale, vq, v_scale] for int8, every
    plane's null block holding garbage that must never be observed; and the
    window in pages (max_seq 1280)."""
    wp = -(-FLAGSHIP["max_seq"] // page)
    shape = (n_layers, -(-41 * 128 // page), page, h, 128)
    if int8:
        pools = [rand_int8(gen, shape), rand_scales(gen, shape[:4]),
                 rand_int8(gen, shape), rand_scales(gen, shape[:4])]
        for x, val in zip(pools, (127, 1e3, -127, 1e3)):
            x[:, 0] = val
    else:
        pools = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2)]
        pools[0][:, 0], pools[1][:, 0] = 1e3, -1e3
    return pools, wp


def check_paged(gen, log, int8: bool) -> dict:
    """The paged kernel (bf16, or int8 with scale pools) against its plain
    version at the serving tick and the ragged copy-on-write chunk, on the
    serving pool (page 128, first and last plane) and on pools of pages 16
    and 48, the null block poisoned in each; then kernel, plain and library
    (gather + SDPA) times at the serving tick."""
    import torch.nn.functional as F

    from vtpu_torch.ops.attention import gather_kv_pages
    from vtpu_torch.ops.decode_attn import (
        paged_decode_attention, paged_decode_attention_int8kv,
        paged_decode_attention_int8kv_ref, paged_decode_attention_ref, paged_split_plan,
        paged_tile,
    )

    if int8:
        name, fn, ref = ("paged_decode_attention_int8kv", paged_decode_attention_int8kv,
                         paged_decode_attention_int8kv_ref)
    else:
        name, fn, ref = "paged_decode_attention", paged_decode_attention, \
            paged_decode_attention_ref
    n_layers, page, h, dh = 12, 128, 8, 128
    errs = []
    for pg in (page,) + EDGE_PAGES:
        pools, wp = paged_pools(gen, n_layers if pg == page else 2, pg, h, int8)
        (table, kv1, _), (cow, kv4) = serving_tick(wp, pg), cow_chunk(wp, pg)
        for tab, kvl, what in [(table, kv1, "T=1 tick"), (cow, kv4, "T=4 ragged COW")]:
            q = torch.randn((4, kvl.shape[1], h, dh), generator=gen, device="cuda").to(
                torch.bfloat16)
            for layer in (0, pools[0].shape[0] - 1):
                got = fn(q, *pools, tab, kvl, layer)
                torch.cuda.synchronize()
                err = max_err(got, ref(q, *pools, tab, kvl, layer))
                log(f"{name} page {pg} {what} layer {layer} ({paged_split_plan(4, h, wp, pg)} "
                    f"splits of {paged_tile(pg)}-key tiles): max_abs_err {err:.3e} "
                    f"(atol {ATOL})")
                if not (err <= ATOL and bool(torch.isfinite(got.float()).all())):
                    raise AssertionError(f"{name} disagrees with its plain version: {err}")
                errs.append(err)
        if pg == page:
            serving = pools, wp, table, kv1
    # timing: one decode tick's call per layer, cycling the 12 planes so
    # consecutive calls read different pool memory, as the trunk does
    pools, wp, table, kv1 = serving
    q1 = torch.randn((4, 1, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
    ms, host = time_ms(lambda i: fn(q1, *pools, table, kv1, i % n_layers), 60)
    plain, _ = time_ms(lambda i: ref(q1, *pools, table, kv1, i % n_layers), 12, hold=False)
    mask = (torch.arange(wp * page, device="cuda")[None, :] < kv1)[:, None, None]  # [B,1,1,W]

    def library(i):
        l = i % n_layers
        if int8:
            k = dequant(gather_kv_pages(pools[0][l], table), gather_kv_pages(pools[1][l], table))
            v = dequant(gather_kv_pages(pools[2][l], table), gather_kv_pages(pools[3][l], table))
        else:
            k, v = gather_kv_pages(pools[0][l], table), gather_kv_pages(pools[1][l], table)
        return F.scaled_dot_product_attention(q1.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask)

    # int8: ~12 small ops per call, fewer calls, so the held launch queue never fills
    lib, _ = time_ms(library, 20 if int8 else 60)
    keys = int(kv1.sum())
    per_key = h * dh * 2 * (1 if int8 else 2) + (h * 4 * 2 if int8 else 0)
    nbytes = keys * per_key + 2 * q1.numel() * 2 + table.numel() * 4 + kv1.numel() * 4
    bms, by = bound_ms(nbytes, 4 * keys * h * dh)
    return {"name": name, "route": "cuda", "source": "vtpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "vtpu/ops/decode_attn.py:435" if int8 else "vtpu/ops/decode_attn.py:347",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": lib, "host_ms": host,
            "tile": paged_tile(page), "n_split": paged_split_plan(4, h, wp, page)}


def rand_int8(gen, shape) -> torch.Tensor:
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def rand_scales(gen, shape) -> torch.Tensor:
    # the study's range, [1e-3, 2.1e-2] (hack/decode_attn_bench.py)
    return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3


def dequant(xq: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return (xq.float() * sc[..., None]).to(torch.bfloat16)


def check_paged_tp(gen, log, int8: bool) -> dict:
    """Row 4, the paged kernel on one rank's head shard (the reference's
    ``_shard_body``), in one process: the pools of check_paged (bf16, or
    int8 with scale pools; pages 128, 16 and 48) and q split on heads into
    TP head shards; each shard's call with a mesh, at the serving tick and
    the ragged copy-on-write chunk, against its plain version (within ATOL)
    and against the head slice of the full-pool call (a mesh call takes the
    split plan of the full head count, so the two must be bitwise equal);
    then kernel, plain and library times at the head-local serving tick."""
    import torch.nn.functional as F

    from vtpu_torch.ops.attention import gather_kv_pages
    from vtpu_torch.ops.decode_attn import (
        paged_decode_attention, paged_decode_attention_int8kv,
        paged_decode_attention_int8kv_ref, paged_decode_attention_ref, paged_split_plan,
        paged_tile,
    )
    from vtpu_torch.parallel import TpMesh, head_shard

    if int8:
        name, fn, ref = ("paged_decode_attention_int8kv_tp", paged_decode_attention_int8kv,
                         paged_decode_attention_int8kv_ref)
        axes = (-2, -1, -2, -1)
    else:
        name, fn, ref = "paged_decode_attention_tp", paged_decode_attention, \
            paged_decode_attention_ref
        axes = (-2, -2)
    n_layers, page, h, dh = 12, 128, 8, 128
    meshes = [TpMesh(rank=r, size=TP, device=torch.device("cuda")) for r in range(TP)]
    errs, diffs = [], []
    for pg in (page,) + EDGE_PAGES:
        pools, wp = paged_pools(gen, n_layers if pg == page else 2, pg, h, int8)
        shards = [[head_shard(x, ax, m) for x, ax in zip(pools, axes)] for m in meshes]
        (table, kv1, _), (cow, kv4) = serving_tick(wp, pg), cow_chunk(wp, pg)
        for tab, kvl, what in [(table, kv1, "T=1 tick"), (cow, kv4, "T=4 ragged COW")]:
            q = torch.randn((4, kvl.shape[1], h, dh), generator=gen, device="cuda").to(
                torch.bfloat16)
            for layer in (0, pools[0].shape[0] - 1):
                whole = fn(q, *pools, tab, kvl, layer)
                for m, ps in zip(meshes, shards):
                    qs = head_shard(q, -2, m)
                    got = fn(qs, *ps, tab, kvl, layer, mesh=m)
                    torch.cuda.synchronize()
                    err = max_err(got, ref(qs, *ps, tab, kvl, layer, mesh=m))
                    diff = max_err(got, head_shard(whole, -2, m))
                    log(f"{name} page {pg} {what} rank {m.rank} of {TP} layer {layer}: "
                        f"max_abs_err {err:.3e} (atol {ATOL}), max diff from the full-pool "
                        f"call's head slice {diff:.3e} (must be 0)")
                    if not (err <= ATOL and diff == 0
                            and bool(torch.isfinite(got.float()).all())):
                        raise AssertionError(f"{name} disagrees: {err} against its plain "
                                             f"version, {diff} against the full-pool call")
                    errs.append(err)
                    diffs.append(diff)
        if pg == page:
            serving = shards[0], wp, table, kv1
    ps, wp, table, kv1 = serving
    q = head_shard(torch.randn((4, 1, h, dh), generator=gen, device="cuda").to(torch.bfloat16),
                   -2, meshes[0])
    ms, host = time_ms(lambda i: fn(q, *ps, table, kv1, i % n_layers, mesh=meshes[0]), 60)
    plain, _ = time_ms(lambda i: ref(q, *ps, table, kv1, i % n_layers, mesh=meshes[0]), 12,
                       hold=False)
    mask = (torch.arange(wp * page, device="cuda")[None, :] < kv1)[:, None, None]

    def library(i):
        l = i % n_layers
        if int8:
            k = dequant(gather_kv_pages(ps[0][l], table), gather_kv_pages(ps[1][l], table))
            v = dequant(gather_kv_pages(ps[2][l], table), gather_kv_pages(ps[3][l], table))
        else:
            k, v = gather_kv_pages(ps[0][l], table), gather_kv_pages(ps[1][l], table)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask)

    lib, _ = time_ms(library, 20 if int8 else 60)
    keys, hl = int(kv1.sum()), h // TP
    per_key = hl * dh * 2 * (1 if int8 else 2) + (hl * 4 * 2 if int8 else 0)
    nbytes = keys * per_key + 2 * q.numel() * 2 + table.numel() * 4 + kv1.numel() * 4
    bms, by = bound_ms(nbytes, 4 * keys * hl * dh)
    return {"name": name, "route": "cuda",
            "source": "vtpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "vtpu/ops/decode_attn.py:559", "max_abs_err": max(errs),
            "max_diff_from_full_pool": max(diffs), "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib, "host_ms": host,
            "tile": paged_tile(page), "n_split": paged_split_plan(4, h, wp, page)}


def study_inputs(gen, b: int, s: int, t: int, int8: bool, copies: int = 1) -> list[dict]:
    """``copies`` input sets of one study cell, made as
    hack/decode_attn_bench.py makes them: q (and bf16 k/v) standard normal,
    int8 k/v uniform in +-127 with scales in [1e-3, 2.1e-2], row lengths
    uniform in [S/2, S] (+ i for query i, at most S)."""
    h, dh = STUDY_H, STUDY_DH
    lens = torch.randint(s // 2, s + 1, (b, 1), generator=gen, device="cuda")
    lens = torch.clamp(lens + torch.arange(t, device="cuda")[None, :], max=s).to(torch.int32)
    base = {"q": torch.randn((b, t, h, dh), generator=gen, device="cuda").to(torch.bfloat16),
            "kv_len": lens.contiguous()}
    if int8:
        base.update(k=rand_int8(gen, (b, s, h, dh)), v=rand_int8(gen, (b, s, h, dh)),
                    k_scale=rand_scales(gen, (b, s, h)), v_scale=rand_scales(gen, (b, s, h)))
    else:
        base.update({key: torch.randn((b, s, h, dh), generator=gen, device="cuda")
                     .to(torch.bfloat16) for key in ("k", "v")})
    return [base] + [{key: x.clone() for key, x in base.items()} for _ in range(copies - 1)]


def check_decode(gen, log, int8: bool) -> dict:
    """decode_attention (bf16, or int8 with scales) against its plain version
    at one T=1 cell, one ragged T=4 case and one bucket < S case (garbage past
    the bucket); then kernel, plain and library times at the study's four
    T=1 cells. The entry's numbers are the (32, 2048) cell's."""
    import torch.nn.functional as F

    from vtpu_torch.ops.decode_attn import (
        DENSE_TILE, decode_attention, decode_attention_ref, dense_split_plan,
    )

    name = "decode_attention_int8kv" if int8 else "decode_attention"
    cases = [("T=1 (8, 1024)", study_inputs(gen, 8, 1024, 1, int8)[0], 0),
             ("T=4 ragged (4, 512)", study_inputs(gen, 4, 512, 4, int8)[0], 0)]
    bounded = study_inputs(gen, 4, 2048, 1, int8)[0]
    bounded["kv_len"] = torch.tensor([[700], [1024], [2048], [300]], dtype=torch.int32,
                                     device="cuda")
    garbage = ({"k": 127, "v": -127, "k_scale": 1e3, "v_scale": 1e3} if int8
               else {"k": 1e3, "v": -1e3})
    for key, val in garbage.items():  # past the bucket: never read
        bounded[key][:, 1024:] = val
    cases.append(("bucket 1024 < S 2048", bounded, 1024))
    # every row's keys in the first of the splits: the later splits are empty
    first = study_inputs(gen, 8, 2048, 1, int8)[0]
    first["kv_len"] = torch.tensor([[60], [1], [128], [100], [5], [64], [65], [127]],
                                   dtype=torch.int32, device="cuda")
    cases.append((f"first split only ({dense_split_plan(8, STUDY_H, 2048)} splits)", first, 0))
    errs = []
    for what, x, bucket in cases:
        got = decode_attention(**x, bucket=bucket)
        torch.cuda.synchronize()
        err = max_err(got, decode_attention_ref(**x, bucket=bucket))
        log(f"{name} {what}: max_abs_err {err:.3e} (atol {ATOL})")
        if not (err <= ATOL and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
        errs.append(err)
    cells = []
    for b, s in STUDY_CELLS:
        per_set = b * s * STUDY_H * STUDY_DH * (1 if int8 else 2) * 2
        sets = study_inputs(gen, b, s, 1, int8, copies=max(1, -(-int(COLD_BYTES) // per_set)))
        x0 = sets[0]
        ms, host = time_ms(lambda i: decode_attention(**sets[i % len(sets)]), 30)
        plain, _ = time_ms(lambda i: decode_attention_ref(**sets[i % len(sets)]), 3, warmup=1,
                           hold=False)
        mask = (torch.arange(s, device="cuda")[None, :] < x0["kv_len"])[:, None, None]

        def library(i):
            x = sets[i % len(sets)]
            k, v = ((dequant(x[key], x[f"{key}_scale"]) if int8 else x[key]) for key in "kv")
            return F.scaled_dot_product_attention(x["q"].transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask)

        lib, _ = time_ms(library, 30)
        keys = int(x0["kv_len"].sum())
        per_key = STUDY_H * STUDY_DH * (1 if int8 else 2) * 2 + (STUDY_H * 4 * 2 if int8 else 0)
        nbytes = keys * per_key + 2 * x0["q"].numel() * 2 + x0["kv_len"].numel() * 4
        bms, by = bound_ms(nbytes, 4 * keys * STUDY_H * STUDY_DH)
        cells.append({"batch": b, "window": s, "ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": bms, "bound_by": by, "host_ms": host})
        log(f"{name} cell (batch {b}, window {s}, {dense_split_plan(b, STUDY_H, s)} splits): "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms (kernel/library "
            f"{ms / lib:.2f}x), bound {bms:.4f} ms ({by})")
    top = cells[-1]
    return {"name": name, "route": "cuda", "source": "vtpu_torch/csrc/decode_attention.cu",
            "replaces": "vtpu/ops/decode_attn.py:315" if int8 else "vtpu/ops/decode_attn.py:196",
            "max_abs_err": max(errs), "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "host_ms": top["host_ms"], "cells": cells,
            "tile": DENSE_TILE, "n_split": dense_split_plan(top["batch"], STUDY_H, top["window"])}


def study_path(gen, log) -> dict:
    """The dense decode study as a user drives it: decode_attention once per
    T=1 study cell in bf16 and in int8, with every launch count set to 0
    just before and read just after; outputs finite and of q's shape."""
    from vtpu_torch.ops import _build
    from vtpu_torch.ops.decode_attn import decode_attention

    inputs = [study_inputs(gen, b, s, 1, int8)[0] for int8 in (False, True)
              for b, s in STUDY_CELLS]
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [decode_attention(**x) for x in inputs]
    torch.cuda.synchronize()
    launches = _build.launches()
    for x, out in zip(inputs, outs):
        if out.shape != x["q"].shape or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"decode_attention gave {tuple(out.shape)} or non-finite "
                                 f"values for q {tuple(x['q'].shape)}")
    n = len(STUDY_CELLS)
    if launches["decode_attention"] != n or launches["decode_attention_int8kv"] != n:
        raise AssertionError(f"the study path launched {launches}, expected {n} of each "
                             "dense decode kernel")
    log(f"study path: {len(inputs)} decode_attention calls; launches {launches}")
    return {"launches": launches}


def reference_stream(params, cfg, prompt: np.ndarray, steps: int):
    """Greedy stream of the port's plain trunk with each step's top-1/top-2
    logit margin."""
    from vtpu_torch.models import decode_step, prefill

    toks = torch.from_numpy(prompt[None]).cuda()
    logits, cache = prefill(params, cfg, toks)
    row = logits[0, -1]
    out, margins = [], []
    for i in range(steps):
        if not bool(torch.isfinite(row).all()):
            raise AssertionError("plain trunk produced non-finite logits")
        top = torch.topk(row, 2).values
        margins.append(float(top[0] - top[1]))
        out.append(int(torch.argmax(row)))
        if i + 1 < steps:
            logits, cache = decode_step(
                params, cfg, cache, torch.tensor([out[-1]], dtype=torch.int32, device="cuda"))
            row = logits[0]
    return out, margins


def wave_prompts(vocab: int) -> list[np.ndarray]:
    """The serving wave: six prompts of 600-1024 tokens from SEED."""
    rs = np.random.RandomState(SEED)
    return [rs.randint(0, vocab, (int(n),)).astype(np.int32) for n in rs.randint(600, 1025, 6)]


def check_streams(streams: list, refs: list, what: str) -> tuple[int, int]:
    """Each stream against its plain-trunk reference (tokens, margins) up to
    the first step whose top-1/top-2 margin is below MARGIN. Returns (tokens
    compared equal, streams cut at a small margin); a mismatch raises."""
    compared = ties = 0
    for toks, (ref, margins) in zip(streams, refs):
        for i, (got, want) in enumerate(zip(toks, ref)):
            if margins[i] < MARGIN:
                ties += 1
                break
            if got != want:
                raise AssertionError(
                    f"{what} stream {toks} differs from the plain trunk {ref} "
                    f"at step {i} (margin {margins[i]:.3f})")
            compared += 1
    return compared, ties


def stream_all(eng, prompts) -> tuple[list[dict], float]:
    """Submit every prompt at once; a reader thread per request records its
    tokens and first-token time. Returns (records, wall seconds)."""
    recs = [{"toks": []} for _ in prompts]

    def read(req, rec):
        for tok in req.stream():
            rec.setdefault("first", time.perf_counter())
            rec["toks"].append(tok)
        rec["status"] = req.status

    t0 = time.perf_counter()
    threads = []
    for prompt, rec in zip(prompts, recs):
        rec["submit"] = time.perf_counter()
        req = eng.submit(prompt)
        th = threading.Thread(target=read, args=(req, rec), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a stream did not finish within 600 s")
    return recs, time.perf_counter() - t0


def profile_wave(eng, prompts) -> dict | None:
    """Stream one more wave under torch.profiler: the device's busy share of
    the wave's wall time and device time by kernel name. None when the
    profiler recorded no device activity. The profiler slows the host, so
    the idle share it shows is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = stream_all(eng, prompts)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            # the template arguments name a walk's tile source: keep them
            name = evt.name.replace("(anonymous namespace)::", "")[:80]
            by_name[name] = by_name.get(name, 0.0) + evt.time_range.elapsed_us()
    if not by_name:
        return None
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "top_kernels_ms": [[name, us / 1e3] for name, us in top]}


def serving_path(log, card: str, params, kv_int8: bool) -> dict:
    """Serve six requests on the flagship model over a paged pool, bf16 or
    int8 KV, on the default ServingConfig loop (pipelined, on CUDA graphs),
    with every launch count set to 0 just before the counted wave and read
    just after. The bf16 run (the main path) streams one more wave under
    the profiler. The plain trunk's references run COMPARE_TOKENS steps, so
    the loop comparison and the TP paths reuse them."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import ServingConfig, ServingEngine

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True, kv_int8=kv_int8)
    what = "int8 serving path" if kv_int8 else "main path"
    paged, other = "paged_decode_attention_int8kv", "paged_decode_attention"
    if not kv_int8:
        paged, other = other, paged
    new_tokens = 16
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(1024,), max_new_tokens=new_tokens, kv_page=128))
    graphs = eng.decode_graphs
    if graphs is None or not eng.stats()["pipelined"]:
        raise AssertionError(f"the {what} does not run the pipelined loop on CUDA graphs")
    log(f"{what}: {len(graphs.keys())} decode graphs captured under "
        f"set_sync_debug_mode('error') (kv bucket, route, KV type): {graphs.keys()}")
    prompts = wave_prompts(cfg.vocab)
    eng.start()
    try:
        # warm-up request: CUDA/cuBLAS initialisation stays out of the run
        stream_all(eng, [prompts[0]])
        base = eng.stats()
        replays = graphs.replays
        _build.reset_launches()
        recs, wall = stream_all(eng, prompts)
        launches = _build.launches()
        after = eng.stats()
        replays = graphs.replays - replays
        prof = None if kv_int8 else profile_wave(eng, prompts)
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise AssertionError(f"serving loop failed: {eng.loop_error!r}")
    ticks = after["decode_ticks"] - base["decode_ticks"]
    pipelined = after["pipelined_ticks"] - base["pipelined_ticks"]
    fetches = after["tick_fetches"] - base["tick_fetches"]
    gets_per_tick = fetches / ticks if ticks else None
    for rec in recs:
        if rec.get("status") != "OK" or len(rec["toks"]) != new_tokens:
            raise AssertionError(f"stream ended {rec.get('status')} after "
                                 f"{len(rec['toks'])} of {new_tokens} tokens")
    if gets_per_tick != 1.0:
        raise AssertionError(f"device_gets_per_tick {gets_per_tick} != 1.0")
    if replays != ticks or pipelined <= 0:
        raise AssertionError(f"{ticks} decode ticks but {replays} graph replays and "
                             f"{pipelined} pipelined ticks")
    if launches["flash_attention"] <= 0:
        raise AssertionError(f"the {what} launched no flash_attention kernel")
    if launches[paged] != cfg.n_layers * ticks or launches[other] != 0:
        raise AssertionError(
            f"{paged} launched {launches[paged]} times over {ticks} decode ticks, "
            f"expected {cfg.n_layers} per tick, and {other} {launches[other]} times, "
            "expected none")
    if after["kv_pool_free"] != after["kv_pool_blocks"]:
        raise AssertionError("paged pool not fully free after the run")

    plain_cfg = dataclasses.replace(cfg, use_kernels=False)  # kv_int8 kept
    refs = [reference_stream(params, plain_cfg, prompt, COMPARE_TOKENS) for prompt in prompts]
    compared, ties = check_streams([rec["toks"] for rec in recs], refs, "engine")
    ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
    total = sum(len(rec["toks"]) for rec in recs)
    log(f"{what} on {card}: {len(prompts)} requests, {total} tokens in {wall:.3f} s "
        f"({total / wall:.1f} tokens/s), TTFT p50 {ttft[len(ttft) // 2]:.1f} ms "
        f"max {ttft[-1]:.1f} ms; decode ticks {ticks} ({pipelined} pipelined, {replays} "
        f"graph replays), device_gets_per_tick {gets_per_tick}; launches {launches}")
    log(f"{what} streams vs plain {'int8 ' if kv_int8 else ''}trunk: {compared} tokens "
        f"compared equal, {ties} streams cut at a top-1/top-2 margin < {MARGIN}")
    if prof is None and not kv_int8:
        log("profiled wave: the profiler recorded no device activity (not measured)")
    elif prof is not None:
        log(f"profiled wave on {card}: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_busy_ms']:.1f} ms ({100 * prof['device_busy_share']:.1f}%); "
            "by kernel: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in prof["top_kernels_ms"]))
    return {"launches": launches, "decode_ticks": ticks, "pipelined_ticks": pipelined,
            "graph_replays": replays, "tokens": total,
            "wall_s": wall, "tokens_per_s": total / wall, "ttft_ms": ttft,
            "device_gets_per_tick": gets_per_tick, "compared_tokens": compared,
            "margin_cuts": ties,
            "prefill_batch_hist": after["prefill_batch_hist"],
            "kv_bucket_hist": after["kv_bucket_hist"],
            "tick_phase_ms": after["tick_phase_ms"],
            "paged_attn_kernel_ticks": after["paged_attn_kernel_ticks"]
            - base["paged_attn_kernel_ticks"], "profiled_wave": prof, "refs": refs}


PHASES = ("admission", "dispatch", "fetch", "deliver")


def measured_wave(eng, prompts, refs, what: str) -> dict:
    """One wave of the loop comparison: its streams held against the plain
    trunk, and its figures from the engine's own counters (the tick phases
    as this wave's mean ms per sample, from the profiler's totals)."""
    before = eng.stats()
    recs, wall = stream_all(eng, prompts)
    after = eng.stats()
    for rec in recs:
        if rec.get("status") != "OK" or len(rec["toks"]) != COMPARE_TOKENS:
            raise AssertionError(f"{what}: a stream ended {rec.get('status')} after "
                                 f"{len(rec['toks'])} of {COMPARE_TOKENS} tokens")
    compared, ties = check_streams([rec["toks"] for rec in recs], refs, what)
    phases = {}
    for p in PHASES:
        a, b = after["tick_phase_ms"][p], before["tick_phase_ms"][p]
        n = a["count"] - b["count"]
        phases[p] = (a["total_ms"] - b["total_ms"]) / n if n else 0.0
    ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
    total = sum(len(rec["toks"]) for rec in recs)
    ticks = after["decode_ticks"] - before["decode_ticks"]
    return {"tokens_per_s": total / wall, "ttft_p50_ms": ttft[len(ttft) // 2],
            "host_ms_per_tick": after["host_ms_per_tick"], "phase_ms": phases,
            "wall_s": wall, "decode_ticks": ticks,
            "pipelined_ticks": after["pipelined_ticks"] - before["pipelined_ticks"],
            "gets_per_tick": (after["tick_fetches"] - before["tick_fetches"]) / ticks,
            "compared_tokens": compared, "margin_cuts": ties}


def spread(vals: list) -> str:
    vals = sorted(vals)
    return f"{vals[len(vals) // 2]:.3f} [{vals[0]:.3f}, {vals[-1]:.3f}]"


def loop_comparison(log, card: str, params, kv_int8: bool, refs: list) -> dict:
    """The flagship wave at COMPARE_TOKENS new tokens a request, served by
    the synchronous eager loop and by the pipelined loop on graphs,
    interleaved REPEATS times each (one engine per loop, both warmed by one
    request); then one profiled wave per loop. Streams are held against
    the plain trunk (``refs``) under the margin rule."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.serving import ServingConfig, ServingEngine

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True, kv_int8=kv_int8)
    kv = "int8" if kv_int8 else "bf16"
    serving = ServingConfig(slots=4, prefill_buckets=(1024,), kv_page=128,
                            max_new_tokens=COMPARE_TOKENS)
    engines = {"sync": ServingEngine(params, cfg, dataclasses.replace(
                   serving, pipeline_decode=False)),
               "pipelined": ServingEngine(params, cfg, serving)}
    if engines["sync"].decode_graphs is not None or engines["pipelined"].decode_graphs is None:
        raise AssertionError("the synchronous loop must run eagerly and the pipelined "
                             "loop on graphs")
    prompts = wave_prompts(cfg.vocab)
    waves: dict = {name: [] for name in engines}
    profiles = {}
    for eng in engines.values():
        eng.start()
    try:
        for eng in engines.values():
            stream_all(eng, [prompts[0]])
        for r in range(REPEATS):
            for name in (("sync", "pipelined") if r % 2 == 0 else ("pipelined", "sync")):
                waves[name].append(measured_wave(engines[name], prompts, refs,
                                                 f"{kv} {name} loop"))
        for name, eng in engines.items():
            profiles[name] = profile_wave(eng, prompts)
    finally:
        for eng in engines.values():
            eng.stop()
    out = {}
    for name, eng in engines.items():
        if eng.loop_error is not None:
            raise AssertionError(f"{kv} {name} loop failed: {eng.loop_error!r}")
        ws, prof = waves[name], profiles[name]
        if any(w["gets_per_tick"] != 1.0 for w in ws):
            raise AssertionError(f"{kv} {name} loop: device_gets_per_tick != 1.0")
        if name == "pipelined" and any(w["pipelined_ticks"] <= 0 for w in ws):
            raise AssertionError(f"{kv} pipelined loop dispatched no tick ahead")
        # the profiler slows the host, so its wave's wall time overstates
        # the idle share; its device time over the median unprofiled wave's
        # wall is the other end of the range
        wall_ms = sorted(w["wall_s"] for w in ws)[len(ws) // 2] * 1e3
        busy = ("not measured" if prof is None else
                f"{100 * prof['device_busy_share']:.1f}% ({prof['device_busy_ms']:.1f} of "
                f"{prof['wall_ms']:.1f} ms), {100 * prof['device_busy_ms'] / wall_ms:.1f}% of "
                f"the median unprofiled wave's {wall_ms:.1f} ms")
        log(f"loop comparison {kv} {name} on {card}, {REPEATS} waves of {len(prompts)} x "
            f"{COMPARE_TOKENS} tokens, median [min, max]: tokens/s "
            f"{spread([w['tokens_per_s'] for w in ws])}; TTFT p50 ms "
            f"{spread([w['ttft_p50_ms'] for w in ws])}; host_ms_per_tick "
            f"{spread([w['host_ms_per_tick'] for w in ws])}; phase ms/sample "
            + ", ".join(f"{p} {spread([w['phase_ms'][p] for w in ws])}" for p in PHASES)
            + f"; decode ticks {[w['decode_ticks'] for w in ws]} (pipelined "
            f"{[w['pipelined_ticks'] for w in ws]}); profiled wave device busy {busy}; "
            f"streams: {sum(w['compared_tokens'] for w in ws)} tokens equal to the plain "
            f"trunk, {sum(w['margin_cuts'] for w in ws)} cut at a margin < {MARGIN}")
        if prof is not None:
            log(f"loop comparison {kv} {name} profiled wave by kernel: " + "; ".join(
                f"{n} {ms:.2f} ms" for n, ms in prof["top_kernels_ms"]))
        out[name] = {"waves": ws, "profiled_wave": prof}
    return out


def tp_serving_paths(log, card: str, refs: dict, tp: int = TP) -> dict:
    """Tensor-parallel serving: ``tp`` ranks, spawned, serve the main path's
    wave on the flagship model, once with bf16 and once with int8 KV, each
    after a warm-up request served by an engine of its own. Every launch
    count is set to 0 on every rank just before the counted wave and read
    just after; the counts of every rank come back to this process. Streams are held against the single-card plain
    trunk of the same KV type (``refs``, from serving_path). The kernels
    were built by this process before: the ranks only load them."""
    import tempfile

    from vtpu_torch.models import ModelConfig
    from vtpu_torch.parallel.launch import launch_tp, serve_requests
    from vtpu_torch.serving import ServingConfig

    if torch.cuda.device_count() >= tp:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(tp)]
        how = f"{tp} ranks on {tp} cards over nccl"
    else:
        backend, devices = "gloo", ["cuda:0"] * tp
        how = (f"{tp} ranks sharing one card over gloo (collectives staged through "
               "host memory: a check of the sharding, not a TP speed figure)")
    log(f"tensor-parallel serving: {how}")
    new_tokens = 16
    serving = ServingConfig(slots=4, prefill_buckets=(1024,), max_new_tokens=new_tokens,
                            kv_page=128)
    cfgs = {kv: ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True,
                            kv_int8=kv == "int8") for kv in ("bf16", "int8")}
    prompts = wave_prompts(FLAGSHIP["vocab"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch_tp(serve_requests, tp, backend, devices, f"file://{tmp}/store",
                          args=(SEED, [(cfgs[kv], serving) for kv in cfgs], prompts,
                                new_tokens, True), timeout=600)
    log(f"tensor-parallel world: {time.perf_counter() - t0:.1f} s wall, start-up included")
    heads = FLAGSHIP["n_heads"] // tp
    pool = [FLAGSHIP["n_layers"], 41, 128, heads, FLAGSHIP["head_dim"]]
    out = {}
    for i, kv in enumerate(cfgs):
        lead = ranks[0][i]
        st = lead["stats"]
        ticks = st["decode_ticks"]
        tp_name = ("paged_decode_attention_int8kv_tp" if kv == "int8"
                   else "paged_decode_attention_tp")
        other_tp = ("paged_decode_attention_tp" if kv == "int8"
                    else "paged_decode_attention_int8kv_tp")
        for toks, status in zip(lead["streams"], lead["statuses"]):
            if status != "OK" or len(toks) != new_tokens:
                raise AssertionError(f"tp={tp} {kv} stream ended {status} after {len(toks)} of "
                                     f"{new_tokens} tokens")
        if st["device_gets_per_tick"] != 1.0 or st["tp"] != tp or st["pipelined_ticks"] <= 0:
            raise AssertionError(f"tp={tp} {kv}: device_gets_per_tick "
                                 f"{st['device_gets_per_tick']}, tp {st['tp']}, pipelined "
                                 f"ticks {st['pipelined_ticks']}")
        if st["kv_pool_free"] != st["kv_pool_blocks"]:
            raise AssertionError(f"tp={tp} {kv}: paged pool not fully free after the run")
        for rank, res in enumerate(r[i] for r in ranks):
            got = res["launches"]
            if (got[tp_name] != FLAGSHIP["n_layers"] * ticks or got[other_tp] != 0
                    or got["paged_decode_attention"] != 0
                    or got["paged_decode_attention_int8kv"] != 0
                    or got["flash_attention"] <= 0 or res["kv_shape"] != pool):
                raise AssertionError(
                    f"tp={tp} {kv} rank {rank}: launches {got} over {ticks} decode ticks "
                    f"(expected {FLAGSHIP['n_layers']} {tp_name} per tick, no single-device "
                    f"paged launch, flash > 0), KV plane {res['kv_shape']} (expected {pool})")
        compared, ties = check_streams(lead["streams"], refs[kv], f"tp={tp} {kv}")
        total = sum(len(t) for t in lead["streams"])
        log(f"tp={tp} {kv} serving on {card} ({how}): {len(prompts)} requests, {total} tokens in "
            f"{lead['wall_s']:.3f} s ({total / lead['wall_s']:.1f} tokens/s); decode ticks "
            f"{ticks} ({st['pipelined_ticks']} pipelined, eager); per rank {tp_name} "
            f"{[r[i]['launches'][tp_name] for r in ranks]}, KV plane {pool}")
        log(f"tp={tp} {kv} streams vs plain {kv} trunk: {compared} tokens compared equal, "
            f"{ties} streams cut at a top-1/top-2 margin < {MARGIN}")
        out[kv] = {"backend": backend, "devices": devices, "ranks": [r[i] for r in ranks],
                   "decode_ticks": ticks, "pipelined_ticks": st["pipelined_ticks"],
                   "tick_phase_ms": st["tick_phase_ms"], "tokens": total,
                   "wall_s": lead["wall_s"],
                   "tokens_per_s": total / lead["wall_s"], "launches": lead["launches"],
                   "compared_tokens": compared, "margin_cuts": ties}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vtpu_torch.ops import _build

    def log(msg: str) -> None:
        print(msg, flush=True)

    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    builds = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in builds.items()))
    for k, v in builds.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
                log(f"  {k}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [check_flash(gen, log), check_paged(gen, log, int8=False),
               check_paged(gen, log, int8=True),
               check_decode(gen, log, int8=False), check_decode(gen, log, int8=True),
               check_paged_tp(gen, log, int8=False), check_paged_tp(gen, log, int8=True)]
    for kern in kernels:
        log(f"{kern['name']} on {card} (tile {kern['tile']}, {kern['n_split']} splits): kernel "
            f"{kern['ms']:.4f} ms, plain "
            f"{kern['plain_ms']:.4f} ms, library {kern['library_ms']:.4f} ms (kernel/library "
            f"{kern['ms'] / kern['library_ms']:.2f}x), bound {kern['bound_ms']:.4f} ms "
            f"({kern['bound_by']}, {100 * kern['bound_ms'] / kern['ms']:.0f}% of it); host "
            f"enqueue {kern['host_ms']:.4f} ms per wrapper call")
    from vtpu_torch.models import ModelConfig, init_params

    # weights depend on the widths only: one seeded set serves both KV types
    params = init_params(SEED, ModelConfig(**FLAGSHIP, dtype=torch.bfloat16))
    runs = {"main_path": serving_path(log, card, params, kv_int8=False),
            "int8_serving_path": serving_path(log, card, params, kv_int8=True)}
    refs = {"bf16": runs["main_path"].pop("refs"), "int8": runs["int8_serving_path"].pop("refs")}
    runs["loop_comparison"] = {kv: loop_comparison(log, card, params, kv == "int8", refs[kv])
                               for kv in ("bf16", "int8")}
    runs["study_path"] = study_path(gen, log)
    del params
    torch.cuda.empty_cache()  # the TP ranks share this card when there is one
    for tp in (TP, 4):
        if tp == TP or torch.cuda.device_count() >= tp:
            out = tp_serving_paths(log, card, refs, tp)
            pre = "tp" if tp == TP else f"tp{tp}"
            runs[f"{pre}_serving_path"], runs[f"{pre}_int8_serving_path"] = out["bf16"], out["int8"]
    bf16, int8 = runs["main_path"], runs["int8_serving_path"]
    log(f"serving waves on {card}: bf16 KV {bf16['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{bf16['ttft_ms'][len(bf16['ttft_ms']) // 2]:.1f} ms; int8 KV "
        f"{int8['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{int8['ttft_ms'][len(int8['ttft_ms']) // 2]:.1f} ms")
    for kv, cmp in runs["loop_comparison"].items():
        med = {name: sorted(w["tokens_per_s"] for w in cmp[name]["waves"])[REPEATS // 2]
               for name in cmp}
        log(f"loop comparison {kv} on {card}: median tokens/s pipelined on graphs "
            f"{med['pipelined']:.1f}, synchronous eager {med['sync']:.1f} "
            f"({med['pipelined'] / med['sync']:.2f}x)")
    # each kernel's launches come from the path that runs it
    path_of = {"flash_attention": "main_path", "paged_decode_attention": "main_path",
               "paged_decode_attention_int8kv": "int8_serving_path",
               "decode_attention": "study_path", "decode_attention_int8kv": "study_path",
               "paged_decode_attention_tp": "tp_serving_path",
               "paged_decode_attention_int8kv_tp": "tp_int8_serving_path"}
    for kern in kernels:
        kern["launches"] = runs[path_of[kern["name"]]]["launches"][kern["name"]]
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "builds": {k: v["seconds"] for k, v in builds.items()},
                       "kernels": kernels, **runs}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "tile", "n_split")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
