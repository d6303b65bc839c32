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
   chunk over pages of 128, 16 and 48 keys, the null block poisoned, and at
   the verify shape T=5 on the serving pool), with
   kernel, plain and library times, their ratio, the least time the card
   could take for the same work, and each kernel's tile and split count;
   flash is timed at the serving shape and at a one-row admission, the
   paged kernels at the serving tick and the verify shape, the
   dense decode kernel at the study's four T=1 cells; the paged kernels
   (bf16, int8) also on each tp=2 head shard, against their plain versions
   and, bit for bit, the head slice of the full-pool call, at the serving
   tick, the ragged chunk and the verify shape T=5 (rows 4v), each timed;
3. the paths, each with every launch count set to 0 just before it and
   read just after:
   a. the main path: the flagship ModelConfig served by ServingEngine on a
      paged bf16 pool with the default ServingConfig loop (pipelined, its
      decode step replayed from CUDA graphs captured under
      set_sync_debug_mode("error")) and logprobs=True, six requests
      streamed, greedy streams checked against the port's plain trunk
      (use_kernels=False) under a logit-margin rule and each logprob against
      log_softmax of its logits, launch counts showing both kernels ran
      (graph replays included: paged launches = 12 x decode ticks); then
      one more wave under torch.profiler for the device's busy share;
   b. the int8 serving path: the same model and wave with kv_int8=True,
      every decode tick through the int8 paged kernel, streams checked
      against the plain int8 trunk;
   c. the loop comparison: the same model with 128 new tokens a request,
      the wave served by the synchronous eager loop and by the pipelined
      loop on graphs, interleaved, three times each, bf16 and int8 KV:
      tokens/s, TTFT p50, host_ms_per_tick and the tick phases per loop
      with their spread, the device busy share of one profiled wave each,
      streams held against the plain trunk;
   d. the host-sampler wave: the main path's wave with a custom sample=
      callable and async_admission=False, on the synchronous host-sampling
      loop (one [4, vocab] logits fetch a tick, one blocking first-token
      fetch an admission), its tokens/s beside the main path's;
   e. chunked + prefix: the flagship model with prefill_chunk=256 on the
      pipelined loop on graphs, a registered 512-token prefix under four
      suffixes, two prompts past the 1024 bucket, one empty suffix: streams
      against the plain trunk over the full prompt, the shared blocks'
      refcounts and the pool's use, prefill_chunks, graph replays and paged
      launches per tick, the state tensors' addresses, the pool fully free
      after unregister; TTFT with and without the prefix and of the
      chunked prompts over three interleaved rounds; one int8 wave of the
      prefixed requests;
   f. the dense decode study: decode_attention over the study's four T=1
      cells in bf16 and in int8;
   g. device loop + speculation: the flagship with 128 new tokens a
      request on four loops, each on engines whose every decode step
      replays from graphs captured when the engine is built: the pipelined
      per-tick loop, decode_loop_k=8, spec_tokens=4 (synchronous loop) and
      both (fused), interleaved, three waves each; then one profiled wave
      per loop, the fused and pipelined loops on periodic prompts (a
      24-token segment tiled), one fused wave with an AdaptiveLoopPolicy (a
      graph per depth) and one with int8 KV (both speculating on every
      flush, spec_min_mean 0): streams against the plain
      trunk, graph replays against flushes or ticks, paged launches = 12 x
      inner ticks, no capture while serving, spec_emitted against the
      tokens speculation delivered, the pool free, every state tensor in
      place; tokens/s, TTFT, host ms a token, device busy share, acceptance,
      graphs and the memory they reserve per loop;
   h. tensor-parallel serving, at the flagship's and the MoE's widths and
      TP_LAYERS (4) of their 12 layers (a sharding check: every layer's
      collectives, fewer layers): two spawned ranks (NCCL, one card each,
      where there are two cards; else gloo, both on card 0) serve the
      main path's wave with bf16 and then int8 KV on the pipelined loop
      (eager: no graphs under a mesh), every decode tick through the
      head-local paged kernel on each rank, streams checked against the
      plain trunk of the same depth and KV type; then, in the same world, one
      16-token wave of each of the broadcast protocol's other paths: h1
      phase e's chunks and a registered 512-token prefix; h2
      decode_loop_k=8, h3 spec_tokens=4 (bf16 and int8), h4 fused (8, 4);
      h5 phase k's MoE (its experts split over the ranks), pipelined and
      with spec_tokens=4; h6 phase i's overcommit engine, eight sessions
      parked, evicted and resumed; h7 decode_loop_k=8 under delayed_fetch
      stalls, down both rungs of the watchdog and back; h8 DisaggConfig()
      with phase l's two background prompts and burst; h9 migration under
      the mesh, two rounds of 48-token sessions moved at their 16th token
      (tp_move_rounds): bf16, tp engines src, small (phase n's small pool
      and host tier) and dst, each on a process group of its own, and a
      one-device engine on this card: a live move src -> dst, a move onto
      dst's pool read dry (alloc_exhaust) into every rank's host tier,
      resumed by swap-in, src -> one device -> dst, a session evicted to
      every rank's tier on small moved to dst, and src drained into dst
      (parked, live, waiting); int8 KV, a fleet of two tp engines, a live
      move and fleet.drain. h9 holds its streams against the plain trunk
      teacher-forced, the moves' paths, migration_copies 0, every payload
      pages x the whole-head block bytes, on each rank the launch
      identities (the one-device engine's ticks through the single-device
      paged kernel, on rank 0 only) and every rank's pool and tier free,
      and prints each move's ms, bytes and GB/s. Each
      of h1-h8 held as its one-device phase holds it: every stream against the plain trunk of
      its KV type or family teacher-forced on it (a near-tie skipped), on
      every rank head-local paged launches = 4 x the inner ticks on the
      kernel route (verify ticks included) and no single-device paged
      launch, flash launches = 4 x admission dispatches (none under
      disaggregation), no install or handoff copy, every swapped-in block
      byte for byte on each rank's shard, the pool and every rank's host
      tier free; tokens/s per arm. Given four cards, four ranks over NCCL
      serve the main path's waves after them;
   i. overcommit (run after g): the flagship on the default pipelined loop
      on graphs with kv_swap, a pool of four sessions of at most 9 pages
      (kv_pool_blocks=37, prefill_chunk=256) and a host tier of 36 pinned
      blocks; a chat tenant's eight sessions between turns: four admitted,
      16 tokens streamed, parked; four more admitted, which evicts the
      first four; those stream and park; the first four resume and finish,
      then the second four. Arms: the host tier, recompute-only
      (kv_swap=0), the crossover (kv_swap_recompute_tokens=1280) and int8
      KV with the host tier; then one park and resume each on a
      decode_loop_k=8 and a fused (8, 4) engine, the park settling where
      the device's length for the slot equals the tokens the stream has
      cached. Held: every token of every stream, those after each park and
      resume included, against the plain trunk teacher-forced on that
      stream (a near-tie is skipped, not an end); every swapped-in block,
      byte for byte, every KV and scale plane, against what left the pool
      at its swap-out; the counters the traffic implies (evicted blocks, swap
      faults, rebuilds, swap bytes = blocks x bytes a block), pool and host
      tier free at the end, one fetch a tick as in an unparked wave, graph
      replays and paged launches per tick, no capture while serving, every
      state tensor in place, no host wait in a swap dispatch
      (set_sync_debug_mode("error")). Printed: swap-out and swap-in GB/s
      in the waves and idle against a plain pinned copy_ of the same
      bytes, resume latency per restore path (resident, swap-in,
      recompute) at about 128, 512 and 1040 cached tokens, the swap_drain
      phase, and the eviction wave's tokens/s against the same wave with
      nothing parked;
   j. failure domains (run after i): the flagship on the pipelined loop on
      graphs (paged bf16, slots=4, the 1024 bucket). Deadlines and
      overload: eight prompts, priorities 0-7, queued before the loop
      starts on a one-deep line, one with deadline_ms=0 and one whose
      deadline is rewound after 4 tokens; with the default policy, an
      inverted one and a raising one: the statuses, shed_deadline and
      shed_overload exact, the trace's shed events. dispatch_exc at its
      6th arrival on the main path's wave: one request FAULTED, the
      counters exact. The watchdog's ladder on decode_loop_k=8: a
      threshold of max(20 ms, 10 x the warm wave's fetch p99), stalls of
      three thresholds (delayed_fetch): three waves each healthy, on rung
      1 (one-token flushes) and on rung 2 (the gather graphs), tokens/s;
      a second engine degrades twice and recovers twice in LIFO order;
      the gather graphs record no paged launch, paged launches = 12 x the
      kernel route's ticks, no capture while serving; an 8-tick flush
      capped at one token timed against the one-token flush; the graph
      pools with and without the watchdog's sets. The overcommit seams on
      phase i's engine: alloc_exhaust, swap_d2h_loss, swap_h2d_loss, each
      once, with the counters they imply. engine_death armed after two
      tokens: the loop thread exits without cleanup and no terminal, then
      a fresh engine serves. Every stream a fault or shed leaves alone,
      and every cut stream's prefix, held against the plain trunk
      teacher-forced on it; pool and host tier free; state in place;
   k. model families (run after j): ServingEngine(model=) over the MoE
      (the flagship trunk with 8 experts of width 2048, top-2, capacity
      factor 2.0: MoeSlotModel on a paged pool of 128-token pages) and the
      selective SSM (SSMConfig(vocab=8192, d_model=1024, n_layers=12,
      d_state=16) of benchmarks/mfu_bench.py: SsmSlotModel), both at full
      width and depth, random weights from SEED, on graphs captured when
      each engine is built. MoE arms: the pipelined loop, bf16 KV, three
      waves; int8 KV; decode_loop_k=8, spec_tokens=4 and both (fused);
      prefill_chunk=256 with a registered 512-token prefix and two prompts
      past the bucket; the plain route (no kernels, the gather route).
      SSM: the pipelined loop and decode_loop_k=8, three waves each. Every
      MoE stream held against the plain MoE trunk teacher-forced on it
      behind its admission replayed as the engine ran it (the batch, from
      the engine's trace, or the chunks), a step skipped under the logit
      margin or under ROUTE_MARGIN between a token's k-th and (k+1)-th
      expert probability, each arm holding FAMILY_HELD steps at least; the
      loop arms' streams equal to the pipelined arm's on the same
      admission up to a first difference at such a step; the flash
      route's admissions against the plain route's, layer by layer; every
      SSM stream against the plain recurrence; flash launches = 12 x
      admission dispatches and paged launches = 12 x inner ticks on MoE,
      none on the plain route and the SSM; one replay a dispatch, no
      capture while serving, every state
      tensor in place, the pool free; tokens/s and TTFT beside the main
      path's, an admission's wall time and peak memory, the MoE block's
      parts at the admission shape and the SSM scan's peak;
   l. disaggregated prefill/decode (run after k): the flagship with
      prefill_chunk=256 on the pipelined loop on graphs; two background
      streams of 128 tokens, then a burst of the six wave prompts of 16
      tokens each. The A/B: co-scheduled (prefill_budget=2048, bucketed
      flash admission) against DisaggConfig() (a prefill worker on its own
      CUDA stream), interleaved, three waves each; then one wave each of
      int8 KV, prefill_workers=2, decode_loop_k=8, the MoE of phase k, a
      worker_death at the wave's first claim, and phase i's overcommit
      engine where handoffs race evictions. Held a wave: every stream OK,
      equal to the co-scheduled arm's stream of the same prompt up to a
      step the teacher-forced plain trunk calls a near-tie and every token
      against that trunk (check_forced; the MoE through check_routed,
      FAMILY_HELD steps); handoff_copies 0, a handoff a request, one fetch
      and one replay a dispatch, paged launches = 12 x inner ticks, no
      flash launch under disaggregation, no capture, the pool free; every
      swapped-in block byte for byte; one worker restart; the handoff
      installs and swap dispatches under set_sync_debug_mode("error"), the
      worker's fetch an event wait that mode does not flag. Printed: burst
      TTFT p50/p99, background ITL p50/p99 while the burst is served,
      tokens/s, queue wait and prefill exec, a worker chunk's and a loop
      chunk's host and stream ms;
   m. training (run after the TP phases), every launch count set to 0
      before it and held at 0 after it (the flash kernel has no backward:
      training runs with use_kernels=False, as the reference's step sets
      use_pallas=False). m1: the flagship ModelConfig in bf16, AdamW with
      optax's defaults, ten steps of make_train_step on one seeded 8 x
      1024-token batch: the loss finite and falling; the first step's
      loss and every gradient tensor against an f32 copy of the same
      weights (loss within TRAIN_LOSS_REL, cosine at least TRAIN_COSINE);
      the median step, training tokens/s, peak memory and the model-FLOPs
      share of 989 TFLOP/s (information). m2: phase k's MoE and SSM at
      full width, bf16, five AdamW steps each on a fixed batch: the loss
      falls. m3: one spawned 4-rank world (gloo with the ranks on card 0,
      or nccl with a card each where there are four) at the flagship's
      widths, depth 4, f32, each arm against the single-device port on the
      card: the dp2 x tp2 and multislice 2 x 1 x 2 train steps' losses and
      gradients, a dp2 x tp2 checkpoint (parameters, AdamW moments, step
      counts) restored byte for byte on dp1 x tp4, ring and Ulysses
      attention at sp=4 against plain causal attention, sp_loss's and
      pp_loss's (pp=4) gradients, and the MoE's ep=4 and dp2 x ep2
      forwards against the dense MoE (capacity factor E / k, so nothing
      drops);
   n. migration and drain (run after l): the flagship, bf16, paged, slots
      4, kv_swap set, on the pipelined loop on graphs; three engines share
      the card and the seeded weights: a source (a FaultPlan of
      migrate_src_death at 0), a source with a pool of MG_SMALL_POOL blocks
      and a host tier, and a destination. Arms: recompute (the source dies
      after the handshake, the destination rebuilds the session from its
      token history), resident (a stream parked inside its 16th token's
      delivery, migrate() from the client), requeue (a request held in the
      source's queue, parked unstarted by migrate()), host (a parked session
      evicted to the small source's host tier by a second admission, its
      payload read from host memory) and drain (a live, a parked and a
      waiting session and a cancelled one, then src.drain(dst)). Held: every
      moved stream against the plain trunk (refs["bf16"], the margin rule;
      the rebuilt one teacher-forced), every report's path, the migration
      counters, out and in bytes equal, migration_copies 0, every pool and
      host tier free, the drained source empty with submit refused, the
      cancelled request CANCELLED, no state tensor moved and no graph
      captured, one replay and 12 paged launches a decode tick on each
      engine, every stats() key in the exporter's tables. Printed: each
      arm's migrate() ms, the pause from the last source token to the first
      destination token, payload bytes and GB/s, each snapshot's ms, the
      drain's ms and sessions moved;
   o. the engine fleet (run after n): three flagship engines (bf16, paged,
      slots 4, kv_swap and prefill_chunk set) on the pipelined loop on
      graphs share the card and the seeded weights behind one EngineFleet
      (members a, b, c; c with an engine_death FaultPlan, the fleet a
      probe_loss plan). Arms: suspect (b walks to SUSPECT and back, no
      failover), route (the wave prompts through fleet.submit), cold (a
      prefix spilled to the fleet's host tier and installed on the route's
      winner by a pid submit), prefix (a prefix registered on a, two
      prefix-aware submits routed onto it, hot replication onto a peer),
      failover (c dies at a tick head holding a live, a parked and a
      prefix-backed session, each rebuilt on a survivor, the prefix-backed
      one around a resident copy of its prefix), drain (b's sessions placed
      on the survivor), export (register_fleet and one scrape). Held: every
      stream against the plain trunk (the rebuilt ones teacher-forced), the
      fleet counters and health states, prefix_install_copies 0, one prefix
      reuse recomputing the tail alone, one replay and 12 paged launches a
      decode tick on each member, no graph captured while serving, every
      pool and host tier free at the end (the corpse reaped), the corpse's
      post-mortem bundle valid, every stats() key in the exporter's
      tables. Printed: detection ms (c's last beat to DEAD), rebuild ms per
      session, the pause across the failover, each prefix export and
      install's ms and bytes, the drain's ms, and the phase's seconds;
   p. the fabric (run after o): members of one EngineFleet in other
      processes. A child engine host is spawned first (spawn_host: a fresh
      interpreter serving the flagship from the same seed on the card,
      phase o's serving config, its decode throttled by delayed_fetch at
      FB_THROTTLE_S a fetch) and dialed over TCP as r1 (host "h0"); then an
      in-proc EngineHost over a loopback link serves a flagship engine as
      r0, beside a local engine l. p1 (pinned to r0): the wave's six
      prompts at 32 tokens through the proxy; a session migrated r0 -> l
      and back; a 512-token prefix exported from l and installed on r0
      over the wire, a suffix streamed there. p2: a session migrated l ->
      r1 and back over TCP; a stream pinned to r1, the child SIGKILLed
      after its FB_KILL_AT-th token, the stream finished on l. Held: every
      stream against the plain trunk (the rebuilt one teacher-forced),
      flash launches = 12 x r0's admission dispatches and paged launches =
      12 x its decode ticks as r0's stats() report them over the wire, the
      child's launch counts nonzero in r1's stats(), every migration
      resident, migration_copies and prefix_install_copies 0,
      fabric_checksum_faults 0, the child's exit by SIGKILL,
      fabric_links_down 1, the failed-over journey's hops tagged h0 then
      local, no graph captured and no state tensor moved in this process,
      every pool free. Printed: spawn to port line and to first beat, each
      link's RTT EMA, each migration's and the prefix install's bytes, ms
      and GB/s, detection (r1's last beat to DEAD), the pause across the
      failover, and the phase's seconds;
   q. kv_int8="auto" (run after p): the router's verdicts over its
      measured grid printed; then the flagship at full depth with
      ModelConfig(kv_int8="auto") on a paged pool (kv_page=128) and the
      default loop, one engine a verdict the router gives in the grid (its
      first cell of each; the flagship's shape alone where the grid gives
      one): the resolved flag equal to choose_kv_int8(slots, max_seq), the
      pool's dtype following it, the wave's decode ticks through the
      matching paged kernel at 12 launches a tick and the other paged
      kernel never, one replay a tick, every stream held against the plain
      trunk of the resolved KV type teacher-forced on it.
   Every teacher-forced check runs the plain trunk over a stream in one
   pass (the prompt prefilled, the stream's tokens as one chunk through
   the decode trunk; the SSM's recurrence stays step by step); each
   phase's end prints the plain trunks' seconds and steps in it;
4. a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last line
   ``{"ok": true, "device": {...}}``.
Needs a CUDA device and the repo checkout; refuses to run without either.
"""

from __future__ import annotations

import argparse
import collections
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
# check_forced holds every step of a stream whose teacher-forced plain-trunk
# top-1/top-2 margin is at least this. Held over thousands of steps, and not
# only the few before a stream's first near-tie, bf16 rounding flips the
# greedy pick at margins up to 0.0625 on the H100 (four bf16 ulps of a top
# logit in [2, 4)); this is twice that, and check_forced reports the widest
# flip it skipped in every run
FORCED_MARGIN = 0.125
# a logprob against log_softmax of the plain trunk's logits: the same bf16
# noise the margin rule allows for, on a log-probability
LOGPROB_TOL = 0.05
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
    # consecutive calls read different pool memory, as the trunk does; then
    # the same at the verify shape of the device loop + speculation phase
    # (spec_tokens 4: T = 5 queries a row, each row's five positions ending
    # at the serving tick's lengths), held against the plain version first
    pools, wp, table, kv1 = serving
    shapes = []
    for t in (1, SPEC_K + 1):
        kvl = (kv1 - (t - 1) + torch.arange(t, dtype=torch.int32, device="cuda")[None, :]
               ).contiguous()
        q = torch.randn((4, t, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
        err = 0.0
        if t > 1:
            for layer in (0, n_layers - 1):
                got = fn(q, *pools, table, kvl, layer)
                torch.cuda.synchronize()
                err = max(err, max_err(got, ref(q, *pools, table, kvl, layer)))
            log(f"{name} page {page} verify T={t} on the serving pool: max_abs_err {err:.3e} "
                f"(atol {ATOL})")
            if not err <= ATOL:
                raise AssertionError(f"{name} disagrees with its plain version at T={t}: {err}")
            errs.append(err)
        ms, host = time_ms(lambda i: fn(q, *pools, table, kvl, i % n_layers), 60)
        plain, _ = time_ms(lambda i: ref(q, *pools, table, kvl, i % n_layers), 12, hold=False)
        # [B, 1, T, W]: query i of row b sees the keys below kv_len[b, i]
        mask = (torch.arange(wp * page, device="cuda")[None, None, :] < kvl[:, :, None])[:, None]

        def library(i):
            l = i % n_layers
            if int8:
                k = dequant(gather_kv_pages(pools[0][l], table),
                            gather_kv_pages(pools[1][l], table))
                v = dequant(gather_kv_pages(pools[2][l], table),
                            gather_kv_pages(pools[3][l], table))
            else:
                k, v = gather_kv_pages(pools[0][l], table), gather_kv_pages(pools[1][l], table)
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask)

        # int8: ~12 small ops per call, fewer calls, so the held launch queue never fills
        lib, _ = time_ms(library, 20 if int8 else 60)
        keys = int(kvl[:, -1].sum())  # each row's keys read once
        per_key = h * dh * 2 * (1 if int8 else 2) + (h * 4 * 2 if int8 else 0)
        nbytes = keys * per_key + 2 * q.numel() * 2 + table.numel() * 4 + kvl.numel() * 4
        bms, by = bound_ms(nbytes, 4 * int(kvl.sum()) * h * dh)
        shapes.append({"shape": [4, t, h, dh], "ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bms, "bound_by": by, "host_ms": host, "max_abs_err": err})
        log(f"{name} T={t} q [4, {t}, {h}, {dh}] on the serving pool: kernel {ms:.4f} ms, "
            f"gather + SDPA {lib:.4f} ms (kernel/library {ms / lib:.2f}x), plain {plain:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
    top = shapes[0]
    return {"name": name, "route": "cuda", "source": "vtpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "vtpu/ops/decode_attn.py:435" if int8 else "vtpu/ops/decode_attn.py:347",
            "max_abs_err": max(errs), "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "host_ms": top["host_ms"], "shapes": shapes,
            "tile": paged_tile(page), "n_split": paged_split_plan(4, h, wp, page)}


def rand_int8(gen, shape) -> torch.Tensor:
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def rand_scales(gen, shape) -> torch.Tensor:
    # the study's range, [1e-3, 2.1e-2] (hack/decode_attn_bench.py)
    return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3


def dequant(xq: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return (xq.float() * sc[..., None]).to(torch.bfloat16)


def check_paged_tp(gen, log, int8: bool) -> list[dict]:
    """Row 4, the paged kernel on one rank's head shard (the reference's
    ``_shard_body``), in one process: the pools of check_paged (bf16, or
    int8 with scale pools; pages 128, 16 and 48) and q split on heads into
    TP head shards; each shard's call with a mesh, at the serving tick and
    the ragged copy-on-write chunk, against its plain version (within ATOL)
    and against the head slice of the full-pool call (a mesh call takes the
    split plan of the full head count, so the two must be bitwise equal);
    then kernel, plain and library times at the head-local serving tick.
    Rows 4v: the same at the verify shape T = SPEC_K + 1 on the serving
    pool (each row's five queries ending at the serving tick's lengths),
    every rank's shard held both ways and timed. Returns [row 4, row 4v]."""
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
            serving = shards, pools, wp, table, kv1
    shards, pools, wp, table, kv1 = serving
    rows = []
    for t in (1, SPEC_K + 1):
        kvl = (kv1 - (t - 1) + torch.arange(t, dtype=torch.int32, device="cuda")[None, :]
               ).contiguous()
        q = torch.randn((4, t, h, dh), generator=gen, device="cuda").to(torch.bfloat16)
        errs_t, diffs_t = list(errs), list(diffs)
        if t > 1:
            errs_t, diffs_t = [], []
            for layer in (0, n_layers - 1):
                whole = fn(q, *pools, table, kvl, layer)
                for m, ps in zip(meshes, shards):
                    qs = head_shard(q, -2, m)
                    got = fn(qs, *ps, table, kvl, layer, mesh=m)
                    torch.cuda.synchronize()
                    errs_t.append(max_err(got, ref(qs, *ps, table, kvl, layer, mesh=m)))
                    diffs_t.append(max_err(got, head_shard(whole, -2, m)))
            log(f"{name} page {page} verify T={t} on the serving pool, {TP} ranks, layers 0 "
                f"and {n_layers - 1}: max_abs_err {max(errs_t):.3e} (atol {ATOL}), max diff "
                f"from the full-pool call's head slice {max(diffs_t):.3e} (must be 0)")
            if not (max(errs_t) <= ATOL and max(diffs_t) == 0):
                raise AssertionError(f"{name} at T={t} disagrees: {max(errs_t)} against its "
                                     f"plain version, {max(diffs_t)} against the full-pool call")
        ps, qs = shards[0], head_shard(q, -2, meshes[0])
        ms, host = time_ms(lambda i: fn(qs, *ps, table, kvl, i % n_layers, mesh=meshes[0]), 60)
        plain, _ = time_ms(lambda i: ref(qs, *ps, table, kvl, i % n_layers, mesh=meshes[0]), 12,
                           hold=False)
        # [B, 1, T, W]: query i of row b sees the keys below kv_len[b, i]
        mask = (torch.arange(wp * page, device="cuda")[None, None, :] < kvl[:, :, None])[:, None]

        def library(i):
            l = i % n_layers
            if int8:
                k = dequant(gather_kv_pages(ps[0][l], table), gather_kv_pages(ps[1][l], table))
                v = dequant(gather_kv_pages(ps[2][l], table), gather_kv_pages(ps[3][l], table))
            else:
                k, v = gather_kv_pages(ps[0][l], table), gather_kv_pages(ps[1][l], table)
            return F.scaled_dot_product_attention(qs.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask)

        lib, _ = time_ms(library, 20 if int8 else 60)
        keys, hl = int(kvl[:, -1].sum()), h // TP  # each row's keys read once
        per_key = hl * dh * 2 * (1 if int8 else 2) + (hl * 4 * 2 if int8 else 0)
        nbytes = keys * per_key + 2 * qs.numel() * 2 + table.numel() * 4 + kvl.numel() * 4
        bms, by = bound_ms(nbytes, 4 * int(kvl.sum()) * hl * dh)
        log(f"{name} T={t} q [4, {t}, {hl}, {dh}] on one rank's shard of the serving pool: "
            f"kernel {ms:.4f} ms, gather + SDPA {lib:.4f} ms (kernel/library {ms / lib:.2f}x), "
            f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        rows.append({"name": name if t == 1 else f"{name}_verify", "route": "cuda",
                     "source": "vtpu_torch/csrc/paged_decode_attention.cu",
                     "replaces": "vtpu/ops/decode_attn.py:559", "max_abs_err": max(errs_t),
                     "max_diff_from_full_pool": max(diffs_t), "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib, "host_ms": host,
                     "shape": [4, t, hl, dh], "tile": paged_tile(page),
                     "n_split": paged_split_plan(4, h, wp, page)})
    return rows


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


# the plain trunks' seconds and steps in each phase, by kind: "free" the
# free-running references (reference_stream), "forced" the teacher-forced
# checks' uncached streams; main() logs and resets them at every phase end
TRUNK = {"free": [0.0, 0], "forced": [0.0, 0]}


def trunk_timed(kind: str, fn, steps):
    """``fn`` with its wall seconds and ``steps(*args)`` added to TRUNK[kind]."""
    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        TRUNK[kind][0] += time.perf_counter() - t0
        TRUNK[kind][1] += steps(*args)
        return out
    return timed


def choices(rows: torch.Tensor, what: str) -> tuple[list, list]:
    """Each row's greedy choice and top-1/top-2 margin, one fetch."""
    if not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"{what} produced non-finite logits")
    top = torch.topk(rows, 2, dim=-1).values
    return rows.argmax(dim=-1).tolist(), (top[:, 0] - top[:, 1]).tolist()


# one captured plain decode step per (weights, config), kept with its inputs
PLAIN_STEPS: dict = {}


def plain_step(params, cfg) -> tuple:
    """The plain trunk's one-row decode step, batched_decode_step on a dense
    one-row cache (the step an engine captures for a dense ring), captured
    in a CUDA graph once per weights and config: (graph, cache, token
    buffer, logits buffer). A replay runs the eager step's kernels without
    its host dispatch (~20 ms a step eagerly on the card's host)."""
    from vtpu_torch.models import init_kv_cache
    from vtpu_torch.serving.engine import batched_decode_step

    key = (id(params), cfg)
    if key not in PLAIN_STEPS:
        cache = init_kv_cache(cfg, 1, device="cuda")
        tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
        active = torch.ones((1,), dtype=torch.bool, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            batched_decode_step(params, cfg, cache, tok, active)  # lazy first uses
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = batched_decode_step(params, cfg, cache, tok, active)
        # the graph reads every tensor it captured at replay: keep them all
        PLAIN_STEPS[key] = (graph, cache, tok, logits, params, active)
    return PLAIN_STEPS[key][:4]


def reference_stream(params, cfg, prompt: np.ndarray, steps: int, logprobs: list = None):
    """Greedy stream of the port's plain trunk with each step's top-1/top-2
    logit margin; with ``logprobs`` (a list) each step's log_softmax of its
    greedy token is appended there. The prompt is prefilled eagerly, then
    each step replays plain_step's graph fed the last step's argmax on the
    device; every step's logits are read back once at the end."""
    from vtpu_torch.models import prefill
    from vtpu_torch.models.transformer import kv_keys

    t0 = time.perf_counter()
    graph, cache, tok, out = plain_step(params, cfg)
    logits, filled = prefill(params, cfg, torch.from_numpy(prompt[None]).cuda())
    for key in kv_keys(cache) + ("len",):
        cache[key].copy_(filled[key])
    rows = [logits[0, -1]]
    for _ in range(steps - 1):
        tok.copy_(torch.argmax(rows[-1]))
        graph.replay()
        rows.append(out[0].clone())
    rows = torch.stack(rows)
    toks, margins = choices(rows, "plain trunk")
    if logprobs is not None:
        picked = torch.tensor(toks, device="cuda")[:, None]
        logprobs += torch.log_softmax(rows.float(), dim=-1).gather(1, picked)[:, 0].tolist()
    TRUNK["free"][0] += time.perf_counter() - t0
    TRUNK["free"][1] += steps
    return toks, margins


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


def equal_run(streams: list, refs: list) -> int:
    """Tokens each stream shares with its plain-trunk reference before their
    first difference, summed: the margin rule stops at a small margin even
    where the tokens still agree, this counts on to the real divergence."""
    total = 0
    for toks, (ref, _) in zip(streams, refs):
        n = 0
        while n < min(len(toks), len(ref)) and toks[n] == ref[n]:
            n += 1
        total += n
    return total


def stream_all(eng, prompts, prefix=None) -> tuple[list[dict], float]:
    """Submit every prompt at once (after the registered ``prefix``, if
    given); a reader thread per request records its tokens, logprobs and
    first-token time and its request id. Returns (records, wall seconds)."""
    recs = [{"toks": []} for _ in prompts]

    def read(req, rec):
        for tok in req.stream():
            rec.setdefault("first", time.perf_counter())
            rec["toks"].append(tok)
        rec["status"] = req.status
        rec["logprobs"] = list(req.logprobs)

    t0 = time.perf_counter()
    threads = []
    for prompt, rec in zip(prompts, recs):
        rec["submit"] = time.perf_counter()
        req = eng.submit(prompt, prefix=prefix)
        rec["rid"] = req.rid
        th = threading.Thread(target=read, args=(req, rec), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a stream did not finish within 600 s")
    return recs, time.perf_counter() - t0


def profile_wave(eng, prompts) -> dict | None:
    """Stream one more wave under torch.profiler, device activity only: the
    device's busy share of the wave's wall time and device time by kernel
    name. None when the profiler recorded no device activity. The profiler
    slows the host, so the idle share it shows is an upper bound. The
    profiler's raw events are summed as they come: building its event
    tree (``prof.events()``) took 20-50 s a wave on the card's host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = stream_all(eng, prompts)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            # the template arguments name a walk's tile source: keep them
            name = evt.name().replace("(anonymous namespace)::", "")[:80]
            by_name[name] = by_name.get(name, 0.0) + evt.duration_ns() / 1e3
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
    just after. The bf16 run (the main path) streams logprobs too (one more
    output of every decode graph), each held against log_softmax of the
    plain trunk's logits, and then one more wave under the profiler. The
    plain trunk's references run COMPARE_TOKENS steps, so the loop
    comparison and the TP paths reuse them."""
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
        slots=4, prefill_buckets=(1024,), max_new_tokens=new_tokens, kv_page=128,
        logprobs=not kv_int8))
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
    ref_lps = [[] for _ in prompts]
    refs = [reference_stream(params, plain_cfg, prompt, COMPARE_TOKENS, lps)
            for prompt, lps in zip(prompts, ref_lps)]
    compared, ties = check_streams([rec["toks"] for rec in recs], refs, "engine")
    lp_err = lp_n = 0
    if not kv_int8:
        lp_err, lp_n = check_logprobs(recs, refs, ref_lps, what)
    ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
    total = sum(len(rec["toks"]) for rec in recs)
    log(f"{what} on {card}: {len(prompts)} requests, {total} tokens in {wall:.3f} s "
        f"({total / wall:.1f} tokens/s), TTFT p50 {ttft[len(ttft) // 2]:.1f} ms "
        f"max {ttft[-1]:.1f} ms; decode ticks {ticks} ({pipelined} pipelined, {replays} "
        f"graph replays), device_gets_per_tick {gets_per_tick}; launches {launches}")
    log(f"{what} streams vs plain {'int8 ' if kv_int8 else ''}trunk: {compared} tokens "
        f"compared equal, {ties} streams cut at a top-1/top-2 margin < {MARGIN}")
    if not kv_int8:
        log(f"{what} logprobs: one per decoded token in every stream; {lp_n} held against "
            f"log_softmax of the plain trunk, max abs diff {lp_err:.2e} (limit {LOGPROB_TOL})")
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
            "margin_cuts": ties, "logprob_max_err": lp_err, "logprobs_compared": lp_n,
            "prefill_batch_hist": after["prefill_batch_hist"],
            "kv_bucket_hist": after["kv_bucket_hist"],
            "tick_phase_ms": after["tick_phase_ms"],
            "paged_attn_kernel_ticks": after["paged_attn_kernel_ticks"]
            - base["paged_attn_kernel_ticks"], "profiled_wave": prof, "refs": refs}


def check_logprobs(recs: list, refs: list, ref_lps: list, what: str) -> tuple[float, int]:
    """Each stream's logprobs: one per decoded token (the first token, sampled
    at admission, has none), each within LOGPROB_TOL of log_softmax of the
    plain trunk's logits at its step, up to the stream's first step whose
    top-1/top-2 margin is below MARGIN. Returns (max abs diff, logprobs
    compared)."""
    worst, n = 0.0, 0
    for rec, (_, margins), lps in zip(recs, refs, ref_lps):
        if len(rec["logprobs"]) != len(rec["toks"]) - 1:
            raise AssertionError(f"{what}: {len(rec['logprobs'])} logprobs for "
                                 f"{len(rec['toks'])} tokens")
        for j, lp in enumerate(rec["logprobs"]):
            step = j + 1
            if min(margins[:step + 1]) < MARGIN:
                break
            err = abs(lp - lps[step])
            if not err <= LOGPROB_TOL:
                raise AssertionError(f"{what}: logprob {lp} at step {step} vs plain trunk "
                                     f"{lps[step]}")
            worst, n = max(worst, err), n + 1
    return worst, n


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


class Laps:
    """Wall seconds of a phase's sub-steps, summed by name: ``lap(name)``
    charges the time since the previous lap (or the start) to ``name``."""

    def __init__(self):
        self.s: dict = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now

    def line(self) -> str:
        return ", ".join(f"{k} {v:.1f}" for k, v in self.s.items())


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
    laps = Laps()
    engines = {"sync": ServingEngine(params, cfg, dataclasses.replace(
                   serving, pipeline_decode=False)),
               "pipelined": ServingEngine(params, cfg, serving)}
    if engines["sync"].decode_graphs is not None or engines["pipelined"].decode_graphs is None:
        raise AssertionError("the synchronous loop must run eagerly and the pipelined "
                             "loop on graphs")
    prompts = wave_prompts(cfg.vocab)
    waves: dict = {name: [] for name in engines}
    profiles = {}
    laps.lap("build")
    for eng in engines.values():
        eng.start()
    try:
        for eng in engines.values():
            stream_all(eng, [prompts[0]])
        laps.lap("warm-up")
        for r in range(REPEATS):
            for name in (("sync", "pipelined") if r % 2 == 0 else ("pipelined", "sync")):
                waves[name].append(measured_wave(engines[name], prompts, refs,
                                                 f"{kv} {name} loop"))
                laps.lap(f"timed {name}")
        for name, eng in engines.items():
            profiles[name] = profile_wave(eng, prompts)
            laps.lap(f"profiled {name}")
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
    log(f"loop comparison {kv} sub-steps, wall s: {laps.line()}")
    out["laps_s"] = laps.s
    return out


def argmax_sampler(row: np.ndarray) -> int:
    """The host-sampler wave's custom sampler: the greedy token of one
    fetched [vocab] f32 row."""
    return int(np.argmax(row))


def host_sampler_path(log, card: str, params, refs: list, device_tps: float) -> dict:
    """The main path's wave with a custom ``sample=`` callable and
    ``async_admission=False``: the synchronous host-sampling loop (eager, no
    graph), one fetch of the [4, vocab] f32 logits a tick, one blocking
    first-token fetch an admission. Streams held against the plain trunk
    (``refs``); its tokens/s printed beside the device-sampling main
    path's (``device_tps``), the cost of the host path."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import ServingConfig, ServingEngine

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    new_tokens = 16
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(1024,), max_new_tokens=new_tokens, kv_page=128,
        async_admission=False), sample=argmax_sampler)
    st = eng.stats()
    if eng.decode_graphs is not None or st["pipelined"] or st["device_sampling"]:
        raise AssertionError("a custom sampler must run the synchronous host-sampling loop")
    prompts = wave_prompts(cfg.vocab)
    eng.start()
    try:
        stream_all(eng, [prompts[0]])
        base = eng.stats()
        _build.reset_launches()
        recs, wall = stream_all(eng, prompts)
        launches = _build.launches()
        after = eng.stats()
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise AssertionError(f"host-sampler loop failed: {eng.loop_error!r}")
    ticks = after["decode_ticks"] - base["decode_ticks"]
    fetches = after["tick_fetches"] - base["tick_fetches"]
    syncs = after["admission_syncs"] - base["admission_syncs"]
    admissions = after["admissions"] - base["admissions"]
    fetched = after["bytes_fetched"] - base["bytes_fetched"]
    for rec in recs:
        if rec.get("status") != "OK" or len(rec["toks"]) != new_tokens:
            raise AssertionError(f"host-sampler stream ended {rec.get('status')} after "
                                 f"{len(rec['toks'])} of {new_tokens} tokens")
    if fetches != ticks or not syncs == admissions == len(prompts):
        raise AssertionError(f"host-sampler wave: {fetches} fetches over {ticks} ticks, "
                             f"{syncs} admission syncs over {admissions} admissions")
    if fetched != ticks * 4 * cfg.vocab * 4:
        raise AssertionError(f"host-sampler wave fetched {fetched} bytes over {ticks} ticks")
    if (launches["paged_decode_attention"] != cfg.n_layers * ticks
            or launches["flash_attention"] <= 0):
        raise AssertionError(f"host-sampler wave launches {launches} over {ticks} ticks")
    compared, ties = check_streams([rec["toks"] for rec in recs], refs, "host-sampler")
    total = sum(len(rec["toks"]) for rec in recs)
    ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
    log(f"host-sampler wave on {card}: {len(prompts)} requests, {total} tokens in {wall:.3f} s "
        f"({total / wall:.1f} tokens/s; device-sampling main path on graphs "
        f"{device_tps:.1f} tokens/s, host path {total / wall / device_tps:.2f}x), TTFT p50 "
        f"{ttft[len(ttft) // 2]:.1f} ms; {ticks} ticks, {fetches} fetches of "
        f"{fetched // max(ticks, 1)} bytes, {syncs} admission syncs; host_ms_per_tick "
        f"{after['host_ms_per_tick']}; streams: {compared} tokens equal to the plain trunk, "
        f"{ties} cut at a margin < {MARGIN}; launches {launches}")
    return {"launches": launches, "decode_ticks": ticks, "tokens": total, "wall_s": wall,
            "tokens_per_s": total / wall, "device_sampling_tokens_per_s": device_tps,
            "ttft_ms": ttft, "admission_syncs": syncs, "bytes_fetched_per_tick": fetched / ticks,
            "host_ms_per_tick": after["host_ms_per_tick"], "compared_tokens": compared,
            "margin_cuts": ties}


# the chunked + prefix phase: a tenant's 512-token system prompt, four
# suffixes, two prompts past the 1024 bucket, and one empty suffix
PREFIX_LEN = 512
SUFFIX_LENS = (64, 180, 290, 400)
LONG_LENS = (1100, 1250)
CHUNK = 256


def chunked_prefix_prompts(vocab: int):
    """(prefix, suffixes, long prompts) of the chunked + prefix phase from
    SEED."""
    rs = np.random.RandomState(SEED + 1)
    prefix = rs.randint(0, vocab, (PREFIX_LEN,)).astype(np.int32)
    sufs = [rs.randint(0, vocab, (n,)).astype(np.int32) for n in SUFFIX_LENS]
    longs = [rs.randint(0, vocab, (n,)).astype(np.int32) for n in LONG_LENS]
    return prefix, sufs, longs


def chunked_prefix_path(log, card: str, params) -> dict:
    """Chunked prefill and a shared prefix on the flagship model at full
    width and depth, pipelined on graphs: a 512-token prefix registered
    (built into pool blocks on the loop thread), four prefixed requests (a
    snapshot at the first decode dispatch with all four live reads the
    shared blocks' refcounts and the pool's use), two prompts of 1100 and
    1250 tokens (five 256-token chunks each), one empty suffix; each wave's
    streams held against the plain trunk over the full prompt, the counted
    run's chunks, graph replays and paged launches against what the prompts
    imply, every state tensor's address held over the phase. Then three
    interleaved timing rounds (prefixed wave, the same full prompts
    unregistered, the long prompts), the prefix unregistered with the pool
    fully free, and one int8 wave of the prefixed requests."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import ServingConfig, ServingEngine

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    serving = ServingConfig(slots=4, prefill_buckets=(1024,), prefill_chunk=CHUNK, kv_page=128,
                            max_new_tokens=16)
    prefix, sufs, longs = chunked_prefix_prompts(cfg.vocab)
    fulls = [np.concatenate([prefix, s]) for s in sufs]
    plain = dataclasses.replace(cfg, use_kernels=False)
    refs = {"prefixed": [reference_stream(params, plain, p, 16) for p in fulls],
            "long": [reference_stream(params, plain, p, 16) for p in longs],
            "empty": [reference_stream(params, plain, prefix, 16)]}
    eng = ServingEngine(params, cfg, serving)
    if eng.decode_graphs is None:
        raise AssertionError("the chunked + prefix phase must run the pipelined loop on graphs")
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    snaps: list = []
    step = eng._step

    def snapshot_step(*args):
        # on the loop thread, at a decode dispatch: the bookkeeping is settled
        live = [r for r in eng._slot_req if r is not None]
        if not snaps and len(live) == 4 and all(r.prefix is not None for r in live):
            blocks = eng._prefixes[live[0].prefix]["blocks"]
            snaps.append({"refs": [eng._alloc.refcount(b) for b in blocks],
                          "used": eng._n_blocks - 1 - eng._alloc.free_blocks,
                          "shared": sum(eng._slot_shared)})
        return step(*args)

    eng._step = snapshot_step
    chunk_s: list = []
    chunk_fn = eng._prefill_chunk

    def timed_chunk(*args, **kw):
        t0 = time.perf_counter()
        out = chunk_fn(*args, **kw)
        chunk_s.append(time.perf_counter() - t0)
        return out

    eng._prefill_chunk = timed_chunk
    eng.start()
    waves: dict = {"prefixed": [], "unregistered": [], "long": []}
    try:
        t0 = time.perf_counter()
        pid = eng.register_prefix(prefix)
        register_ms = (time.perf_counter() - t0) * 1e3
        # warm-up: one request of each kind
        stream_all(eng, [sufs[0]], prefix=pid)
        stream_all(eng, [fulls[0]])
        stream_all(eng, [longs[0]])
        base = eng.stats()
        replays = eng.decode_graphs.replays
        _build.reset_launches()
        recs = {"prefixed": stream_all(eng, sufs, prefix=pid)[0],
                "long": stream_all(eng, longs)[0],
                "empty": stream_all(eng, [np.zeros((0,), np.int32)], prefix=pid)[0]}
        launches = _build.launches()
        counted = eng.stats()
        replays = eng.decode_graphs.replays - replays
        chunk_s.clear()
        for r in range(REPEATS):
            kinds = ("prefixed", "unregistered", "long")
            for kind in (kinds if r % 2 == 0 else kinds[::-1]):
                if kind == "prefixed":
                    got, _ = stream_all(eng, sufs, prefix=pid)
                elif kind == "unregistered":
                    got, _ = stream_all(eng, fulls)
                else:
                    got, _ = stream_all(eng, longs)
                check_streams([rec["toks"] for rec in got],
                              refs["long" if kind == "long" else "prefixed"], f"{kind} wave")
                ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in got)
                waves[kind].append(ttft[len(ttft) // 2])
        timed = eng.stats()
        eng.unregister_prefix(pid)
        drained = eng.stats()
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise AssertionError(f"chunked + prefix loop failed: {eng.loop_error!r}")
    compared = ties = same = 0
    for kind, rs in recs.items():
        for rec in rs:
            if rec.get("status") != "OK" or len(rec["toks"]) != 16:
                raise AssertionError(f"{kind} stream ended {rec.get('status')} after "
                                     f"{len(rec['toks'])} tokens")
        c, t = check_streams([rec["toks"] for rec in rs], refs[kind], f"{kind} wave")
        compared, ties = compared + c, ties + t
        same += equal_run([rec["toks"] for rec in rs], refs[kind])
    if not snaps:
        raise AssertionError("no decode dispatch had the four prefixed requests live")
    snap = snaps[0]
    full_pages = PREFIX_LEN // 128
    need = sum(-(-(len(f) + 16) // 128) for f in fulls)
    if snap["refs"] != [1 + 4] * full_pages or snap["shared"] != 4 * full_pages:
        raise AssertionError(f"prefix block refcounts {snap['refs']} (expected "
                             f"{[5] * full_pages}), shared {snap['shared']}")
    if snap["used"] != need - 3 * full_pages:
        raise AssertionError(f"pool used {snap['used']} blocks with the prefix shared, "
                             f"expected {need} - 3 x {full_pages}")
    chunks = counted["prefill_chunks"] - base["prefill_chunks"]
    want_chunks = sum(-(-len(s) // CHUNK) for s in sufs) + sum(-(-len(p) // CHUNK) for p in longs)
    ticks = counted["decode_ticks"] - base["decode_ticks"]
    if chunks != want_chunks:
        raise AssertionError(f"prefill_chunks {chunks}, the prompts imply {want_chunks}")
    if replays != ticks or launches["paged_decode_attention"] != cfg.n_layers * ticks:
        raise AssertionError(f"{ticks} decode ticks, {replays} graph replays, paged launches "
                             f"{launches['paged_decode_attention']}")
    if {k: x.data_ptr() for k, x in eng.state.items()} != ptrs:
        raise AssertionError("a state tensor moved during the chunked + prefix phase")
    if drained["kv_pool_free"] != drained["kv_pool_blocks"] or drained["registered_prefixes"]:
        raise AssertionError(f"after unregister: {drained['kv_pool_free']} of "
                             f"{drained['kv_pool_blocks']} blocks free")
    hits = counted["prefix_hits"] - base["prefix_hits"]
    log(f"chunked + prefix on {card}: prefix of {PREFIX_LEN} registered in {register_ms:.1f} ms; "
        f"counted run {len(sufs)} prefixed + {len(longs)} long + 1 empty-suffix requests: "
        f"prefill_chunks {chunks} (implied {want_chunks}), prefix hits {hits}, decode ticks "
        f"{ticks} = graph replays {replays}, paged launches "
        f"{launches['paged_decode_attention']} = {cfg.n_layers} x ticks, flash "
        f"{launches['flash_attention']}; with 4 sharers live: prefix block refcounts "
        f"{snap['refs']}, pool used {snap['used']} blocks against {need} unshared "
        f"(saving 3 x {full_pages}); after unregister {drained['kv_pool_free']} of "
        f"{drained['kv_pool_blocks']} blocks free; state tensors in place; streams: "
        f"{compared} tokens equal to the plain trunk over the full prompt, {ties} cut at a "
        f"margin < {MARGIN}; {same} of {16 * sum(map(len, recs.values()))} tokens equal "
        "before each stream's first difference")
    chunk_ms = sorted(x * 1e3 for x in chunk_s)
    log(f"chunked + prefix timing on {card}, {REPEATS} interleaved rounds, median [min, max] of "
        f"each wave's TTFT p50 ms: prefixed {spread(waves['prefixed'])}, same full prompts "
        f"unregistered {spread(waves['unregistered'])}, chunked {LONG_LENS} "
        f"{spread(waves['long'])}; chunk dispatch host ms {spread(chunk_ms)} over "
        f"{len(chunk_ms)} chunks; stats() prefill_exec_p50_ms {timed['prefill_exec_p50_ms']}, "
        f"queue_wait_p50_ms {timed['queue_wait_p50_ms']}, ttft_p50_ms {timed['ttft_p50_ms']}")
    int8 = chunked_prefix_int8(log, card, params, serving, prefix, sufs, fulls)
    return {"launches": launches, "decode_ticks": ticks, "graph_replays": replays,
            "prefill_chunks": chunks, "prefix_hits": hits, "snapshot": snap,
            "unshared_blocks": need, "register_ms": register_ms,
            "ttft_p50_ms": waves, "chunk_dispatch_ms": chunk_ms,
            "prefill_exec_p50_ms": timed["prefill_exec_p50_ms"],
            "compared_tokens": compared, "margin_cuts": ties, "equal_run_tokens": same,
            "int8": int8}


def chunked_prefix_int8(log, card: str, params, serving, prefix, sufs, fulls) -> dict:
    """One wave of the four prefixed requests with int8 KV: the prefix's
    quantized planes shared from the pool; streams against the plain int8
    trunk over the full prompts."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import ServingEngine

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True, kv_int8=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    refs = [reference_stream(params, plain, p, 16) for p in fulls]
    eng = ServingEngine(params, cfg, serving)
    eng.start()
    try:
        pid = eng.register_prefix(prefix)
        _build.reset_launches()
        recs, _ = stream_all(eng, sufs, prefix=pid)
        launches = _build.launches()
        st = eng.stats()
        eng.unregister_prefix(pid)
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise AssertionError(f"int8 chunked + prefix loop failed: {eng.loop_error!r}")
    for rec in recs:
        if rec.get("status") != "OK" or len(rec["toks"]) != 16:
            raise AssertionError(f"int8 prefixed stream ended {rec.get('status')}")
    compared, ties = check_streams([rec["toks"] for rec in recs], refs, "int8 prefixed wave")
    same = equal_run([rec["toks"] for rec in recs], refs)
    if launches["paged_decode_attention_int8kv"] != cfg.n_layers * st["decode_ticks"]:
        raise AssertionError(f"int8 prefixed wave launches {launches}")
    log(f"chunked + prefix int8 on {card}: {len(sufs)} prefixed requests, prefix hits "
        f"{st['prefix_hits']}, boundary copies {st['prefix_cow_copies']}; streams: {compared} "
        f"tokens equal to the plain int8 trunk over the full prompt, {ties} cut at a margin "
        f"< {MARGIN}; {same} of {16 * len(recs)} equal before each stream's first difference")
    return {"launches": launches, "compared_tokens": compared, "margin_cuts": ties,
            "equal_run_tokens": same}


# the device loop + speculation phase: the flush depth, the draft length,
# and the segment length of its periodic prompts
LOOP_K = 8
SPEC_K = 4
PERIOD = 24
# the phase's loops: ServingConfig fields over the loop comparison's config
LOOPS = {"pipelined": {}, "device_loop": {"decode_loop_k": LOOP_K},
         "spec": {"spec_tokens": SPEC_K},
         "fused": {"decode_loop_k": LOOP_K, "spec_tokens": SPEC_K}}


def periodic_prompts(vocab: int) -> list[np.ndarray]:
    """Six prompts of 600-1024 tokens, each a random PERIOD-token segment
    tiled: text whose drafts find matches (a random-weight model's own
    text says nothing about acceptance on real text)."""
    rs = np.random.RandomState(SEED + 2)
    out = []
    for n in rs.randint(600, 1025, 6):
        seg = rs.randint(0, vocab, (PERIOD,))
        out.append(np.tile(seg, -(-int(n) // PERIOD))[:int(n)].astype(np.int32))
    return out


def settle(eng) -> None:
    """Return once the engine's loop has made a pass with nothing to do: a
    client's stream can end (its terminal is put at retirement) while the
    loop is still inside that delivery, before the delivery's counters
    move, so counters are read only after this. Installs an event on the
    loop's idle wait at first use."""
    ev = getattr(eng, "_idle_seen", None)
    if ev is None:
        ev = eng._idle_seen = threading.Event()
        idle = eng._idle_wait

        def seen(*a, **kw):
            ev.set()
            return idle(*a, **kw)

        eng._idle_wait = seen
    ev.clear()
    if not ev.wait(timeout=60):
        raise AssertionError("the serving loop did not go idle within 60 s")


def spec_token_counter(eng) -> dict:
    """Count the tokens delivered by speculation (the synchronous loop's
    verify ticks and the fused flushes) from the engine's own generated
    count around each delivery, to hold against stats()["spec_emitted"]."""
    box = {"tokens": 0}
    for name in ("_spec_tick", "_deliver_fused_flush"):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, **kw):
            before = eng._stats["generated_tokens"]
            out = _fn(*a, **kw)
            box["tokens"] += eng._stats["generated_tokens"] - before
            return out

        setattr(eng, name, counted)
    return box


def graph_pool_bytes() -> int:
    """Bytes of the allocator's segments that belong to CUDA graphs' private
    memory pools (every pool but the default one)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def build_engine(params, cfg, serving) -> tuple:
    """(engine, {"reserved": torch.cuda.memory_reserved() after the build
    less before it (cached blocks released first; the allocator may place
    the state in segments it holds already), "graphs": bytes of the graph
    pools the build added, "state": bytes of the engine's KV state})."""
    from vtpu_torch.serving import ServingEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before, pools = torch.cuda.memory_reserved(), graph_pool_bytes()
    eng = ServingEngine(params, cfg, serving)
    torch.cuda.synchronize()
    state = sum(x.numel() * x.element_size() for x in eng.state.values())
    return eng, {"reserved": torch.cuda.memory_reserved() - before,
                 "graphs": graph_pool_bytes() - pools, "state": state}


def profiled_ticks(eng, prompts) -> tuple:
    """One profiled wave (profile_wave) and the inner ticks it ran: its
    device ms per inner tick, or None where the profiler saw no device
    activity."""
    settle(eng)
    before = eng.stats()
    prof = profile_wave(eng, prompts)
    settle(eng)
    after = eng.stats()
    inner = sum(after[k] - before[k] for k in ("decode_ticks", "spec_ticks"))
    return prof, (None if prof is None else prof["device_busy_ms"] / inner), inner


def loop_wave(eng, prompts, refs, what: str, spec_box: dict, new_tokens: int) -> dict:
    """One counted wave of a loop: every launch count set to 0 just before
    it and read just after; streams against the plain trunk (``refs``)
    under the margin rule; graph replays against the dispatches the
    counters imply, paged launches = 12 x inner ticks, no graph captured,
    the pool fully free, spec_emitted equal to the tokens speculation
    delivered. Returns its figures."""
    from vtpu_torch.ops import _build

    settle(eng)
    replays = [g.replays for g in eng._graph_sets()]
    spec0 = spec_box["tokens"]
    before = eng.stats()
    _build.reset_launches()
    recs, wall = stream_all(eng, prompts)
    settle(eng)
    launches = _build.launches()
    after = eng.stats()
    d = {k: after[k] - before[k] for k in (
        "decode_ticks", "spec_ticks", "loop_flushes", "fused_flushes", "spec_emitted",
        "spec_slot_ticks", "tick_fetches", "generated_tokens", "admissions", "loop_early_exits")}
    for rec in recs:
        if rec.get("status") != "OK" or len(rec["toks"]) != new_tokens:
            raise AssertionError(f"{what}: a stream ended {rec.get('status')} after "
                                 f"{len(rec['toks'])} of {new_tokens} tokens")
    compared, ties = check_streams([rec["toks"] for rec in recs], refs, what)
    inner = d["decode_ticks"] + d["spec_ticks"]
    paged = ("paged_decode_attention_int8kv" if "k_scale" in eng.state
             else "paged_decode_attention")
    others = {k: n for k, n in launches.items() if k not in (paged, "flash_attention") and n}
    if launches[paged] != FLAGSHIP["n_layers"] * inner or others:
        raise AssertionError(f"{what}: {paged} launched {launches[paged]} times over {inner} "
                             f"inner ticks (expected {FLAGSHIP['n_layers']} each), others {others}")
    played = sum(g.replays for g in eng._graph_sets()) - sum(replays)
    dispatches = d["loop_flushes"] if eng._loop_k else inner
    if played != dispatches:
        raise AssertionError(f"{what}: {played} graph replays for {dispatches} dispatches")
    if eng.spec_graphs is not None and eng.spec_graphs.replays - replays[
            eng._graph_sets().index(eng.spec_graphs)] != d["spec_ticks"]:
        raise AssertionError(f"{what}: verify replays differ from its {d['spec_ticks']} ticks")
    if after["graphs_captured"] != before["graphs_captured"]:
        raise AssertionError(f"{what}: a graph was captured while serving")
    if after["kv_pool_free"] != after["kv_pool_blocks"]:
        raise AssertionError(f"{what}: paged pool not fully free after the wave")
    if spec_box["tokens"] - spec0 != d["spec_emitted"]:
        raise AssertionError(f"{what}: spec_emitted {d['spec_emitted']}, speculation delivered "
                             f"{spec_box['tokens'] - spec0} tokens")
    ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
    total = sum(len(rec["toks"]) for rec in recs)
    return {"tokens_per_s": total / wall, "ttft_p50_ms": ttft[len(ttft) // 2],
            "ttft_ms": ttft, "wall_s": wall, "tokens": total,
            "host_ms_per_token": after["host_ms_per_token"],
            "host_ms_per_tick": after["host_ms_per_tick"], "inner_ticks": inner,
            "graph_replays": played, "paged_launches": launches[paged],
            "paged_launches_verify": FLAGSHIP["n_layers"] * d["spec_ticks"],
            "mean_emitted_per_spec_tick": (d["spec_emitted"] / d["spec_slot_ticks"]
                                           if d["spec_slot_ticks"] else None),
            "fused_k_hist": [a - b for a, b in zip(after["fused_k_hist"],
                                                   before["fused_k_hist"])],
            "compared_tokens": compared,
            "margin_cuts": ties, **d}


def device_loop_spec_path(log, card: str, params, refs: dict) -> dict:
    """The multi-tick device loop and speculation at the flagship's full
    width and depth, every decode step replayed from graphs captured when
    its engine is built. Four loops over the loop comparison's wave (six
    prompts of 600-1024 tokens, COMPARE_TOKENS new tokens each) on engines
    of their own, interleaved, one warm-up then REPEATS waves each: the
    pipelined per-tick loop, decode_loop_k=LOOP_K, spec_tokens=SPEC_K on
    the synchronous loop, and both (fused). Then one profiled wave per
    loop for the device busy share, the fused and pipelined loops on
    periodic prompts, one fused wave with an AdaptiveLoopPolicy (a graph
    per depth) and one with int8 KV, both speculating on every flush
    (spec_min_mean 0). Each counted wave is held by
    ``loop_wave``; every state tensor keeps its address over the phase."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.serving import ServingConfig
    from vtpu_torch.serving.shed import AdaptiveLoopPolicy

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    base = ServingConfig(slots=4, prefill_buckets=(1024,), kv_page=128,
                         max_new_tokens=COMPARE_TOKENS)
    prompts = wave_prompts(cfg.vocab)
    laps = Laps()
    engines, memory, ptrs, boxes = {}, {}, {}, {}
    for name, kw in LOOPS.items():
        engines[name], memory[name] = build_engine(params, cfg, dataclasses.replace(base, **kw))
        eng = engines[name]
        ptrs[name] = {k: x.data_ptr() for k, x in eng.state.items()}
        boxes[name] = spec_token_counter(eng)
    waves: dict = {name: [] for name in engines}
    profiles = {}
    plain = dataclasses.replace(cfg, use_kernels=False)
    periodic = periodic_prompts(cfg.vocab)
    laps.lap("build")
    periodic_refs = [reference_stream(params, plain, p, COMPARE_TOKENS) for p in periodic]
    laps.lap("periodic refs")
    extra = {}
    for eng in engines.values():
        eng.start()
    try:
        for eng in engines.values():
            stream_all(eng, [prompts[0]])
        laps.lap("warm-up")
        order = list(engines)
        for r in range(REPEATS):
            for name in order[r % len(order):] + order[:r % len(order)]:
                waves[name].append(loop_wave(engines[name], prompts, refs["bf16"],
                                             f"{name} loop", boxes[name], COMPARE_TOKENS))
                laps.lap(f"timed {name}")
        for name, eng in engines.items():
            profiles[name] = profiled_ticks(eng, prompts)
            laps.lap(f"profiled {name}")
        for name in ("pipelined", "fused"):
            extra[f"{name}_periodic"] = loop_wave(engines[name], periodic, periodic_refs,
                                                  f"{name} loop, periodic prompts", boxes[name],
                                                  COMPARE_TOKENS)
            laps.lap(f"periodic {name}")
            # every inner tick of these waves is one kind: a decode tick
            # (pipelined) or, while the fused loop accepts, a verify tick
            _, extra[f"{name}_periodic"]["device_ms_per_inner_tick"], _ = profiled_ticks(
                engines[name], periodic)
            laps.lap(f"periodic {name} profiled")
    finally:
        for eng in engines.values():
            eng.stop()
    for name, eng in engines.items():
        if eng.loop_error is not None:
            raise AssertionError(f"{name} loop failed: {eng.loop_error!r}")
        if {k: x.data_ptr() for k, x in eng.state.items()} != ptrs[name]:
            raise AssertionError(f"{name} loop: a state tensor moved during the phase")
    graphs = {name: eng.stats()["graphs_captured"] for name, eng in engines.items()}
    del engines
    torch.cuda.empty_cache()
    # one fused wave with a LoopPolicy (a graph per depth), one with int8
    # KV; speculation never pauses in these two (spec_min_mean 0), so on
    # this random text, where the acceptance EMA sits below the default
    # 1.25, their flushes still verify: the policy's depths replay their
    # graphs and the int8 kernel runs at T = 5
    for name, kw, c, wave_refs in (
            ("fused_policy", dict(loop_policy=AdaptiveLoopPolicy()), cfg, refs["bf16"]),
            ("fused_int8", {}, dataclasses.replace(cfg, kv_int8=True), refs["int8"])):
        eng, memory[name] = build_engine(params, c, dataclasses.replace(
            base, **LOOPS["fused"], spec_min_mean=0.0, **kw))
        ptr = {k: x.data_ptr() for k, x in eng.state.items()}
        box = spec_token_counter(eng)
        graphs[name] = eng.stats()["graphs_captured"]
        eng.start()
        try:
            stream_all(eng, [prompts[0]])
            extra[name] = loop_wave(eng, prompts, wave_refs, f"{name} loop", box,
                                    COMPARE_TOKENS)
        finally:
            eng.stop()
        if eng.loop_error is not None:
            raise AssertionError(f"{name} loop failed: {eng.loop_error!r}")
        if {k: x.data_ptr() for k, x in eng.state.items()} != ptr:
            raise AssertionError(f"{name} loop: a state tensor moved")
        del eng
        torch.cuda.empty_cache()
        laps.lap(name)
    if graphs != {"pipelined": 2, "device_loop": 2, "spec": 4, "fused": 4,
                  "fused_policy": 2 * (LOOP_K + 1), "fused_int8": 4}:
        raise AssertionError(f"graphs captured per engine: {graphs}")
    out = {}
    for name, ws in waves.items():
        prof, tick_ms, prof_ticks = profiles[name]
        wall_ms = sorted(w["wall_s"] for w in ws)[len(ws) // 2] * 1e3
        busy = (None if prof is None else prof["device_busy_ms"] / wall_ms)
        spec = [w["mean_emitted_per_spec_tick"] for w in ws if w["mean_emitted_per_spec_tick"]]
        log(f"device loop + speculation, {name} on {card}, {REPEATS} waves of {len(prompts)} x "
            f"{COMPARE_TOKENS} tokens, median [min, max]: tokens/s "
            f"{spread([w['tokens_per_s'] for w in ws])}; TTFT p50 ms "
            f"{spread([w['ttft_p50_ms'] for w in ws])}; host ms a token "
            f"{spread([w['host_ms_per_token'] for w in ws])}; device busy of the median "
            f"unprofiled wave {'not measured' if busy is None else f'{100 * busy:.1f}%'} "
            f"(profiled: {'not measured' if tick_ms is None else f'{tick_ms:.3f}'} device ms "
            f"over each of {prof_ticks} inner ticks); "
            f"mean emitted per spec tick {spread(spec) if spec else None}; fused_k_hist "
            f"{[w['fused_k_hist'] for w in ws]}; inner ticks {[w['inner_ticks'] for w in ws]}, graph "
            f"replays {[w['graph_replays'] for w in ws]}, paged launches "
            f"{[w['paged_launches'] for w in ws]} (T = {SPEC_K + 1}: "
            f"{[w['paged_launches_verify'] for w in ws]}); {graphs[name]} graphs in "
            f"{memory[name]['graphs'] / 2**20:.1f} MiB of graph pools (state "
            f"{memory[name]['state'] / 2**20:.1f} MiB; memory_reserved grew "
            f"{memory[name]['reserved'] / 2**20:.1f} MiB); streams: "
            f"{sum(w['compared_tokens'] for w in ws)} tokens equal to the plain trunk, "
            f"{sum(w['margin_cuts'] for w in ws)} cut at a margin < {MARGIN}")
        if prof is not None:
            log(f"device loop + speculation, {name} profiled wave by kernel: " + "; ".join(
                f"{n} {ms:.2f} ms" for n, ms in prof["top_kernels_ms"]))
        out[name] = {"waves": ws, "profiled_wave": prof, "device_busy_share": busy,
                     "device_ms_per_inner_tick": tick_ms,
                     "graphs": graphs[name], "memory": memory[name]}
    for name, w in extra.items():
        log(f"device loop + speculation, {name} on {card}: {w['tokens_per_s']:.1f} tokens/s, "
            f"TTFT p50 {w['ttft_p50_ms']:.1f} ms, host ms a token {w['host_ms_per_token']}, "
            f"mean emitted per spec tick {w['mean_emitted_per_spec_tick']}, fused_k_hist "
            f"{w['fused_k_hist']}, inner ticks {w['inner_ticks']} = graph replays' ticks "
            f"({w['graph_replays']} replays), paged launches {w['paged_launches']}; "
            + (f"device ms per inner tick (profiled) {w['device_ms_per_inner_tick']}; "
               if "device_ms_per_inner_tick" in w else "")
            + (f"{graphs[name]} graphs in {memory[name]['graphs'] / 2**20:.1f} MiB of graph pools "
               f"(state {memory[name]['state'] / 2**20:.1f} MiB; memory_reserved grew "
               f"{memory[name]['reserved'] / 2**20:.1f} MiB); " if name in graphs else "")
            + f"streams: {w['compared_tokens']} tokens equal to the plain trunk, "
            f"{w['margin_cuts']} cut at a margin < {MARGIN}")
        out[name] = {"wave": w, **({"graphs": graphs[name], "memory": memory[name]}
                                   if name in graphs else {})}
    med = {name: sorted(w["tokens_per_s"] for w in out[name]["waves"])[REPEATS // 2]
           for name in LOOPS}
    log(f"device loop + speculation on {card}: median tokens/s " + ", ".join(
        f"{name} {v:.1f} ({v / med['pipelined']:.2f}x)" for name, v in med.items())
        + f"; periodic prompts: fused {extra['fused_periodic']['tokens_per_s']:.1f}, pipelined "
        f"{extra['pipelined_periodic']['tokens_per_s']:.1f}")
    verify = [w["paged_launches_verify"] for name in ("spec", "fused")
              for w in out[name]["waves"]]
    out["launches"] = {"paged_decode_attention_verify": sum(verify),
                       "paged_decode_attention_int8kv_verify":
                           extra["fused_int8"]["paged_launches_verify"]}
    log(f"device loop + speculation sub-steps, wall s: {laps.line()}")
    out["laps_s"] = laps.s
    return out


# the overcommit phase: a chat tenant's eight sessions between turns. The
# pool holds four sessions of at most 9 pages of 128 (37 blocks), the host
# tier four (36 blocks); each session streams OC_TOKENS tokens a turn, two
# turns
OC_SERVING = dict(slots=4, prefill_buckets=(1024,), kv_page=128, prefill_chunk=256,
                  kv_pool_blocks=37)
OC_HOST = 36
OC_TOKENS = 16
# cached tokens at the park of the resume latency probes
OC_PROBES = (128, 512, 1040)
# budget of a session parked on the multi-tick and fused loops: a fused
# flush may deliver up to LOOP_K * (SPEC_K + 1) = 40 tokens before the park
# settles
OC_LOOP_BUDGET = 96


def overcommit_prompts(vocab: int) -> list[np.ndarray]:
    """Eight prompts of 993-1024 tokens: with two turns of OC_TOKENS a
    session reserves 9 pages of 128, so four fill the pool."""
    rs = np.random.RandomState(SEED + 3)
    return [rs.randint(0, vocab, (int(n),)).astype(np.int32) for n in rs.randint(993, 1025, 8)]


def park_after(eng, req, n: int) -> None:
    """Have the loop thread ask for ``req``'s park right after it puts the
    n-th token from now on the stream: inside that delivery, so the park
    settles at the next tick head where the slot has nothing in flight,
    however fast the loop runs."""
    from vtpu_torch.serving import Terminal

    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if not isinstance(item, Terminal):
            seen[0] += 1
            if seen[0] == n:
                req.out.put = put
                eng.park(req)

    req.out.put = hook


class Session:
    """One request of the overcommit phase, read by a thread of its own that
    stamps each token; with ``park_at`` parked after that many tokens (by
    ``parker``, the engine that serves it: ``eng`` unless ``eng`` is a
    fleet). ``parks`` counts the parks asked of it; ``submit_kw`` go to
    ``eng.submit``. Waits on it block on a condition the reader notifies: a
    waiter that polled would take the interpreter lock from the loop thread
    in the middle of the waves it times."""

    def __init__(self, eng, prompt, budget: int, park_at: int = 0, parker=None, **submit_kw):
        self.eng, self.prompt = parker or eng, prompt
        self.toks, self.times = [], []
        self.ended = False
        self.parks = 0
        self.cond = threading.Condition()
        self.t_submit = time.perf_counter()
        self.req = eng.submit(prompt, max_new_tokens=budget, **submit_kw)
        if park_at:
            self.park_after(park_at)
            if self.req.delivered:
                raise AssertionError("a token was delivered before the park hook was in place")
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def park_after(self, n: int) -> None:
        park_after(self.eng, self.req, n)
        self.parks += 1

    def _read(self):
        for tok in self.req.stream():
            with self.cond:
                self.times.append(time.perf_counter())
                self.toks.append(tok)
                self.cond.notify_all()
        with self.cond:
            self.ended = True
            self.cond.notify_all()

    def wait_tokens(self, n: int) -> None:
        """Block until the reader holds ``n`` tokens (or the stream ended)."""
        with self.cond:
            if not self.cond.wait_for(lambda: len(self.toks) >= n or self.ended,
                                      timeout=120):
                raise AssertionError(f"{n} tokens did not arrive within 120 s")

    def wait_end(self) -> None:
        """Block until the stream has ended, whatever its status."""
        with self.cond:
            if not self.cond.wait_for(lambda: self.ended, timeout=120):
                raise AssertionError("a stream did not end within 120 s")

    def join(self) -> "Session":
        self.thread.join(timeout=600)
        if self.thread.is_alive() or self.req.status != "OK":
            raise AssertionError(f"a stream ended {self.req.status} after {len(self.toks)} tokens")
        return self


class Lifecycle:
    """The lifecycle as the engine's own trace records it: the engine's
    ``trace.record`` is wrapped to count the ``events`` it watches (park and
    evict by default) per request, with the slot of the last one, to keep
    their (event, rid, val) in order in ``seq``, and to notify a condition,
    so a waiter blocks instead of polling."""

    EVENTS = ("park", "evict")

    def __init__(self, eng, events: tuple = EVENTS):
        self.cond = threading.Condition()
        self.counts, self.slots = collections.Counter(), {}
        self.seq = []
        record = eng.trace.record

        def counted(event, rid, *a, **kw):
            record(event, rid, *a, **kw)
            if event in events:
                with self.cond:
                    self.counts[event, rid] += 1
                    self.slots[event, rid] = a[0] if a else kw.get("slot", -1)
                    self.seq.append((event, rid, a[1] if len(a) > 1 else kw.get("val", 0)))
                    self.cond.notify_all()

        eng.trace.record = counted

    def events(self, *names) -> list:
        """(event, rid, val) of the named events, in the order recorded."""
        with self.cond:
            return [e for e in self.seq if e[0] in names]

    def count(self, event: str, s: Session) -> int:
        with self.cond:
            return self.counts[event, s.req.rid]

    def slot(self, event: str, s: Session) -> int:
        with self.cond:
            return self.slots[event, s.req.rid]

    def wait_parked(self, sessions) -> None:
        """Block until each session has parked as often as it was asked to."""
        with self.cond:
            if not self.cond.wait_for(lambda: all(
                    self.counts["park", s.req.rid] >= s.parks for s in sessions), timeout=120):
                raise AssertionError("the parks did not settle within 120 s")


def drained(s: Session) -> None:
    """Block until the reader holds every token put on the stream."""
    s.wait_tokens(s.req.delivered)


def cached_at_park(s: Session) -> int:
    """Tokens a parked session holds in the cache: its prompt and every
    delivered token but the last, the pending input whose KV is not yet
    written."""
    drained(s)
    return len(s.prompt) + s.req.delivered - 1


def resume_latency(eng, s: Session) -> float:
    """Resume a parked session and return ms from resume() to its next token."""
    drained(s)
    n = len(s.toks)
    t0 = time.perf_counter()
    eng.resume(s.req)
    s.wait_tokens(n + 1)
    return (s.times[n] - t0) * 1e3


def forced_rows(params, cfg, prompt: np.ndarray, toks: list) -> torch.Tensor:
    """The plain trunk's logits at every step of a stream in one pass,
    [len(toks), vocab] f32: the prompt prefilled (as reference_stream
    prefills it), then the stream's tokens but its last as one chunk
    through the decode trunk over that cache (chunked_prefill_into_slot:
    each query sees the cache up to its own position, an int8 cache
    written quantized as a decode step writes it). Row i is what the
    trunk fed the stream's first i tokens picks from."""
    from vtpu_torch.models import prefill
    from vtpu_torch.serving.engine import chunked_prefill_into_slot

    dev = params["embed"].device
    n = len(prompt)
    row, cache = prefill(params, cfg, torch.from_numpy(prompt[None]).to(dev),
                         logits_at=torch.tensor([n - 1], device=dev))
    if len(toks) < 2:
        return row
    chunk = torch.tensor([list(toks[:-1])], dtype=torch.int32, device=dev)
    logits, _ = chunked_prefill_into_slot(params, cfg, cache, chunk, 0, n, n + len(toks) - 1)
    return torch.cat([row, logits[0]])


def forced_trunk(params, cfg):
    """The plain trunk teacher-forced on a stream: ``ref(prompt, toks)`` ->
    (its greedy choice, its top-1/top-2 margin) at every step of ``toks``
    (forced_rows: one pass over the stream), cached by prompt; a stream
    that begins another one already forced reads that one's steps."""
    cache = {}
    run = trunk_timed("forced", lambda prompt, toks: choices(
        forced_rows(params, cfg, prompt, toks), "plain trunk"), lambda prompt, toks: len(toks))

    def ref(prompt: np.ndarray, toks: list) -> tuple[list, list]:
        runs = cache.setdefault(prompt.tobytes(), [])
        for got, want, margins in runs:
            if got[:len(toks)] == list(toks):
                return want[:len(toks)], margins[:len(toks)]
        want, margins = run(prompt, list(toks))
        runs.append((list(toks), want, margins))
        return want, margins

    return ref


def check_forced(ref, held: list, what: str) -> dict:
    """Every token of every stream in ``held`` ((prompt, tokens, index of
    the first token after a park) each) against the plain trunk
    teacher-forced on that stream (``ref``, forced_trunk): a step whose
    top-1/top-2 margin is below FORCED_MARGIN is skipped, not an end, so
    the tokens after every park and resume are held, not only those before
    the stream's first near-tie. A mismatch raises, and so does a set of
    parked streams none of whose tokens after a park could be held.
    Returns the tokens held, those after a park, the steps skipped, and
    the skipped steps whose token differs (bf16 flips) with the widest
    margin among them."""
    out = {"held": 0, "held_after_park": 0, "skipped": 0, "flips": 0, "widest_flip": 0.0}
    for prompt, toks, after in held:
        want, margins = ref(prompt, toks)
        for i, (got, w, m) in enumerate(zip(toks, want, margins)):
            if m < FORCED_MARGIN:
                out["skipped"] += 1
                if got != w:
                    out["flips"] += 1
                    out["widest_flip"] = max(out["widest_flip"], m)
                continue
            if got != w:
                raise AssertionError(
                    f"{what}: token {i} of a stream ({len(toks)} tokens, parked before token "
                    f"{after}) is {got}; the plain trunk fed the same tokens picks {w} "
                    f"(margin {m:.4f})")
            out["held"] += 1
            out["held_after_park"] += i >= after
    if any(after < len(toks) for _, toks, after in held) and not out["held_after_park"]:
        raise AssertionError(f"{what}: no token after a park could be held")
    return out


SWAP_DISPATCH = ("_evict_entry", "_swap_in", "_drain_swap_outs")


def guard_sync(eng, names: tuple = SWAP_DISPATCH) -> None:
    """Run the engine's methods ``names`` (by default its swap dispatches:
    evictions, swap-ins, the tick head's polling of swap-outs) under
    set_sync_debug_mode("error"): a host wait there raises, the loop ends
    with loop_error, and the phase fails."""
    for name in names:
        fn = getattr(eng, name)

        def guarded(*a, _fn=fn, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        setattr(eng, name, guarded)


def block_bytes(eng) -> int:
    """Bytes of one pool block across every layer and KV plane, scale
    planes included, from the state's shapes."""
    from vtpu_torch.models.transformer import kv_keys

    return sum(eng.state[k][:, 0].numel() * eng.state[k].element_size()
               for k in kv_keys(eng.state))


def watch_swaps(eng) -> dict:
    """Stamp each swap with CUDA events, no wait (a swap-out from its
    gathers on the main stream to its last copy on the side stream, a
    swap-in over its copies and scatters on the main stream), and hold
    every swap-in byte for byte against what left the pool: a swap-out's
    blocks are cloned on the main stream right behind the engine's gathers
    (before any later write to the released blocks), keyed by host block;
    a swap-in compares the pool blocks it wrote, every KV plane and scale
    plane, with the clones of the host blocks it read and adds the bytes
    that differ to a device counter (no host wait; read after the arm).
    This holds the pinned tier, the side stream's ordering, the snapshot's
    lifetime and the staging buffers at once. Returns {"out", "in": lists
    of (start, end, blocks), "bad": that counter, "checked": blocks
    compared, "spill", "restore": the engine's own methods, unwrapped}."""
    from vtpu_torch.models.transformer import kv_keys

    planes = kv_keys(eng.state)
    box = {"out": [], "in": [], "bad": torch.zeros((), dtype=torch.int64, device="cuda"),
           "checked": 0, "spill": eng._spill, "restore": eng._restore_pages}
    saved = {}

    def ids(blocks):
        return torch.as_tensor(blocks, dtype=torch.long).pin_memory().to("cuda", non_blocking=True)

    def spill(blocks, host):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        done = box["spill"](blocks, host)
        end.record(eng._copy_stream)
        box["out"].append((start, end, len(blocks)))
        idx = ids(blocks)
        left = {k: eng.state[k].index_select(1, idx) for k in planes}
        for j, h in enumerate(host):
            saved[h] = (left, j)
        return done

    def restore(blocks, host):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        box["restore"](blocks, host)
        end.record()
        box["in"].append((start, end, len(blocks)))
        idx = ids(blocks)
        for k in planes:
            want = torch.stack([saved[h][0][k][:, saved[h][1]] for h in host], 1)
            got = eng.state[k].index_select(1, idx)
            box["bad"] += (got.view(torch.uint8) != want.view(torch.uint8)).sum()
        for h in host:
            del saved[h]
        box["checked"] += len(blocks)

    eng._spill, eng._restore_pages = spill, restore
    return box


def swap_rates(stamps: list, bpb: int) -> dict:
    """GB/s and ms of stamped swaps (watch_swaps), after a synchronize."""
    torch.cuda.synchronize()
    ms = [start.elapsed_time(end) for start, end, _ in stamps]
    blocks = [n for _, _, n in stamps]
    return {"swaps": len(stamps), "blocks": sum(blocks), "ms": ms,
            "gb_per_s": (sum(blocks) * bpb / (sum(ms) * 1e6)) if stamps else None}


def idle_swap_rates(swaps: dict, bpb: int, blocks: int) -> dict:
    """With the loop stopped and the pool and host tier free: the engine's
    own swap-out (_spill) and swap-in (_restore_pages) of ``blocks``
    blocks, unwrapped (``swaps``, watch_swaps), and, as the yardstick, one
    plain pinned copy_ of the same bytes each way, device ms a call
    (time_ms) and GB/s."""
    nbytes = blocks * bpb
    ids, host = list(range(1, blocks + 1)), list(range(blocks))

    def spill(_):
        torch.cuda.current_stream().wait_event(swaps["spill"](ids, host))

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {"bytes": nbytes}
    for key, fn in (("swap_out", spill), ("swap_in", lambda _: swaps["restore"](ids, host)),
                    ("pinned_d2h", lambda _: pinned.copy_(dev, non_blocking=True)),
                    ("pinned_h2d", lambda _: dev.copy_(pinned, non_blocking=True))):
        ms, _ = time_ms(fn, iters=10)
        out[key] = {"ms": ms, "gb_per_s": nbytes / (ms * 1e6)}
    return out


def oc_engine(params, cfg, serving):
    """An overcommit engine, its Lifecycle, its state addresses and its
    graph count."""
    from vtpu_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, serving)
    if eng.decode_graphs is None and eng.loop_graphs is None:
        raise AssertionError("an overcommit engine does not serve on CUDA graphs")
    return (eng, Lifecycle(eng), {k: x.data_ptr() for k, x in eng.state.items()},
            eng.stats()["graphs_captured"])


def oc_held(eng, ptrs: dict, captured: int, what: str) -> None:
    """After the loop stopped: no loop error, no graph captured while
    serving, every state tensor at its address."""
    if eng.loop_error is not None:
        raise AssertionError(f"{what}: serving loop failed: {eng.loop_error!r}")
    if eng.stats()["graphs_captured"] != captured:
        raise AssertionError(f"{what}: a graph was captured while serving")
    if {k: x.data_ptr() for k, x in eng.state.items()} != ptrs:
        raise AssertionError(f"{what}: a state tensor moved")


def resume_probe(eng, lc, prompt, fillers, filler_refs, ref, paths: tuple, held: list) -> dict:
    """One session parked after 2 tokens (len(prompt) + 2 or 3 cached
    tokens), then per restore path in ``paths``: "resident" resumes it at
    once; "swap_in" and "recompute" first re-park it and admit four
    1024-token fillers that park after their first token, whose pages need
    it evicted (it is the least recently parked: to the host tier, or
    dropped on a kv_swap=0 engine; the trace's evict event says it was),
    then cancel the fillers, so the resume finds the pool free. Returns the
    cached length and ms from resume() to the next token per path; the
    stream and the fillers' first tokens are held against the plain trunk
    and go on ``held`` for check_forced."""
    s = Session(eng, prompt, 2 * OC_TOKENS, park_at=2)
    lc.wait_parked([s])
    out = {"cached": cached_at_park(s)}
    after = s.req.delivered
    for i, path in enumerate(paths):
        if i:
            s.park_after(1)
            lc.wait_parked([s])
        if path != "resident":
            evicted = lc.count("evict", s)
            fill = [Session(eng, f, 8, park_at=1) for f in fillers]
            lc.wait_parked(fill)
            if lc.count("evict", s) != evicted + 1:
                raise AssertionError("the fillers did not evict the parked probe")
            for f in fill:
                f.req.cancel()
            for f in fill:
                f.wait_end()
            check_streams([f.toks for f in fill], filler_refs, "overcommit filler")
            held += [(f.prompt, f.toks, len(f.toks)) for f in fill]
        out[path] = resume_latency(eng, s)
    s.join()
    check_streams([s.toks], [ref], "overcommit probe")
    held.append((prompt, s.toks, after))
    return out


def overcommit_round(eng, lc, prompts: list) -> dict:
    """One round of an arm's traffic on a running engine with nothing
    parked. The unparked wave: the last four prompts' first turn
    (OC_TOKENS tokens) with nothing parked. Then the counted run, every
    launch count set to 0 just before it: the first four are admitted,
    stream OC_TOKENS tokens and park; the second four are admitted, which
    must evict the first four, stream and park (the eviction wave); the
    first four resume and finish, then the second four. Returns the
    sessions (with the tokens each had delivered at its park), the stats
    before the unparked wave and around the counted run, its launches and
    graph replays, both waves' tokens/s and the resumes' ms to their next
    token."""
    from vtpu_torch.ops import _build

    first, second = prompts[:4], prompts[4:]
    settle(eng)
    s0 = eng.stats()
    unparked = [Session(eng, p, OC_TOKENS) for p in second]
    for s in unparked:
        s.join()
    settle(eng)
    s1 = eng.stats()
    replays = eng.decode_graphs.replays
    _build.reset_launches()
    wave_a = [Session(eng, p, 2 * OC_TOKENS, park_at=OC_TOKENS) for p in first]
    lc.wait_parked(wave_a)
    wave_b = [Session(eng, p, 2 * OC_TOKENS, park_at=OC_TOKENS) for p in second]
    lc.wait_parked(wave_b)
    resume_ms, at_park = [], []
    for group in (wave_a, wave_b):
        for s in group:
            drained(s)
        n0 = [len(s.toks) for s in group]
        at_park += n0
        t0 = time.perf_counter()
        for s in group:
            eng.resume(s.req)
        for s in group:
            s.join()
        resume_ms += [(s.times[n] - t0) * 1e3 for s, n in zip(group, n0)]
    settle(eng)
    end_b = max(s.times[OC_TOKENS - 1] for s in wave_b)
    return {"s0": s0, "s1": s1, "s2": eng.stats(), "launches": _build.launches(),
            "replays": eng.decode_graphs.replays - replays, "unparked": unparked,
            "sessions": wave_a + wave_b, "at_park": at_park, "resume_ms": resume_ms,
            "eviction_tps": 4 * OC_TOKENS / (end_b - min(s.t_submit for s in wave_b)),
            "unparked_tps": 4 * OC_TOKENS / (max(s.times[-1] for s in unparked)
                                             - min(s.t_submit for s in unparked)),
            "eviction_split": wave_split(wave_b), "unparked_split": wave_split(unparked)}


def wave_split(sessions: list) -> dict:
    """A wave's first-turn time split: TTFT p50 (submit to first token) and
    the gaps between its first OC_TOKENS tokens (p50 and max), ms."""
    ttft = sorted((s.times[0] - s.t_submit) * 1e3 for s in sessions)
    gaps = sorted((b - a) * 1e3 for s in sessions
                  for a, b in zip(s.times[:OC_TOKENS - 1], s.times[1:OC_TOKENS]))
    return {"ttft_p50_ms": ttft[len(ttft) // 2], "itl_p50_ms": gaps[len(gaps) // 2],
            "itl_max_ms": gaps[-1]}


def check_round(r: dict, refs: list, ref, expect: dict, bpb: int, paged: str,
                what: str) -> dict:
    """One round (overcommit_round) against what its traffic implies:
    every token of every stream against the plain trunk teacher-forced on
    it (check_forced: the parked sessions' 2 x OC_TOKENS, resumed ones
    included, and the unparked wave's); the free-running margin rule
    against ``refs`` as a report (it stops at each stream's first
    near-tie); the counters against ``expect`` (blocks evicted, spilled and
    swapped in, rebuilds; swap bytes = blocks x bytes a block), the pool
    and host tier free, one fetch a tick with and without parking, graph
    replays = decode ticks, paged launches = 12 x decode ticks. Returns its
    figures."""
    s0, s1, s2 = r["s0"], r["s1"], r["s2"]
    forced = check_forced(ref, [(s.prompt, s.toks, n)
                                for s, n in zip(r["sessions"], r["at_park"])], what)
    forced_unparked = check_forced(ref, [(s.prompt, s.toks, len(s.toks))
                                         for s in r["unparked"]], f"{what} unparked wave")
    compared, ties = check_streams([s.toks for s in r["sessions"]], refs, what)
    check_streams([s.toks for s in r["unparked"]], [(t[:OC_TOKENS], m) for t, m in refs[4:]],
                  f"{what} unparked wave")
    d = {k: s2[k] - s1[k] for k in (
        "parks", "resumes", "evicted_blocks", "swap_out_bytes", "swap_in_bytes", "swap_faults",
        "fault_recomputes", "pool_blocked_admissions", "decode_ticks", "tick_fetches")}
    want = {"parks": 8, "resumes": 8, "evicted_blocks": expect["evicted"],
            "swap_out_bytes": expect["spilled"] * bpb, "swap_in_bytes": expect["swapped_in"] * bpb,
            "swap_faults": 8, "fault_recomputes": expect["recomputes"],
            "pool_blocked_admissions": 0}
    got = {k: d[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: counters {got}, the traffic implies {want}")
    if (s2["kv_pool_free"] != s2["kv_pool_blocks"] or s2["parked_sessions"]
            or s2["swap_host_free"] != s2["swap_host_blocks"]):
        raise AssertionError(f"{what}: pool {s2['kv_pool_free']} of {s2['kv_pool_blocks']} "
                             f"free, host tier {s2['swap_host_free']} of "
                             f"{s2['swap_host_blocks']}, {s2['parked_sessions']} parked")
    gets_unparked = ((s1["tick_fetches"] - s0["tick_fetches"])
                     / (s1["decode_ticks"] - s0["decode_ticks"]))
    gets = d["tick_fetches"] / d["decode_ticks"]
    if not gets == gets_unparked == 1.0:
        raise AssertionError(f"{what}: device_gets_per_tick {gets} (unparked wave "
                             f"{gets_unparked}), expected 1.0")
    if r["replays"] != d["decode_ticks"]:
        raise AssertionError(f"{what}: {r['replays']} graph replays for {d['decode_ticks']} ticks")
    launches = r["launches"]
    others = {k: n for k, n in launches.items() if k not in (paged, "flash_attention") and n}
    if (launches[paged] != FLAGSHIP["n_layers"] * d["decode_ticks"] or others
            or launches["flash_attention"] <= 0):
        raise AssertionError(f"{what}: launches {launches} over {d['decode_ticks']} ticks")
    return {"counters": d, "launches": launches, "graph_replays": r["replays"],
            "device_gets_per_tick": gets, "device_gets_per_tick_unparked": gets_unparked,
            "eviction_wave_tokens_per_s": r["eviction_tps"],
            "unparked_wave_tokens_per_s": r["unparked_tps"], "resume_ms": r["resume_ms"],
            "eviction_wave_split": r["eviction_split"], "unparked_wave_split": r["unparked_split"],
            "forced": forced, "forced_unparked": forced_unparked,
            "compared_tokens": compared, "margin_cuts": ties,
            "equal_run_tokens": equal_run([s.toks for s in r["sessions"]], refs)}


def overcommit_wave(log, card: str, params, cfg, name: str, serving, prompts, refs, ref,
                    expect: dict, probes=None) -> dict:
    """One arm of the overcommit phase on the default pipelined loop on
    graphs: a warm-up request, then REPEATS rounds of the tenant's traffic
    (overcommit_round), each held by check_round, with every swap stamped
    and every swap-in held byte for byte against what left the pool
    (watch_swaps) and every swap dispatch under guard_sync (no host wait);
    then, with ``probes`` = (prompts, fillers, filler refs, refs, paths),
    the resume latency probes; then, with the loop stopped, the idle swap
    rates. ``ref`` is the teacher-forced plain trunk (forced_trunk). No
    capture while serving and every state tensor in place over the arm;
    the pool and host tier free at its end."""
    eng, lc, ptrs, captured = oc_engine(params, cfg, serving)
    swaps = watch_swaps(eng)
    guard_sync(eng)
    paged = "paged_decode_attention_int8kv" if cfg.kv_int8 else "paged_decode_attention"
    eng.start()
    probe, held = None, []
    try:
        Session(eng, prompts[0][:64], 2).join()
        rounds = [overcommit_round(eng, lc, prompts) for _ in range(REPEATS)]
        wave_swaps = {k: list(swaps[k]) for k in ("out", "in")}
        if probes is not None:
            pprompts, fillers, frefs, prefs, paths = probes
            probe = [resume_probe(eng, lc, p, fillers, frefs, r, paths, held)
                     for p, r in zip(pprompts, prefs)]
            settle(eng)
        end = eng.stats()
    finally:
        eng.stop()
    what = f"overcommit {name}"
    oc_held(eng, ptrs, captured, what)
    bpb = block_bytes(eng)
    figs = [check_round(r, refs, ref, expect, bpb, paged, f"{what}, round {i}")
            for i, r in enumerate(rounds)]
    probe_forced = check_forced(ref, held, f"{what} resume probes") if held else None
    torch.cuda.synchronize()
    bad, swapped = int(swaps["bad"]), end["swap_in_bytes"] // bpb
    if bad or swaps["checked"] != swapped:
        raise AssertionError(f"{what}: {bad} bytes of the {swaps['checked']} blocks held differ "
                             f"from what left the pool ({swapped} blocks swapped in)")
    if (end["kv_pool_free"] != end["kv_pool_blocks"] or end["parked_sessions"]
            or end["swap_host_free"] != end["swap_host_blocks"]):
        raise AssertionError(f"{what}: the pool or the host tier is not free at the end")
    if len(wave_swaps["out"]) != REPEATS * expect["spills"]:
        raise AssertionError(f"{what}: {len(wave_swaps['out'])} swap-outs, expected "
                             f"{REPEATS * expect['spills']}")
    rates = {k: swap_rates(v, bpb) for k, v in wave_swaps.items()}
    idle = idle_swap_rates(swaps, bpb, 9) if expect["swapped_in"] else None
    drain = end["tick_phase_ms"]["swap_drain"]
    f0 = figs[0]
    held_n = {k: sum(f["forced"][k] for f in figs) for k in f0["forced"]}
    same = sum([s.toks for s in r["sessions"]] == [s.toks for s in rounds[0]["sessions"]]
               for r in rounds)
    held_n["widest_flip"] = max(f[k]["widest_flip"] for f in figs
                                for k in ("forced", "forced_unparked"))
    log(f"overcommit {name} on {card}: {REPEATS} rounds of 8 sessions x 2 turns of "
        f"{OC_TOKENS} tokens, pool {end['kv_pool_blocks']} blocks, host tier "
        f"{end['swap_host_blocks']} blocks of {bpb} bytes; a round: parks "
        f"{f0['counters']['parks']}, resumes {f0['counters']['resumes']}, evicted "
        f"{f0['counters']['evicted_blocks']} blocks, swapped out "
        f"{f0['counters']['swap_out_bytes'] // bpb} and in "
        f"{f0['counters']['swap_in_bytes'] // bpb}, {f0['counters']['swap_faults']} faults, "
        f"{f0['counters']['fault_recomputes']} rebuilt (every round alike); "
        f"device_gets_per_tick 1.0 with and without parking; graph replays = decode ticks "
        f"{[f['graph_replays'] for f in figs]}, launches {f0['launches']}")
    log(f"overcommit {name} on {card}: swapped-in blocks equal byte for byte to what left the "
        f"pool: {swaps['checked']} of {swapped}; parked streams against the plain trunk "
        f"teacher-forced on them: {held_n['held']} of {REPEATS * 8 * 2 * OC_TOKENS} tokens "
        f"equal ({held_n['held_after_park']} after a park), {held_n['skipped']} near-ties "
        f"(margin < {FORCED_MARGIN}) skipped, {held_n['flips']} of them flipped by bf16 "
        f"rounding (the widest at margin {held_n['widest_flip']}); unparked waves "
        f"{sum(f['forced_unparked']['held'] for f in figs)} of {REPEATS * 4 * OC_TOKENS}"
        + ("" if probe_forced is None else
           f"; resume probes and fillers {probe_forced['held']} "
           f"({probe_forced['held_after_park']} after a park, {probe_forced['flips']} flips "
           f"skipped, the widest at margin {probe_forced['widest_flip']})")
        + f"; rounds whose streams equal round 0's token for token: {same}"
        + f"; free-running margin rule, to each stream's first near-tie: "
        f"{sum(f['compared_tokens'] for f in figs)} "
        f"equal, {sum(f['margin_cuts'] for f in figs)} cut, "
        f"{sum(f['equal_run_tokens'] for f in figs)} equal before each stream's first "
        "difference from the plain trunk's own stream")
    log(f"overcommit {name} on {card}: eviction wave tokens/s "
        f"{spread([f['eviction_wave_tokens_per_s'] for f in figs])} against unparked "
        f"{spread([f['unparked_wave_tokens_per_s'] for f in figs])} (the second four's first "
        f"turn, median [min, max] over {REPEATS} rounds); TTFT p50, ITL p50, ITL max ms: "
        f"eviction wave " + ", ".join(spread([f["eviction_wave_split"][k] for f in figs])
                                      for k in ("ttft_p50_ms", "itl_p50_ms", "itl_max_ms"))
        + "; unparked " + ", ".join(spread([f["unparked_wave_split"][k] for f in figs])
                                    for k in ("ttft_p50_ms", "itl_p50_ms", "itl_max_ms"))
        + f"; resumes of four at once, ms to each next token: "
        f"{spread([x for f in figs for x in f['resume_ms']])}; swap_drain {drain}")
    for k, r in rates.items():
        if r["swaps"]:
            log(f"overcommit {name} on {card}: in-wave swap-{k} {r['gb_per_s']:.2f} GB/s over "
                f"{r['swaps']} swaps of {r['blocks']} blocks ({spread(r['ms'])} ms a swap)")
    if idle is not None:
        log(f"overcommit {name} on {card}, idle, 9 blocks ({idle['bytes']} bytes): swap-out "
            f"{idle['swap_out']['gb_per_s']:.2f} GB/s ({idle['swap_out']['ms']:.3f} ms), swap-in "
            f"{idle['swap_in']['gb_per_s']:.2f} GB/s ({idle['swap_in']['ms']:.3f} ms); pinned "
            f"copy_ D2H {idle['pinned_d2h']['gb_per_s']:.2f} GB/s, H2D "
            f"{idle['pinned_h2d']['gb_per_s']:.2f} GB/s")
    if probe is not None:
        log(f"overcommit {name} resume latency on {card}, ms from resume() to the next token: "
            + "; ".join(f"{p['cached']} cached tokens: " + ", ".join(
                f"{k} {v:.2f}" for k, v in p.items() if k != "cached") for p in probe))
    return {"rounds": figs, "block_bytes": bpb, "swap_rates": rates, "idle_swap_rates": idle,
            "swap_drain": drain, "resume_probes": probe, "resume_probes_forced": probe_forced,
            "rounds_equal_to_round_0": same,
            "swap_in_blocks_held": swaps["checked"]}


def boundary_park(log, card: str, params, cfg, name: str, serving, prompt, ref, forced) -> dict:
    """One session on a multi-tick or fused engine on graphs, parked after
    OC_TOKENS tokens: the park settles at a flush boundary, where the
    device's length for the slot (the trace's park event names the slot;
    nothing else runs, so it stays as the park left it) equals the tokens
    the stream has in the cache: its prompt and every delivered token but
    the pending one. Resumed, every token of the stream, those after the
    park included, equals the plain trunk teacher-forced on it
    (``forced``); the free-running margin rule against ``ref`` is a
    report."""
    eng, lc, ptrs, captured = oc_engine(params, cfg, serving)
    eng.start()
    try:
        Session(eng, prompt[:64], 2).join()
        s = Session(eng, prompt, OC_LOOP_BUDGET, park_at=OC_TOKENS)
        lc.wait_parked([s])
        cached = cached_at_park(s)
        at_park = s.req.delivered
        device = int(eng.state["len"][lc.slot("park", s)])
        ms = resume_latency(eng, s)
        s.join()
        settle(eng)
    finally:
        eng.stop()
    what = f"overcommit, park on the {name} loop"
    oc_held(eng, ptrs, captured, what)
    if device != cached:
        raise AssertionError(f"{what}: at the park the device holds {device} tokens for the "
                             f"slot, the stream {cached} ({len(prompt)} prompt tokens and "
                             f"{at_park} delivered, the last one pending)")
    st = eng.stats()
    if st["parks"] != 1 or st["resumes"] != 1:
        raise AssertionError(f"{what}: {st['parks']} parks, {st['resumes']} resumes")
    held = check_forced(forced, [(prompt, s.toks, at_park)], what)
    compared, ties = check_streams([s.toks], [ref], what)
    same = equal_run([s.toks], [ref])
    log(f"{what} on {card}: parked at {cached} cached tokens (= the device's length for the "
        f"slot) after {at_park} tokens, resumed in {ms:.2f} ms; {len(s.toks)} tokens, "
        f"{held['held']} equal to the plain trunk teacher-forced on them "
        f"({held['held_after_park']} after the park), {held['skipped']} near-ties skipped "
        f"({held['flips']} flipped, the widest at margin {held['widest_flip']}); "
        f"free-running margin rule, to the first near-tie: {compared} equal, {ties} cut, "
        f"{same} equal before the first difference")
    return {"seq_len": cached, "device_len": device, "delivered_at_park": at_park,
            "resume_ms": ms, "tokens": len(s.toks), "forced": held,
            "compared_tokens": compared, "margin_cuts": ties, "equal_run_tokens": same}


def overcommit_path(log, card: str, params, refs: dict) -> dict:
    """KV overcommit on the flagship at full width and depth, on the default
    pipelined loop on graphs (OC_SERVING): the host tier (kv_swap=36, with
    the resume latency probes of the resident and swap-in paths),
    recompute-only (kv_swap=0, with the recompute probes), the crossover
    (kv_swap_recompute_tokens=1280) and int8 KV with the host tier, each
    one overcommit_wave; then a park on a decode_loop_k=8 engine and on a
    fused (8, 4) one (boundary_park). The counters each arm's traffic
    implies: the first four's 36 blocks evicted by the second four's
    admission (spilled while the host tier has room, else dropped), the
    second four's 36 evicted by the first four's resumes (the first one
    dropped where the tier is still full, the rest spilled into the room
    each swap-in frees), 8 restores."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.serving import ServingConfig

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    cfg8 = dataclasses.replace(cfg, kv_int8=True)
    prompts = overcommit_prompts(cfg.vocab)
    rs = np.random.RandomState(SEED + 4)
    probe_prompts = [rs.randint(0, cfg.vocab, (n - 2,)).astype(np.int32) for n in OC_PROBES]
    fillers = [rs.randint(0, cfg.vocab, (1024,)).astype(np.int32) for _ in range(4)]
    plain = {c.kv_int8: dataclasses.replace(c, use_kernels=False) for c in (cfg, cfg8)}
    forced = {kv: forced_trunk(params, plain[kv]) for kv in plain}
    oc_refs = {kv: [reference_stream(params, plain[kv], p, 2 * OC_TOKENS) for p in prompts]
               for kv in (False, True)}
    probe_refs = [reference_stream(params, plain[False], p, 2 * OC_TOKENS) for p in probe_prompts]
    filler_refs = [reference_stream(params, plain[False], f, 1) for f in fillers]
    base = ServingConfig(**OC_SERVING, max_new_tokens=2 * OC_TOKENS)
    out = {}
    for name, c, kw, expect, paths in (
            ("host tier", cfg, dict(kv_swap=OC_HOST),
             dict(evicted=72, spilled=63, swapped_in=63, spills=7, recomputes=1),
             ("resident", "swap_in")),
            ("recompute-only", cfg, dict(kv_swap=0),
             dict(evicted=72, spilled=0, swapped_in=0, spills=0, recomputes=8), ("recompute",)),
            ("crossover", cfg, dict(kv_swap=OC_HOST, kv_swap_recompute_tokens=1280),
             dict(evicted=72, spilled=63, swapped_in=0, spills=7, recomputes=8), None),
            ("int8 host tier", cfg8, dict(kv_swap=OC_HOST),
             dict(evicted=72, spilled=63, swapped_in=63, spills=7, recomputes=1), None)):
        probes = (probe_prompts, fillers, filler_refs, probe_refs, paths) if paths else None
        out[name] = overcommit_wave(log, card, params, c, name, dataclasses.replace(base, **kw),
                                    prompts, oc_refs[c.kv_int8], forced[c.kv_int8], expect,
                                    probes)
        torch.cuda.empty_cache()
    loop = ServingConfig(slots=4, prefill_buckets=(1024,), kv_page=128, kv_swap=OC_HOST,
                         max_new_tokens=OC_LOOP_BUDGET)
    prompt = wave_prompts(cfg.vocab)[0]
    ref = (refs["bf16"][0][0][:OC_LOOP_BUDGET], refs["bf16"][0][1][:OC_LOOP_BUDGET])
    for name, kw in (("device_loop", dict(decode_loop_k=LOOP_K)),
                     ("fused", dict(decode_loop_k=LOOP_K, spec_tokens=SPEC_K))):
        out[name] = boundary_park(log, card, params, cfg, name,
                                  dataclasses.replace(loop, **kw), prompt, ref, forced[False])
        torch.cuda.empty_cache()
    return out


# the failure-domain phase: tokens a request in its deadline, containment,
# overcommit and death arms, in the watchdog's waves, and the deadline
# rewind's token
FD_TOKENS = 16
FD_WAVE_TOKENS = 64
FD_REWIND_AT = 4
# a delayed_fetch stalls this many watchdog thresholds; the LIFO engine's
# recovery window (ms of healthy fetches a rung)
FD_STALLS = 3
FD_RECOVER_MS = 20.0
FD_EVENTS = ("shed", "fault", "degrade", "recover", "park", "evict", "fault_recompute",
             "swap_in")


def fd_serving(**kw):
    """The flagship's serving config of phase j (bench.py's tenants) with
    ``kw``."""
    from vtpu_torch.serving import ServingConfig

    return ServingConfig(**{**dict(slots=4, prefill_buckets=(1024,), kv_page=128,
                                   max_new_tokens=FD_TOKENS), **kw})


def on_token(req, n: int, action) -> None:
    """Run ``action()`` on the loop thread right after ``req`` puts its n-th
    token on the stream (inside that delivery)."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if isinstance(item, int):
            seen[0] += 1
            if seen[0] == n:
                action()

    req.out.put = hook


def fd_engine(params, cfg, serving):
    """An engine of phase j on graphs, with its Lifecycle over FD_EVENTS,
    its state addresses and its graph count."""
    from vtpu_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, serving)
    if not eng._graph_sets():
        raise AssertionError("a phase j engine does not serve on CUDA graphs")
    return (eng, Lifecycle(eng, FD_EVENTS), {k: x.data_ptr() for k, x in eng.state.items()},
            eng.stats()["graphs_captured"])


def fd_free(eng, ptrs: dict, captured: int, what: str) -> dict:
    """After stop(): oc_held's checks, the pool (and the host tier) free;
    returns stats()."""
    oc_held(eng, ptrs, captured, what)
    st = eng.stats()
    if st["kv_pool_free"] != st["kv_pool_blocks"]:
        raise AssertionError(f"{what}: {st['kv_pool_blocks'] - st['kv_pool_free']} pool blocks "
                             "still held after the arm")
    if st["swap_host_blocks"] and st["swap_host_free"] != st["swap_host_blocks"]:
        raise AssertionError(f"{what}: host tier not free after the arm")
    return st


def fd_held(forced, prompts, recs: list, what: str, after=None) -> dict:
    """Every stream of ``recs`` (reader records or token lists) against the
    plain trunk teacher-forced on it (check_forced); ``after[i]`` is the
    index of request i's first token after a park, none by default."""
    held = []
    for i, (prompt, rec) in enumerate(zip(prompts, recs)):
        toks = rec["toks"] if isinstance(rec, dict) else rec
        if toks:
            held.append((prompt, toks, len(toks) if after is None else after[i]))
    return check_forced(forced, held, what)


def fd_shed_arm(log, card, params, cfg, forced, name: str, policy, expect: dict) -> dict:
    """Arm 1: eight prompts, priorities 0-7, queued before start() on a
    one-deep waiting line. The first tick head sheds the deadline-0 request
    (index 5) before admission, admits four, and sheds what still overflows
    by ``policy``; request 0's deadline is rewound white-box after its
    FD_REWIND_AT-th token, so it ends SHED_DEADLINE at the next tick head.
    ``expect``: the statuses by index. Counters from stats() and the
    trace's shed events; every untouched stream and every shed prefix
    held."""
    from vtpu_torch.obs.trace import TERMINAL_CODES

    prompts = overcommit_prompts(cfg.vocab)
    eng, lc, ptrs, captured = fd_engine(params, cfg, fd_serving(
        shed_queue_depth=1, shed_policy=policy, max_new_tokens=2 * FD_TOKENS))
    reqs = [eng.submit(p, priority=i, deadline_ms={0: 600e3, 5: 0}.get(i))
            for i, p in enumerate(prompts)]
    on_token(reqs[0], FD_REWIND_AT, lambda: setattr(reqs[0], "deadline_ns",
                                                    time.monotonic_ns() - 1))
    t0 = time.perf_counter()
    eng.start()
    try:
        streams = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    wall = time.perf_counter() - t0
    what = f"failure domains, shed arm ({name})"
    st = fd_free(eng, ptrs, captured, what)
    statuses = [r.status for r in reqs]
    if statuses != expect["statuses"]:
        raise AssertionError(f"{what}: statuses {statuses}, expected {expect['statuses']}")
    if (st["shed_deadline"], st["shed_overload"]) != (2, expect["overload"]):
        raise AssertionError(f"{what}: shed_deadline {st['shed_deadline']}, shed_overload "
                             f"{st['shed_overload']}, expected 2 and {expect['overload']}")
    sheds = sorted((rid, val) for _, rid, val in lc.events("shed"))
    want = sorted([(0, TERMINAL_CODES["SHED_DEADLINE"]), (5, TERMINAL_CODES["SHED_DEADLINE"])]
                  + [(i, TERMINAL_CODES["SHED_OVERLOAD"]) for i, s in enumerate(statuses)
                     if s == "SHED_OVERLOAD"])
    if sheds != want:
        raise AssertionError(f"{what}: the trace's shed events {sheds}, expected {want}")
    if not FD_REWIND_AT <= len(streams[0]) < 2 * FD_TOKENS:
        raise AssertionError(f"{what}: the rewound request delivered {len(streams[0])} tokens")
    for i, s in enumerate(statuses):
        want_len = {"OK": 2 * FD_TOKENS, "SHED_OVERLOAD": 0}.get(s)
        if i != 0 and (s == "SHED_DEADLINE" and streams[i] or
                       want_len is not None and len(streams[i]) != want_len):
            raise AssertionError(f"{what}: request {i} ended {s} after {len(streams[i])} tokens")
    held = fd_held(forced, prompts, streams, what)
    log(f"{what} on {card}: statuses {statuses}; shed_deadline {st['shed_deadline']}, "
        f"shed_overload {st['shed_overload']}; the rewound request cut after "
        f"{len(streams[0])} tokens; {held['held']} tokens held against the teacher-forced "
        f"trunk, {held['skipped']} near-ties skipped; {wall:.2f} s")
    return {"statuses": statuses, "shed_deadline": st["shed_deadline"],
            "shed_overload": st["shed_overload"], "forced": held, "wall_s": wall}


def fd_containment_arm(log, card, params, cfg, forced) -> dict:
    """Arm 2: dispatch_exc at its 6th arrival on the main path's wave: one
    request FAULTED (the trace's fault event names it), the counters
    exact, every other stream and the faulted one's prefix held."""
    from vtpu_torch.serving import FaultPlan, FaultSpec

    prompts = wave_prompts(cfg.vocab)
    plan = FaultPlan([FaultSpec("dispatch_exc", at=5)])
    eng, lc, ptrs, captured = fd_engine(params, cfg, fd_serving(faults=plan))
    eng.start()
    try:
        recs, wall = stream_all(eng, prompts)
    finally:
        eng.stop()
    what = "failure domains, dispatch_exc"
    st = fd_free(eng, ptrs, captured, what)
    statuses = [rec["status"] for rec in recs]
    faults = [rid for _, rid, _ in lc.events("fault")]
    if sorted(statuses) != ["FAULTED"] + ["OK"] * (len(prompts) - 1) or faults != [
            statuses.index("FAULTED")]:
        raise AssertionError(f"{what}: statuses {statuses}, fault events for {faults}")
    if (st["faulted_requests"], st["faults_injected"]) != (1, 1):
        raise AssertionError(f"{what}: faulted_requests {st['faulted_requests']}, "
                             f"faults_injected {st['faults_injected']}")
    held = fd_held(forced, prompts, recs, what)
    log(f"{what} on {card}: request {faults[0]} FAULTED after "
        f"{len(recs[faults[0]]['toks'])} tokens, the rest OK; faulted_requests 1, "
        f"faults_injected 1; {held['held']} tokens held")
    return {"statuses": statuses, "forced": held, "wall_s": wall}


def fetch_p99_ms(before: list, after: list) -> float:
    """The upper bucket edge (ms) of the 99th percentile of the fetch phase
    between two snapshots of the engine's tick profiler's fetch histogram
    counts (the +Inf bucket reads as its lower edge)."""
    from vtpu_torch.obs.tickprof import PHASE_BUCKETS_MS

    counts = [a - b for a, b in zip(after, before)]
    need, acc = 0.99 * sum(counts), 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= need:
            return PHASE_BUCKETS_MS[min(i, len(PHASE_BUCKETS_MS) - 1)]
    return PHASE_BUCKETS_MS[-1]


def fd_watchdog_arm(log, card, params, cfg, forced) -> dict:
    """Arm 3: the fetch watchdog's ladder on the kernel route with
    decode_loop_k=8, the flagship's wave at FD_WAVE_TOKENS a request.

    The threshold T = max(20 ms, 10 x the fetch phase's p99 over a warm
    wave of an engine without the watchdog). A one-way engine (no
    recovery) serves three healthy waves, then a stall of FD_STALLS x T
    (the plan armed between waves) applies rung 1 and three waves run on
    one-token flushes, then another applies rung 2 and three waves run on
    the gather graphs: tokens/s of each. Rung 1's design: a 8-tick flush
    capped at one token against the one-token flush, device ms a replay.
    A second engine with a recovery window takes two stalls in a row and
    recovers: the trace's degrade, degrade, recover, recover in LIFO order.
    On both: no capture while serving, the gather sets record no paged
    launch, paged launches = n_layers x the ticks counted on the kernel
    route, every stream held. Graph-pool bytes of an engine with and
    without the watchdog's extra sets."""
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import FaultPlan, FaultSpec

    prompts = wave_prompts(cfg.vocab)
    base = dict(decode_loop_k=LOOP_K, max_new_tokens=FD_WAVE_TOKENS)
    eng0, mem0 = build_engine(params, cfg, fd_serving(**base))
    fetch = eng0.tick_profile.phases["fetch"]
    eng0.start()
    try:
        stream_all(eng0, prompts)  # warms the engine
        before = list(fetch.counts)
        stream_all(eng0, prompts)
        after = list(fetch.counts)
    finally:
        eng0.stop()
    p99 = fetch_p99_ms(before, after)
    thr = max(20.0, 10.0 * p99)
    stall = FD_STALLS * thr / 1e3
    del eng0
    torch.cuda.empty_cache()
    paged = "paged_decode_attention"
    out = {"fetch_p99_ms": p99, "threshold_ms": thr, "stall_s": stall,
           "graph_pool_bytes": {"healthy": mem0["graphs"]}}

    plan = FaultPlan()
    eng, mem1 = build_engine(params, cfg, fd_serving(**base, fetch_watchdog_ms=thr,
                                                     faults=plan))
    out["graph_pool_bytes"]["watchdog"] = mem1["graphs"]
    lc = Lifecycle(eng, FD_EVENTS)
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    captured = eng.stats()["graphs_captured"]
    gather = eng.route_graphs["gather"]
    buckets = eng._kv_buckets
    for key in ("flush", "flush1"):
        for b in buckets:
            if (paged in gather[key].launches(b)
                    or paged not in eng.route_graphs[None][key].launches(b)):
                raise AssertionError(f"watchdog: the {key} graph of bucket {b} launches "
                                     f"{gather[key].launches(b)} on the gather route")
    _build.reset_launches()
    eng.start()
    held, tps = [], {}
    try:
        for stage in ("healthy", "rung 1", "rung 2"):
            if stage != "healthy":
                plan.arm("delayed_fetch", arg=stall)
                recs, _ = stream_all(eng, prompts[:1])  # the stall and the degrade
                held.append((prompts[:1], recs))
            waves = [stream_all(eng, prompts) for _ in range(REPEATS)]
            tps[stage] = [sum(len(r["toks"]) for r in recs) / wall for recs, wall in waves]
            held += [(prompts, recs) for recs, _ in waves]
    finally:
        eng.stop()
    what = "failure domains, watchdog (one-way)"
    st = fd_free(eng, ptrs, captured, what)
    launched = _build.launches()[paged]
    ladder = [(e, v) for e, _, v in lc.events("degrade", "recover")]
    if ladder != [("degrade", 1), ("degrade", 2)] or st["watchdog_degrades"] != 2:
        raise AssertionError(f"{what}: ladder {ladder}, degrades {st['watchdog_degrades']}")
    if launched != FLAGSHIP["n_layers"] * st["paged_attn_kernel_ticks"] or not st[
            "paged_attn_gather_ticks"]:
        raise AssertionError(f"{what}: {launched} paged launches for "
                             f"{st['paged_attn_kernel_ticks']} kernel-route ticks, "
                             f"{st['paged_attn_gather_ticks']} gather ticks")
    replays = {name: g.replays for name, g in (
        ("flush", eng.route_graphs[None]["flush"]), ("flush1", eng.route_graphs[None]["flush1"]),
        ("gather flush1", gather["flush1"]), ("gather flush", gather["flush"]))}
    if not (replays["flush1"] and replays["gather flush1"]) or replays["gather flush"]:
        raise AssertionError(f"{what}: replays by set {replays}")
    for recs_prompts, recs in held:
        for rec in recs:
            if rec["status"] != "OK" or len(rec["toks"]) != FD_WAVE_TOKENS:
                raise AssertionError(f"{what}: a stream ended {rec['status']} after "
                                     f"{len(rec['toks'])} tokens")
    forced_held = fd_held(forced, [p for ps, recs in held for p in ps],
                          [r for _, recs in held for r in recs], what)
    # rung 1's design: a k-tick flush capped at one token still runs its k
    # inner ticks; the one-token flush runs one
    b = eng.serving.slots
    zeros = torch.zeros((b,), dtype=torch.int32, device="cuda")
    idle = torch.zeros((b,), dtype=torch.bool, device="cuda")
    ones = torch.ones((b,), dtype=torch.int32, device="cuda")
    bkt = buckets[-1]
    rung1 = {}
    for key in ("flush", "flush1"):
        g = eng.route_graphs[None][key]
        rung1[key], _ = time_ms(lambda _, g=g: g(eng.params, eng.state, zeros, idle, ones,
                                                 eng._gens, bkt), iters=20)
    out.update({"tokens_per_s": tps, "ladder": ladder, "replays": replays,
                "paged_launches": launched, "kernel_ticks": st["paged_attn_kernel_ticks"],
                "gather_ticks": st["paged_attn_gather_ticks"], "forced": forced_held,
                "capped_flush_ms": rung1["flush"], "one_token_flush_ms": rung1["flush1"]})
    del eng, gather
    torch.cuda.empty_cache()

    # the ladder both ways: two stalls in a row, then the recovery window
    plan2 = FaultPlan([FaultSpec("delayed_fetch", at=2, count=2, arg=stall)])
    eng, lc, ptrs, captured = fd_engine(params, cfg, fd_serving(
        **base, fetch_watchdog_ms=thr, fetch_watchdog_recover_ms=FD_RECOVER_MS, faults=plan2))
    _build.reset_launches()
    eng.start()
    try:
        recs, _ = stream_all(eng, prompts)
    finally:
        eng.stop()
    what = "failure domains, watchdog ladder (LIFO)"
    st = fd_free(eng, ptrs, captured, what)
    ladder2 = [(e, v) for e, _, v in lc.events("degrade", "recover")]
    if ladder2 != [("degrade", 1), ("degrade", 2), ("recover", 1), ("recover", 0)] or (
            st["watchdog_degrades"], st["watchdog_recoveries"]) != (2, 2):
        raise AssertionError(f"{what}: ladder {ladder2}, degrades {st['watchdog_degrades']}, "
                             f"recoveries {st['watchdog_recoveries']}")
    if eng._degrade_rungs != ["loop_k1", "paged_gather"] or eng._paged_attn is not None:
        raise AssertionError(f"{what}: rungs {eng._degrade_rungs}, route {eng._paged_attn}")
    if _build.launches()[paged] != FLAGSHIP["n_layers"] * st["paged_attn_kernel_ticks"] or not st[
            "paged_attn_gather_ticks"]:
        raise AssertionError(f"{what}: paged launches {_build.launches()[paged]}, kernel ticks "
                             f"{st['paged_attn_kernel_ticks']}")
    if any(r["status"] != "OK" or len(r["toks"]) != FD_WAVE_TOKENS for r in recs):
        raise AssertionError(f"{what}: a stream ended short")
    lifo_held = fd_held(forced, prompts, recs, what)
    out.update({"ladder_lifo": ladder2, "lifo_forced": lifo_held})
    del eng
    torch.cuda.empty_cache()
    med = {k: sorted(v)[len(v) // 2] for k, v in tps.items()}
    log(f"failure domains, watchdog on {card}: warm fetch p99 {p99} ms (bucket edge), "
        f"threshold {thr:.1f} ms, stalls {stall * 1e3:.0f} ms; tokens/s median [min, max] "
        + ", ".join(f"{k} {spread(v)}" for k, v in tps.items())
        + f" ({med['rung 1'] / med['healthy']:.2f}x and {med['rung 2'] / med['healthy']:.2f}x "
        f"healthy); one-way ladder {ladder}, LIFO ladder {ladder2}; replays {replays}; paged "
        f"launches {launched} = 12 x {out['kernel_ticks']} kernel-route ticks, gather ticks "
        f"{out['gather_ticks']}; a {LOOP_K}-tick flush capped "
        f"at one token {rung1['flush']:.4f} ms a replay against the one-token flush "
        f"{rung1['flush1']:.4f} ms ({rung1['flush'] / rung1['flush1']:.2f}x); graph pools "
        f"{mem0['graphs'] / 2**20:.1f} MiB without the watchdog, {mem1['graphs'] / 2**20:.1f} "
        f"MiB with its one-token flush and gather sets; {forced_held['held']} + "
        f"{lifo_held['held']} tokens held against the teacher-forced trunk")
    return out


def resume_in_one_pass(eng, sessions: list) -> None:
    """Resume ``sessions`` so that the loop thread takes every resume in one
    lifecycle pass, in this order: the first from here, each later one from
    inside the pass that records the first's ``resume`` event (the pass
    drains the command queue until it is empty). Their order in the resume
    queue then does not hang on the loop's timing."""
    record, first = eng.trace.record, sessions[0].req.rid

    def hooked(event, rid, *a, **kw):
        record(event, rid, *a, **kw)
        if event == "resume" and rid == first:
            eng.trace.record = record
            for s in sessions[1:]:
                eng.resume(s.req)

    eng.trace.record = hooked
    eng.resume(sessions[0].req)


def fd_overcommit_arm(log, card, params, cfg, forced) -> dict:
    """Arm 4: the overcommit engine of phase i (kv_pool_blocks=37,
    kv_swap=36, prefill_chunk=256) under a plan of one alloc_exhaust, one
    swap_d2h_loss and one swap_h2d_loss, each at its seam's first arrival.
    Two sessions admit (the first reservation finds the pool dry once and
    backs off), stream FD_TOKENS and park; three more admit, the last of
    which evicts the least recently parked of the first two, whose spill
    is lost (its pages drop); they stream and park. The first two resume
    in one lifecycle pass, the resident one first (it remaps), then the
    dropped one, which rebuilds through prefill and so evicts a parked one
    of the second wave to the host tier; they finish. Then the second
    three resume, and the swapped one's restore is lost (it rebuilds
    through prefill). Which of the first two parked first is the loop's
    timing; the resume order follows the eviction, so nothing else is.
    Held:
    every token of every stream, those after each resume, the counters
    the plan implies, pool and host tier free, no host wait in a swap
    dispatch."""
    from vtpu_torch.serving import FaultPlan, FaultSpec

    plan = FaultPlan([FaultSpec("alloc_exhaust"), FaultSpec("swap_d2h_loss"),
                      FaultSpec("swap_h2d_loss")])
    prompts = overcommit_prompts(cfg.vocab)[:5]
    eng, lc, ptrs, captured = fd_engine(params, cfg, fd_serving(
        **OC_SERVING, kv_swap=OC_HOST, max_new_tokens=2 * FD_TOKENS, faults=plan))
    guard_sync(eng)
    eng.start()
    try:
        first = [Session(eng, p, 2 * FD_TOKENS, park_at=FD_TOKENS) for p in prompts[:2]]
        lc.wait_parked(first)
        second = [Session(eng, p, 2 * FD_TOKENS, park_at=FD_TOKENS) for p in prompts[2:]]
        lc.wait_parked(second)
        dropped = [i for i, s in enumerate(first) for _, r, _ in lc.events("evict")
                   if r == s.req.rid]
        if len(dropped) != 1 or len(lc.events("evict")) != 1:
            raise AssertionError("failure domains, overcommit seams: the second wave's "
                                 f"admission evicted {lc.events('evict')}, not one of the first")
        for s in first:
            drained(s)
        resume_in_one_pass(eng, [first[1 - dropped[0]], first[dropped[0]]])
        for s in first:
            s.join()
        for s in second:
            drained(s)
            eng.resume(s.req)
        for s in second:
            s.join()
    finally:
        eng.stop()
    what = "failure domains, overcommit seams"
    st = fd_free(eng, ptrs, captured, what)
    sessions = first + second
    rid = {s.req.rid: i for i, s in enumerate(sessions)}
    evicts = [rid[r] for _, r, _ in lc.events("evict")]
    rebuilt = sorted(rid[r] for _, r, _ in lc.events("fault_recompute"))
    swapped = sorted(rid[r] for _, r, _ in lc.events("swap_in"))
    got = {k: st[k] for k in ("faults_injected", "pool_blocked_admissions", "fault_recomputes",
                              "swap_faults", "parks", "resumes", "evicted_blocks")}
    want = {"faults_injected": 3, "pool_blocked_admissions": 1, "fault_recomputes": 2,
            "swap_faults": 2, "parks": 5, "resumes": 5, "evicted_blocks": 18}
    # one eviction from each wave, each rebuilt: the first's spill was lost,
    # the second's restore
    if (got != want or len(evicts) != 2 or evicts[0] > 1 or evicts[1] < 2
            or rebuilt != sorted(evicts) or swapped):
        raise AssertionError(f"{what}: counters {got} (expected {want}), evictions of sessions "
                             f"{evicts}, rebuilt {rebuilt}, swapped in {swapped}")
    held = check_forced(forced, [(s.prompt, s.toks, FD_TOKENS) for s in sessions], what)
    log(f"{what} on {card}: {got}; evicted sessions {evicts} (the first's spill lost), "
        f"rebuilt {rebuilt}; {held['held']} tokens held ({held['held_after_park']} after a "
        f"park), {held['skipped']} near-ties skipped")
    return {"counters": got, "evicted": evicts, "rebuilt": rebuilt, "forced": held}


def fd_death_arm(log, card, params, cfg, forced) -> dict:
    """Arm 5: engine_death armed inside the delivery of a live wave's
    second token: the loop thread exits within 5 s without its cleanup (no
    terminal reaches the live streams), the heartbeat stops, stop()
    returns; once the dead engine is dropped, a fresh engine serves one
    request held against the trunk."""
    import gc

    from vtpu_torch.serving import FaultPlan

    prompts = wave_prompts(cfg.vocab)[:4]
    plan = FaultPlan()
    eng, _, _, _ = fd_engine(params, cfg, fd_serving(max_new_tokens=4 * FD_TOKENS,
                                                     faults=plan))
    reqs = [eng.submit(p) for p in prompts]
    on_token(reqs[0], 2, lambda: plan.arm("engine_death"))
    eng.start()
    eng._thread.join(timeout=5)
    what = "failure domains, engine_death"
    if eng._thread.is_alive() or not eng._died or eng.loop_error is not None:
        raise AssertionError(f"{what}: the loop thread is alive {eng._thread.is_alive()}, died "
                             f"{eng._died}, error {eng.loop_error!r}")
    beat = eng._beat_ns
    time.sleep(0.2)
    t0 = time.perf_counter()
    eng.stop()
    stop_s = time.perf_counter() - t0
    if eng._beat_ns != beat or any(r.status is not None for r in reqs):
        raise AssertionError(f"{what}: the heartbeat moved or a terminal reached a stream")
    delivered = [r.delivered for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    fresh, _, ptrs, captured = fd_engine(params, cfg, fd_serving())
    req = fresh.submit(prompts[0])
    fresh.start()
    try:
        toks = list(req.stream())
    finally:
        fresh.stop()
    fd_free(fresh, ptrs, captured, what + ", fresh engine")
    if req.status != "OK" or len(toks) != FD_TOKENS:
        raise AssertionError(f"{what}: the fresh engine's stream ended {req.status}")
    held = check_forced(forced, [(prompts[0], toks, len(toks))], what)
    log(f"{what} on {card}: the loop thread exited without cleanup after {delivered} tokens, "
        f"no terminal, heartbeat still; stop() returned in {stop_s * 1e3:.1f} ms; a fresh "
        f"engine served {len(toks)} tokens, {held['held']} held")
    return {"delivered": delivered, "stop_ms": stop_s * 1e3, "forced": held}


def failure_domains_path(log, card: str, params) -> dict:
    """Phase j: the failure domains on the flagship at full width and depth,
    on the pipelined loop on graphs (the watchdog arm on decode_loop_k=8):
    deadlines and overload shedding with the default, a custom and a
    raising policy; dispatch_exc containment; the watchdog's ladder; the
    overcommit seams; engine death. Every stream a fault or shed does not
    touch, and every shed or faulted stream's prefix, is held against the
    plain trunk teacher-forced on it."""
    from vtpu_torch.models import ModelConfig

    class HighestFirst:
        def select(self, waiters, need):
            return sorted(waiters, key=lambda r: -r.priority)[:need]

    class Raising:
        def select(self, waiters, need, signals=None):
            raise RuntimeError("a policy bug")

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    forced = forced_trunk(params, dataclasses.replace(cfg, use_kernels=False))
    t0 = time.perf_counter()
    ok, sd, so = "OK", "SHED_DEADLINE", "SHED_OVERLOAD"
    out = {"shed": {}}
    for name, policy, statuses, overload in (
            ("default policy", None, [sd, ok, ok, ok, so, sd, so, ok], 2),
            ("highest priority first", HighestFirst, [sd, ok, ok, ok, ok, sd, so, so], 2),
            ("raising policy", Raising, [sd, ok, ok, ok, ok, sd, ok, ok], 0)):
        out["shed"][name] = fd_shed_arm(log, card, params, cfg, forced, name, policy,
                                        {"statuses": statuses, "overload": overload})
    out["dispatch_exc"] = fd_containment_arm(log, card, params, cfg, forced)
    out["watchdog"] = fd_watchdog_arm(log, card, params, cfg, forced)
    out["overcommit"] = fd_overcommit_arm(log, card, params, cfg, forced)
    out["engine_death"] = fd_death_arm(log, card, params, cfg, forced)
    out["seconds"] = time.perf_counter() - t0
    log(f"failure domains phase on {card}: {out['seconds']:.1f} s")
    return out


# phase k, the model families: the MoE at the flagship trunk's widths with
# the reference MoEConfig's expert geometry (top-2 of 8 experts of width
# 2048: the dense flagship's FFN work a token), and the selective SSM of
# benchmarks/mfu_bench.py
MOE_FLAGSHIP = dict(vocab=8192, d_model=1024, n_heads=8, n_layers=12, d_ff=2048, n_experts=8,
                    top_k=2, capacity_factor=2.0, max_seq=1280, head_dim=128)
SSM_FLAGSHIP = dict(vocab=8192, d_model=1024, n_layers=12, d_state=16)
# the serving config's one prefill bucket (an admission is [N, FAMILY_BUCKET])
FAMILY_BUCKET = 1024
FAMILY_TOKENS = 16
# a greedy step is skipped by check_routed where, in the plain decode fed
# the stream, the step's token has a layer whose k-th and (k+1)-th expert
# probabilities lie closer than this: the kernel route's rounding may send
# it to the other expert, which moves the hidden state by a whole expert's
# output. Phase k prints, every run, how many steps each candidate margin
# holds and the flips it would not skip (PERF.md §6 has the H100's)
ROUTE_MARGIN = 0.005
# each MoE arm holds at least FAMILY_HELD steps of distinct streams, and
# each loop arm compares at least FAMILY_MATCHED distinct streams with the
# pipelined arm's on the same admission: an arm serves more waves, each of
# new prompts (family_prompts), until it does, FAMILY_MAX_WAVES at most
FAMILY_HELD = 40
FAMILY_MATCHED = 3
FAMILY_MAX_WAVES = 6
FAMILY_LOOPS = {"device_loop": {"decode_loop_k": LOOP_K},
                "spec": {"spec_tokens": SPEC_K, "spec_min_mean": 0.0},
                "fused": {"decode_loop_k": LOOP_K, "spec_tokens": SPEC_K, "spec_min_mean": 0.0}}


def family_prompts(vocab: int, j: int) -> list[np.ndarray]:
    """Phase k's prompt set ``j``: the serving wave (wave_prompts) for 0,
    else six more prompts of 600-1024 tokens from SEED + 100 + j."""
    if not j:
        return wave_prompts(vocab)
    rs = np.random.RandomState(SEED + 100 + j)
    return [rs.randint(0, vocab, (int(n),)).astype(np.int32) for n in rs.randint(600, 1025, 6)]


def admission_key(admission: tuple) -> tuple:
    """A hashable key of an admission (moe_forced_trunk's ``admission``)."""
    if admission[0] == "batch":
        return ("batch", tuple(p.tobytes() for p in admission[1]), admission[2])
    return ("chunks", None if admission[1] is None else admission[1].tobytes())


def moe_forced_trunk(params, served, plain, serving):
    """The plain MoE trunk teacher-forced on a stream, behind the stream's
    admission replayed as the engine ran it: ``ref(prompt, toks,
    admission)`` -> (its greedy choice, its top-1/top-2 logit margin, its
    routing gap) at every step of ``toks`` (with ``differs``, up to the
    first step whose choice is not the stream's token); ``drops`` counts the replayed
    admissions' dropped and routed choices.

    ``admission`` says how the engine admitted the stream:
    - ("batch", rows, i): one bucketed dispatch of ``rows`` (its prompts in
      row order), the stream in row i. The batch is prefilled as the
      adapter prefills it, under ``served`` (the engine's config, with the
      flash route when it uses kernels): ``moe_prefill`` at [N,
      FAMILY_BUCKET] with each row's true length, so pads are masked out of
      routing, capacity follows the config's formula over the batch, and
      the first token and the KV are the engine's, dropped choices included.
    - ("chunks", prefix): a chunked admission after the registered
      ``prefix`` tokens (or None): the prefix, then the prompt, go through
      the chunk trunk under ``served`` on a one-row dense cache, at the
      engine's chunk grid and read windows (``serving``).
    The row then decodes alone on a one-row dense cache under ``plain``
    (use_kernels False, eager), fed the stream's own tokens as one chunk
    (every step in one pass, forced_steps), so a later
    step differs from the engine's only by the decode's rounding (the paged
    kernel's and the batched step's against the plain one-row step). A
    step's routing gap is the smallest, over the layers, of its token's
    k-th less (k+1)-th expert probability: in the plain decode, and at step
    0 in the replayed admission."""
    from vtpu_torch.models import init_kv_cache
    from vtpu_torch.models.moe import moe_decode_ffn, moe_ffn, moe_prefill, route
    from vtpu_torch.ops import rms_norm
    from vtpu_torch.serving.engine import chunked_prefill_into_slot, pad_to_chunks

    k = plain.top_k
    dev = params["embed"].device
    gaps: list = []
    drops = {"dropped": 0, "choices": 0}
    ctx = served.max_seq
    windows = sorted({min(b, ctx) for b in serving.prefill_buckets} | {ctx})
    chunk = serving.prefill_chunk

    def gap(lp, normed):
        top = torch.topk(torch.softmax(normed.float() @ lp["router"], dim=-1), k + 1).values
        return top[..., k - 1] - top[..., k]

    def hooked(ffn):
        def fn(lp, x):
            gaps.append(gap(lp, rms_norm(x, lp["mlp_norm"])))
            return ffn(lp, x)
        return fn

    decode_ffn, chunk_ffn = hooked(moe_decode_ffn(plain)), hooked(moe_decode_ffn(served))

    def prefill_ffn(lp, normed, cfg_, capacity=None, pad_mask=None):
        last = pad_mask.sum(dim=1) - 1  # each row's last real position
        gaps.append(gap(lp, normed[torch.arange(normed.shape[0], device=dev), last]))
        flat = normed.reshape(-1, normed.shape[-1])
        dispatch, _, _ = route(lp["router"], flat, cfg_, cfg_.capacity(flat.shape[0]),
                               pad_mask=pad_mask.reshape(-1))
        real = int(pad_mask.sum()) * k
        drops["dropped"] += real - int(dispatch.sum())
        drops["choices"] += real
        return moe_ffn(lp, normed, cfg_, capacity=capacity, pad_mask=pad_mask)

    def run_chunks(cache, toks, base):
        # the engine's grid: chunks from ``base``, the window covering each
        n = base + len(toks)
        padded = pad_to_chunks(toks, len(toks), chunk).to(dev)
        pad = padded.shape[1]
        for off in range(0, pad, chunk):
            gaps.clear()
            window = next((w for w in windows if w >= base + off + chunk), ctx)
            logits, cache = chunked_prefill_into_slot(
                params, served, cache, padded[:, off:off + chunk], 0, base + off,
                min(base + off + chunk, n), kv_bucket=window, ffn_fn=chunk_ffn)
        at = (n - base - 1) - (pad - chunk)
        return logits[0, at], float(torch.stack([g[0, at] for g in gaps]).min()), cache

    admitted: dict = {}

    def admit(prompt, admission):
        """(the first token's logits [vocab], the stream's one-row KV, the
        step-0 routing gap)."""
        if admission[0] == "batch":
            _, rows, i = admission
            key = admission_key(admission)[:2]
            if key not in admitted:
                lens = torch.tensor([len(p) for p in rows], device=dev)
                padded = np.zeros((len(rows), FAMILY_BUCKET), np.int32)
                for j, p in enumerate(rows):
                    padded[j, :len(p)] = p
                gaps.clear()
                last, kv = moe_prefill(params, served, torch.from_numpy(padded).to(dev),
                                       true_len=lens, logits_at=lens - 1, ffn=prefill_ffn)
                admitted[key] = (last, kv, torch.stack(gaps))
            last, kv, step0 = admitted[key]
            one = {name: x[:, i:i + 1].clone() for name, x in kv.items() if name != "len"}
            one["len"] = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
            return last[i], one, float(step0[:, i].min())
        prefix, base = admission[1], 0
        one = init_kv_cache(served, 1, device=dev)
        if prefix is not None:
            key = admission_key(admission)
            if key not in admitted:
                admitted[key] = run_chunks(one, prefix, 0)[2]
            one = {name: x.clone() for name, x in admitted[key].items()}
            base = len(prefix)
        row, step0, one = run_chunks(one, prompt, base)
        return row, one, step0

    runs_of: dict = {}

    def ref(prompt: np.ndarray, toks: list, admission: tuple,
            differs: bool = False) -> tuple[list, list, list]:
        runs = runs_of.setdefault((prompt.tobytes(), admission_key(admission)), [])
        for got, res in runs:
            if got[:len(toks)] == list(toks):
                return tuple(r[:len(toks)] for r in res)
        res = forced(prompt, list(toks), admission)
        if differs:
            # the caller reads no step past the first that differs
            cut = next((j + 1 for j, (w, t) in enumerate(zip(res[0], toks)) if w != t),
                       len(toks))
            res = tuple(r[:cut] for r in res)
        runs.append((list(toks[:len(res[0])]), res))
        return res

    def forced_steps(prompt, toks, admission):
        """Every step of the stream in one pass: the admission's first-token
        logits, then the stream's tokens but its last as one chunk through
        the plain decode trunk over the admitted row's cache (each query
        sees the cache up to its own position; routing per token, nothing
        dropped: moe_decode_ffn's capacity is the chunk's token count)."""
        row, kv, g0 = admit(prompt, admission)
        rows, route_gaps = [row[None]], [g0]
        if len(toks) > 1:
            n = int(kv["len"][0])
            gaps.clear()
            logits, _ = chunked_prefill_into_slot(
                params, plain, kv, torch.tensor([toks[:-1]], dtype=torch.int32, device=dev),
                0, n, n + len(toks) - 1, ffn_fn=decode_ffn)
            rows.append(logits[0])
            # a step's gap: the smallest over the layers at its query
            route_gaps += torch.stack(gaps).amin(dim=(0, 1)).tolist()
        want, margins = choices(torch.cat(rows), "plain MoE trunk")
        return want, margins, route_gaps

    forced = trunk_timed("forced", forced_steps, lambda prompt, toks, admission: len(toks))
    ref.drops = drops
    return ref


def admission_batches(life) -> dict:
    """{rid: (the rids of its admission dispatch in row order, its row)} of
    every bucketed admission in the engine's trace (``life``: a Lifecycle
    watching queue_depart, admit and prefill_chunk). A dispatch records its
    requests' queue_depart events in row order and then their admit
    events, so a run of admit events is one dispatch (the serial path's is
    a run of one); a run that is not the tail of the departures before it
    raises. Chunked admissions (prefill_chunk events) are left out."""
    seq = life.events("queue_depart", "admit", "prefill_chunk")
    chunked = {rid for ev, rid, _ in seq if ev == "prefill_chunk"}
    out, run = {}, []
    for j, (ev, rid, _) in enumerate(seq + [("end", -1, 0)]):
        if ev == "admit" and rid not in chunked:
            run.append(rid)
            continue
        if run:
            departed = [r for e, r, _ in seq[:j - len(run)]
                        if e == "queue_depart" and r not in chunked][-len(run):]
            if departed != run:
                raise AssertionError(f"admission trace: a dispatch admitted {run} after the "
                                     f"departures {departed}")
            for i, r in enumerate(run):
                out[r] = (tuple(run), i)
            run = []
    return out


def check_routed(ref, held: list, what: str, until_flip: bool = False) -> dict:
    """Every token of every stream in ``held`` ((prompt, tokens, its
    admission) each) against the plain MoE trunk teacher-forced on that
    stream behind its replayed admission (``ref``, moe_forced_trunk): a
    step whose logit margin is below FORCED_MARGIN, or whose routing gap is
    below ROUTE_MARGIN, is skipped, not an end. With ``until_flip`` a
    stream is held only up to its first skipped step whose token differs:
    the trunk and the engine parted there, and the trunk's KV of that
    token may hold another expert's output, so its later steps are not the
    engine's computation rounded otherwise. A mismatch raises. Returns
    the steps held, the steps skipped by each rule (a step under both counts
    under the logit margin), the skipped steps whose token differs, with the
    widest logit margin among those the logit rule skipped and the widest
    routing gap among those only the routing rule skipped, and every step as
    [step, equal, logit margin, routing gap] (``steps``)."""
    out = {"held": 0, "skipped_logit": 0, "skipped_route": 0, "flips": 0,
           "widest_flip": 0.0, "widest_route_flip": 0.0, "steps": []}
    for prompt, toks, admission in held:
        want, margins, gaps = ref(prompt, toks, admission, differs=until_flip)
        for i, (got, w, m, g) in enumerate(zip(toks, want, margins, gaps)):
            out["steps"].append([i, int(got == w), m, g])
            if m < FORCED_MARGIN or g < ROUTE_MARGIN:
                by_logit = m < FORCED_MARGIN
                out["skipped_logit" if by_logit else "skipped_route"] += 1
                if got != w:
                    out["flips"] += 1
                    if by_logit:
                        out["widest_flip"] = max(out["widest_flip"], m)
                    else:  # a flip only the routing rule skipped
                        out["widest_route_flip"] = max(out["widest_route_flip"], g)
                    if until_flip:
                        break
                continue
            if got != w:
                raise AssertionError(
                    f"{what}: token {i} of a stream ({len(toks)} tokens) is {got}; the plain "
                    f"MoE trunk fed the same tokens picks {w} (margin {m:.4f}, routing gap "
                    f"{g:.4f})")
            out["held"] += 1
    return out


def check_loop_equal(ref, held: list, pipelined: dict, what: str) -> dict:
    """A loop arm's streams (``held`` as for check_routed) against the
    pipelined arm's streams of the same admission (``pipelined``:
    admission_key -> tokens): equal token for token up to their first
    difference, which must come at a step check_routed skips (in the plain
    trunk fed the tokens both share, a logit margin under FORCED_MARGIN or
    a routing gap under ROUTE_MARGIN). The loops round apart (a multi-tick
    flush reads the window its last tick needs, a verify tick runs five
    queries a row), and routing turns such a rounding into a whole expert
    at a near-tie. A difference elsewhere raises. Returns the streams
    compared, those equal throughout, and the tokens equal before each
    stream's first difference, each first difference as [step, logit
    margin, routing gap] (``differences``)."""
    out = {"matched": 0, "equal_streams": 0, "equal_tokens": 0, "differences": []}
    for prompt, toks, admission in held:
        other = pipelined.get(admission_key(admission))
        if other is None:
            continue
        out["matched"] += 1
        i = next((j for j, (a, b) in enumerate(zip(toks, other)) if a != b), None)
        if i is None:
            out["equal_streams"] += 1
            out["equal_tokens"] += len(toks)
            continue
        out["equal_tokens"] += i
        _, margins, gaps = ref(prompt, toks[:i + 1], admission)
        out["differences"].append([i, margins[i], gaps[i]])
        if margins[i] >= FORCED_MARGIN and gaps[i] >= ROUTE_MARGIN:
            raise AssertionError(
                f"{what}: token {i} of a stream is {toks[i]}, the pipelined arm's on the same "
                f"admission {other[i]}, where the plain trunk's margin is {margins[i]:.4f} and "
                f"its routing gap {gaps[i]:.4f}")
    return out


def route_sweep(steps: list) -> list:
    """For candidate routing margins: the steps they hold (with
    FORCED_MARGIN) and the held steps whose token differs."""
    rows = []
    for cut in (0.0, 0.001, 0.002, 0.005, 0.01, 0.02):
        held = [s for s in steps if s[2] >= FORCED_MARGIN and s[3] >= cut]
        rows.append({"route_margin": cut, "held": len(held),
                     "flips": sum(1 for s in held if not s[1])})
    return rows


def add_checks(total: dict, part: dict) -> dict:
    """Sum two check_routed / check_forced / check_loop_equal results
    (widest: the larger; lists: joined)."""
    return {k: (max(total.get(k, 0.0), v) if k.startswith("widest")
                else total.get(k, []) + v if isinstance(v, list) else total.get(k, 0) + v)
            for k, v in part.items()}


def ssm_forced_trunk(params, cfg):
    """The plain SSM recurrence teacher-forced on a stream: ``ref(prompt,
    toks)`` -> (its greedy choice, its top-1/top-2 logit margin) at every
    step: ssm_prefill over the prompt, then ssm_decode_step fed each
    token of ``toks``, eager, with the stream uploaded once and every
    step's logits fetched once at the end; cached by prompt."""
    from vtpu_torch.models.ssm import ssm_decode_step, ssm_prefill

    cache: dict = {}

    def recurrence(prompt: np.ndarray, toks: list) -> tuple[list, list]:
        dev = params["embed"].device
        logits, state = ssm_prefill(params, cfg, torch.from_numpy(prompt[None]).to(dev),
                                    len(prompt), logits_at=torch.tensor([len(prompt) - 1],
                                                                        device=dev))
        ids = torch.tensor(toks, dtype=torch.int32, device=dev)
        rows = [logits[0]]
        for i in range(len(toks) - 1):
            logits, state = ssm_decode_step(params, cfg, state, ids[i:i + 1])
            rows.append(logits[0])
        return choices(torch.stack(rows), "plain SSM recurrence")

    run = trunk_timed("forced", recurrence, lambda prompt, toks: len(toks))

    def ref(prompt: np.ndarray, toks: list) -> tuple[list, list]:
        runs = cache.setdefault(prompt.tobytes(), [])
        for got, want, margins in runs:
            if got[:len(toks)] == list(toks):
                return want[:len(toks)], margins[:len(toks)]
        want, margins = run(prompt, list(toks))
        runs.append((list(toks), want, margins))
        return want, margins

    return ref


def family_wave(eng, prompts, what: str, prefix=None) -> dict:
    """One counted wave of phase k: every launch count set to 0 just before
    it and read just after; every stream OK with FAMILY_TOKENS tokens; one
    graph replay a dispatch (a flush on the multi-tick loops, a tick or a
    verify tick else); nothing captured while serving. Returns its records,
    counters and figures."""
    from vtpu_torch.ops import _build

    settle(eng)
    replays = sum(g.replays for g in eng._graph_sets())
    before = eng.stats()
    _build.reset_launches()
    recs, wall = stream_all(eng, prompts, prefix=prefix)
    settle(eng)
    launches = _build.launches()
    after = eng.stats()
    d = {k: after[k] - before[k] for k in (
        "decode_ticks", "spec_ticks", "loop_flushes", "tick_fetches", "prefill_chunks",
        "spec_emitted", "spec_slot_ticks")}
    d["admission_dispatches"] = sum(after["prefill_batch_hist"]) - sum(before["prefill_batch_hist"])
    for rec in recs:
        if rec.get("status") != "OK" or len(rec["toks"]) != FAMILY_TOKENS:
            raise AssertionError(f"{what}: a stream ended {rec.get('status')} after "
                                 f"{len(rec['toks'])} of {FAMILY_TOKENS} tokens")
    inner = d["decode_ticks"] + d["spec_ticks"]
    played = sum(g.replays for g in eng._graph_sets()) - replays
    dispatches = d["loop_flushes"] if eng._loop_k else inner
    if played != dispatches or not played:
        raise AssertionError(f"{what}: {played} graph replays for {dispatches} dispatches")
    if after["graphs_captured"] != before["graphs_captured"]:
        raise AssertionError(f"{what}: a graph was captured while serving")
    if not eng._loop_k and not eng._spec_tokens and d["tick_fetches"] != d["decode_ticks"]:
        raise AssertionError(f"{what}: {d['tick_fetches']} fetches for {d['decode_ticks']} ticks")
    ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
    total = sum(len(rec["toks"]) for rec in recs)
    return {"recs": recs, "wall_s": wall, "tokens_per_s": total / wall,
            "ttft_p50_ms": ttft[len(ttft) // 2], "launches": launches, "inner_ticks": inner,
            "graph_replays": played, **d}


def admission_probe(model, params, vocab: int) -> dict:
    """One [4, FAMILY_BUCKET] admission (four full-bucket prompts from SEED) through
    ``model.prefill_into_slots`` on a fresh state, after one warm-up: its
    wall ms (synchronized, median of three) and the memory it allocated at
    its peak above what was allocated before it."""
    dev = params["embed"].device
    state = model.init_state(4)
    rs = np.random.RandomState(SEED + 5)
    padded = torch.from_numpy(rs.randint(0, vocab, (4, FAMILY_BUCKET)).astype(np.int32)).to(dev)
    slots = torch.arange(4, device=dev)
    lens = torch.full((4,), FAMILY_BUCKET, device=dev)
    model.prefill_into_slots(params, state, padded, slots, lens)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(3):
        t0 = time.perf_counter()
        model.prefill_into_slots(params, state, padded, slots, lens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    del state
    return {"wall_ms": sorted(walls)[1], "walls_ms": walls, "peak_bytes": peak}


def moe_ffn_split(params, cfg) -> dict:
    """One layer's MoE block at the admission shape (4 x FAMILY_BUCKET tokens, the
    capacity formula's C): device ms of ``route``, the dispatch einsum,
    the experts and the combine einsum (time_ms, back to back behind a
    hold), and the einsums' FLOPs."""
    from vtpu_torch.models.moe import expert_ffn, route
    from vtpu_torch.ops import rms_norm

    lp = {k: v[0] for k, v in params["layers"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    t = 4 * FAMILY_BUCKET
    x = rms_norm(torch.randn((t, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype),
                 lp["mlp_norm"])
    cap = cfg.capacity(t)
    dispatch, combine, _ = route(lp["router"], x, cfg, cap)
    d16, c16 = dispatch.to(cfg.dtype), combine.to(cfg.dtype)
    slots = torch.einsum("tec,td->ecd", d16, x)
    outs = expert_ffn(lp, slots)
    parts = {"route": lambda i: route(lp["router"], x, cfg, cap),
             "dispatch_einsum": lambda i: torch.einsum("tec,td->ecd", d16, x),
             "experts": lambda i: expert_ffn(lp, slots),
             "combine_einsum": lambda i: torch.einsum("tec,ecd->td", c16, outs)}
    ms = {name: time_ms(fn, 5)[0] for name, fn in parts.items()}
    flops = 2 * t * cfg.n_experts * cap * cfg.d_model
    return {"ms": ms, "capacity": cap, "einsum_gflop": flops / 1e9,
            "experts_gflop": 3 * 2 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff / 1e9,
            "kept_choices": int(dispatch.sum()), "choices": t * cfg.top_k}


def moe_arm(name: str, model, serving, vocab: int, forced, min_waves: int = 1,
            pipelined=None) -> dict:
    """An engine of the MoE family on its graphs (model= the adapter): a
    warm-up request, then counted waves (family_wave): ``min_waves`` of
    the serving wave (prompt set 0), then one wave a new prompt set until
    the arm holds FAMILY_HELD steps of distinct streams and, given
    ``pipelined`` (admission_key -> the pipelined arm's tokens), compares
    FAMILY_MATCHED distinct streams with it (check_loop_equal);
    FAMILY_MAX_WAVES waves at most. Each wave's admissions come from the
    engine's trace (admission_batches); each stream not seen before is held
    by check_routed. On the kernel route flash launches = 12 x admission
    dispatches and paged launches (bf16 or int8 per the state) = 12 x
    inner ticks, the other paged kernel none; without kernels none at all.
    The pool ends free and every state tensor in place. ``by_admission``
    maps each stream's admission_key to its tokens."""
    from vtpu_torch.serving import ServingEngine

    eng = ServingEngine(model=model, serving=serving)
    if not eng._graph_sets():
        raise AssertionError(f"MoE {name} does not serve on CUDA graphs")
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    paged, other = "paged_decode_attention", "paged_decode_attention_int8kv"
    if "k_scale" in eng.state:
        paged, other = other, paged
    n_layers = model.cfg.n_layers
    out = {"waves": [], "checks": {}, "graphs": eng.stats()["graphs_captured"],
           "by_admission": {}}
    if pipelined is not None:
        out["equal"] = {"matched": 0}
    life = Lifecycle(eng, ("queue_depart", "admit", "prefill_chunk"))
    prompt_of = {}
    seen = set()
    eng.start()
    try:
        warm = family_prompts(vocab, 0)[0]
        prompt_of.update((rec["rid"], warm) for rec in stream_all(eng, [warm])[0])
        while True:
            j = max(0, len(out["waves"]) - min_waves + 1)
            prompts = family_prompts(vocab, j)
            w = family_wave(eng, prompts, f"MoE {name}")
            lc = w["launches"]
            want = ({"flash_attention": n_layers * w["admission_dispatches"],
                     paged: n_layers * w["inner_ticks"]} if model.cfg.use_kernels else {})
            if {k: v for k, v in lc.items() if v} != want or not w["admission_dispatches"]:
                raise AssertionError(
                    f"MoE {name}: launches {lc} over {w['admission_dispatches']} admission "
                    f"dispatches and {w['inner_ticks']} inner ticks (expected {want})")
            recs = w.pop("recs")
            prompt_of.update((rec["rid"], p) for p, rec in zip(prompts, recs))
            batches = admission_batches(life)
            held = []
            for rec in recs:
                rids, i = batches[rec["rid"]]
                adm = ("batch", tuple(prompt_of[r] for r in rids), i)
                if (admission_key(adm), tuple(rec["toks"])) not in seen:
                    seen.add((admission_key(adm), tuple(rec["toks"])))
                    held.append((prompt_of[rec["rid"]], rec["toks"], adm))
            w["prompt_set"] = j
            w["admissions"] = [[len(batches[rec["rid"]][0]), batches[rec["rid"]][1]]
                               for rec in recs]
            out["checks"] = add_checks(out["checks"], check_routed(forced, held, f"MoE {name}"))
            if pipelined is not None:
                out["equal"] = add_checks(out["equal"], check_loop_equal(
                    forced, held, pipelined, f"MoE {name}"))
            out["by_admission"].update((admission_key(a), t) for _, t, a in held)
            w["streams"] = [rec["toks"] for rec in recs]
            out["waves"].append(w)
            held_n = out["checks"]["held"]
            matched = out["equal"]["matched"] if pipelined is not None else FAMILY_MATCHED
            if (len(out["waves"]) >= min_waves and held_n >= FAMILY_HELD
                    and matched >= FAMILY_MATCHED):
                break
            if len(out["waves"]) >= FAMILY_MAX_WAVES:
                raise AssertionError(
                    f"MoE {name}: {held_n} steps held (floor {FAMILY_HELD}) and {matched} "
                    f"streams compared with the pipelined arm's (floor {FAMILY_MATCHED}) after "
                    f"{FAMILY_MAX_WAVES} waves")
        settle(eng)
        st = eng.stats()
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise AssertionError(f"MoE {name} loop failed: {eng.loop_error!r}")
    if {k: x.data_ptr() for k, x in eng.state.items()} != ptrs:
        raise AssertionError(f"MoE {name}: a state tensor moved")
    if st["kv_pool_free"] != st["kv_pool_blocks"]:
        raise AssertionError(f"MoE {name}: paged pool not fully free after the waves")
    out["spec_disabled_reason"] = st["spec_disabled_reason"]
    return out


def prefill_witness(params, served, plain, batches: list) -> dict:
    """The flash route's MoE admission against the plain route's on the
    same ``batches`` (each its prompts in row order, as the engine
    dispatched them): per layer, the real tokens whose two experts differ
    and those whose kept (not dropped) choices differ; the first layer
    where some token's experts differ, with the widest plain-route routing
    gap among those tokens; and the rows whose first token agrees. Below
    that layer both routes route and drop alike, so their hidden states
    differ by the attention's rounding alone, and a token there may route
    otherwise only at a near-tie: a gap of ROUTE_MARGIN or more raises."""
    from vtpu_torch.models.moe import moe_ffn, moe_prefill, route

    k, n_layers = plain.top_k, plain.n_layers
    dev = params["embed"].device
    out = {"batches": len(batches), "rows": 0, "tokens": 0, "first_layers": [],
           "first_flips": 0, "first_widest_gap": 0.0, "experts_differ": [0] * n_layers,
           "kept_differ": [0] * n_layers, "first_tokens_equal": 0}
    for rows in batches:
        lens = torch.tensor([len(p) for p in rows], device=dev)
        padded = np.zeros((len(rows), FAMILY_BUCKET), np.int32)
        for j, p in enumerate(rows):
            padded[j, :len(p)] = p
        tokens = torch.from_numpy(padded).to(dev)
        seen = {}
        for tag, cfg in (("served", served), ("plain", plain)):
            layers = []

            def ffn(lp, normed, cfg_, capacity=None, pad_mask=None, layers=layers):
                real = pad_mask.reshape(-1)
                flat = normed.reshape(-1, normed.shape[-1])
                top = torch.topk(torch.softmax(flat[real].float() @ lp["router"], dim=-1), k + 1)
                dispatch, _, _ = route(lp["router"], flat, cfg_, cfg_.capacity(flat.shape[0]),
                                       pad_mask=real)
                layers.append((top.indices[:, :k].sort(dim=-1).values,
                               top.values[:, k - 1] - top.values[:, k],
                               dispatch.sum(dim=-1)[real] > 0))
                return moe_ffn(lp, normed, cfg_, capacity=capacity, pad_mask=pad_mask)

            last, _ = moe_prefill(params, cfg, tokens, true_len=lens, logits_at=lens - 1, ffn=ffn)
            seen[tag] = (last.argmax(dim=-1), layers)
        first = None
        for l in range(n_layers):
            (e_s, _, kept_s), (e_p, gap_p, kept_p) = seen["served"][1][l], seen["plain"][1][l]
            differ = (e_s != e_p).any(dim=-1)
            out["experts_differ"][l] += int(differ.sum())
            out["kept_differ"][l] += int((kept_s != kept_p).any(dim=-1).sum())
            if first is None and bool(differ.any()):
                first = l
                out["first_flips"] += int(differ.sum())
                out["first_widest_gap"] = max(out["first_widest_gap"], float(gap_p[differ].max()))
        out["first_layers"].append(first)
        out["rows"] += len(rows)
        out["tokens"] += int(lens.sum())
        out["first_tokens_equal"] += int((seen["served"][0] == seen["plain"][0]).sum())
    if out["first_widest_gap"] >= ROUTE_MARGIN:
        raise AssertionError(
            f"MoE admission: at the first layer where the flash route routes a token otherwise "
            f"than the plain route, a token's plain routing gap is {out['first_widest_gap']:.4f}"
            f" (>= ROUTE_MARGIN {ROUTE_MARGIN}), not a near-tie")
    return out


def model_families_path(log, card: str, main: dict) -> dict:
    """Phase k: the MoE and selective-SSM families served through
    ServingEngine(model=) at full width and depth on graphs captured when
    each engine is built (``main``: the dense main path's figures, printed
    beside). MoE: paged bf16 on the pipelined loop (three waves), int8 KV,
    decode_loop_k=8, spec_tokens=4 and both (fused), the plain route (no
    kernels, the gather route), chunked admission with a registered
    512-token prefix; each arm holds FAMILY_HELD steps at least, the loop
    arms' streams agree with the pipelined arm's (check_loop_equal), and
    the flash route's admissions are held against the plain route's
    (prefill_witness). SSM: the pipelined loop and decode_loop_k=8 (three
    waves each), every stream held by check_forced against the plain
    recurrence. An admission's wall time and peak memory, and the MoE
    block's parts at the admission shape."""
    from vtpu_torch.models import MoEConfig, SSMConfig, init_moe_params, init_ssm_params
    from vtpu_torch.serving import ServingConfig, ServingEngine
    from vtpu_torch.serving.adapters import MoeSlotModel, SsmSlotModel

    t0 = time.perf_counter()
    out: dict = {"moe": {}, "ssm": {}}
    cfg = MoEConfig(**MOE_FLAGSHIP, dtype=torch.bfloat16)
    params = init_moe_params(SEED, cfg, device="cuda")
    plain = dataclasses.replace(cfg, use_kernels=False)
    c8 = dataclasses.replace(cfg, kv_int8=True)
    serving = ServingConfig(slots=4, prefill_buckets=(FAMILY_BUCKET,),
                            max_new_tokens=FAMILY_TOKENS)
    forced = {"bf16": moe_forced_trunk(params, cfg, plain, serving),
              "int8": moe_forced_trunk(params, c8, dataclasses.replace(c8, use_kernels=False),
                                       serving),
              "plain": moe_forced_trunk(params, plain, plain, serving)}
    moe = out["moe"]
    moe["pipelined"] = moe_arm("pipelined", MoeSlotModel(params, cfg, kv_page=128), serving,
                               cfg.vocab, forced["bf16"], REPEATS)
    by_admission = moe["pipelined"].pop("by_admission")
    moe["int8"] = moe_arm("int8", MoeSlotModel(params, c8, kv_page=128), serving, cfg.vocab,
                          forced["int8"])
    for name, kw in FAMILY_LOOPS.items():
        moe[name] = moe_arm(name, MoeSlotModel(params, cfg, kv_page=128),
                            dataclasses.replace(serving, **kw), cfg.vocab, forced["bf16"],
                            pipelined=by_admission)
        if "spec_tokens" in kw and not sum(w["spec_ticks"] for w in moe[name]["waves"]):
            raise AssertionError(f"MoE {name}: no verify tick ran")
    moe["plain_gather"] = moe_arm(
        "plain gather", MoeSlotModel(params, plain, kv_page=128, paged_attn="gather"), serving,
        cfg.vocab, forced["plain"])
    for arm in moe.values():
        arm.pop("by_admission", None)
    moe["chunked_prefix"] = moe_chunked_prefix(params, cfg, plain)
    batches = sorted({key[1] for key in by_admission}, key=len, reverse=True)[:3]
    moe["prefill_witness"] = prefill_witness(
        params, cfg, plain, [tuple(np.frombuffer(p, np.int32) for p in rows) for rows in batches])
    moe["route_sweep"] = route_sweep([s for name, arm in moe.items() if name != "plain_gather"
                                      and "checks" in arm for s in arm["checks"]["steps"]])
    moe["admission_drops"] = {kv: ref.drops for kv, ref in forced.items()}
    model = MoeSlotModel(params, cfg)
    moe["admission"] = admission_probe(model, params, cfg.vocab)
    moe["ffn_split"] = moe_ffn_split(params, cfg)
    del model, params
    torch.cuda.empty_cache()
    out["moe_seconds"] = time.perf_counter() - t0

    scfg = SSMConfig(**SSM_FLAGSHIP, dtype=torch.bfloat16)
    sparams = init_ssm_params(SEED, scfg, device="cuda")
    sforced = ssm_forced_trunk(sparams, scfg)
    prompts = wave_prompts(scfg.vocab)
    engines = {"pipelined": {}, "device_loop": {"decode_loop_k": LOOP_K}}
    ssm = out["ssm"]
    built = {}
    for name, kw in engines.items():
        eng = ServingEngine(model=SsmSlotModel(sparams, scfg),
                            serving=dataclasses.replace(serving, **kw))
        if eng.stats()["graphs_captured"] != 1:
            raise AssertionError(f"SSM {name}: {eng.stats()['graphs_captured']} graphs "
                                 "captured, expected one (no read window)")
        built[name] = (eng, {k: x.data_ptr() for k, x in eng.state.items()})
        ssm[name] = {"waves": [], "checks": {}}
        eng.start()
    try:
        for eng, _ in built.values():
            stream_all(eng, [prompts[0]])
        for r in range(REPEATS):
            for name in (list(engines) if r % 2 == 0 else list(engines)[::-1]):
                w = family_wave(built[name][0], prompts, f"SSM {name}")
                if any(w["launches"].values()):
                    raise AssertionError(f"SSM {name}: kernel launches {w['launches']}")
                recs = w.pop("recs")
                ssm[name]["checks"] = add_checks(ssm[name]["checks"], check_forced(
                    sforced, [(p, rec["toks"], len(rec["toks"])) for p, rec in zip(prompts, recs)],
                    f"SSM {name}"))
                ssm[name]["waves"].append(w)
    finally:
        for eng, _ in built.values():
            eng.stop()
    for name, (eng, ptrs) in built.items():
        if eng.loop_error is not None:
            raise AssertionError(f"SSM {name} loop failed: {eng.loop_error!r}")
        if {k: x.data_ptr() for k, x in eng.state.items()} != ptrs:
            raise AssertionError(f"SSM {name}: a state tensor moved")
    del built, eng
    ssm["admission"] = admission_probe(SsmSlotModel(sparams, scfg), sparams, scfg.vocab)
    ssm["scan_peak_bytes"] = scan_peak(scfg)
    del sparams
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    report_families(log, card, out, main)
    return out


def scan_peak(cfg) -> int:
    """Peak memory above the allocated baseline of one ``_scan_states`` at
    an admission's [4, FAMILY_BUCKET, d_inner, d_state] f32, its inputs
    included."""
    from vtpu_torch.models.ssm import _scan_states

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    shape = (4, FAMILY_BUCKET, cfg.d_inner, cfg.d_state)
    a = torch.rand(shape, device="cuda")
    b = torch.randn(shape, device="cuda")
    h = _scan_states(a, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if not bool(torch.isfinite(h).all()):
        raise AssertionError("the scan produced non-finite states")
    return peak


def moe_chunked_prefix(params, cfg, plain) -> dict:
    """Arm 4: prefill_chunk=256 with one registered 512-token prefix on the
    MoE engine (paged bf16, pipelined on graphs): waves of the four
    prefixed suffixes and of the two prompts past the bucket (chunks
    through moe_decode_ffn), then pairs of new prompts of the same lengths
    until the arm holds FAMILY_HELD steps (FAMILY_MAX_WAVES pairs at
    most), streams held by check_routed behind
    their chunks replayed; chunks as the prompts imply; the prefix's blocks
    held by the registry alone after the waves and the pool free after
    unregister."""
    from vtpu_torch.serving import ServingConfig, ServingEngine
    from vtpu_torch.serving.adapters import MoeSlotModel

    serving = ServingConfig(slots=4, prefill_buckets=(FAMILY_BUCKET,), prefill_chunk=CHUNK,
                            max_new_tokens=FAMILY_TOKENS)
    forced = moe_forced_trunk(params, cfg, plain, serving)
    eng = ServingEngine(model=MoeSlotModel(params, cfg, kv_page=128), serving=serving)
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    prefix, sufs, longs = chunked_prefix_prompts(cfg.vocab)
    want = (sum(-(-len(s) // CHUNK) for s in sufs), sum(-(-len(p) // CHUNK) for p in longs))
    out = {"prefixed": [], "long": [], "checks": {}}
    eng.start()
    try:
        pid = eng.register_prefix(prefix)
        blocks = list(eng._prefixes[pid]["blocks"])
        stream_all(eng, [sufs[0]], prefix=pid)
        while not out["prefixed"] or out["checks"]["held"] < FAMILY_HELD:
            if len(out["prefixed"]) >= FAMILY_MAX_WAVES:
                raise AssertionError(f"MoE chunked + prefix: {out['checks']['held']} steps held "
                                     f"(floor {FAMILY_HELD}) after {FAMILY_MAX_WAVES} wave pairs")
            if out["prefixed"]:  # a later pair: new prompts of the same lengths
                rs = np.random.RandomState(SEED + 200 + len(out["prefixed"]))
                sufs = [rs.randint(0, cfg.vocab, (len(x),)).astype(np.int32) for x in sufs]
                longs = [rs.randint(0, cfg.vocab, (len(x),)).astype(np.int32) for x in longs]
            pre = family_wave(eng, sufs, "MoE prefixed", prefix=pid)
            long = family_wave(eng, longs, "MoE chunked")
            if (pre["prefill_chunks"], long["prefill_chunks"]) != want:
                raise AssertionError(f"prefill_chunks {pre['prefill_chunks']}, "
                                     f"{long['prefill_chunks']}, the prompts imply {want}")
            for w in (pre, long):
                if w["launches"]["paged_decode_attention"] != cfg.n_layers * w["decode_ticks"]:
                    raise AssertionError(f"MoE chunked + prefix launches {w['launches']}")
            held = ([(s, r["toks"], ("chunks", prefix)) for s, r in zip(sufs, pre.pop("recs"))]
                    + [(p, r["toks"], ("chunks", None)) for p, r in zip(longs, long.pop("recs"))])
            out["checks"] = add_checks(out["checks"], check_routed(forced, held,
                                                                   "MoE chunked + prefix"))
            out["prefixed"].append(pre)
            out["long"].append(long)
        refs = [eng._alloc.refcount(b) for b in blocks]
        eng.unregister_prefix(pid)
        settle(eng)
        st = eng.stats()
    finally:
        eng.stop()
    if eng.loop_error is not None:
        raise AssertionError(f"MoE chunked + prefix loop failed: {eng.loop_error!r}")
    if refs != [1] * len(blocks) or st["kv_pool_free"] != st["kv_pool_blocks"]:
        raise AssertionError(f"prefix block refcounts {refs} after the waves; after unregister "
                             f"{st['kv_pool_free']} of {st['kv_pool_blocks']} blocks free")
    if {k: x.data_ptr() for k, x in eng.state.items()} != ptrs:
        raise AssertionError("MoE chunked + prefix: a state tensor moved")
    out.update(prefix_refcounts=refs, prefix_hits=st["prefix_hits"])
    return out


def report_families(log, card: str, out: dict, main: dict) -> None:
    """Phase k's lines: per arm its tokens/s and TTFT (median [min, max]
    over its waves), counts and the held streams; the dense main path's
    figures beside; the admissions and the MoE block's parts."""
    main_ttft = main["ttft_ms"][len(main["ttft_ms"]) // 2]

    def held(checks: dict) -> str:
        return str({k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in checks.items() if k != "steps"})

    for fam in ("moe", "ssm"):
        for name, arm in out[fam].items():
            if not isinstance(arm, dict) or "waves" not in arm:
                continue
            ws = arm["waves"]
            ws0 = [w for w in ws if not w.get("prompt_set")]
            log(f"model families, {fam.upper()} {name} on {card}, {len(ws)} wave(s) of 6 x "
                f"{FAMILY_TOKENS} tokens ({len(ws0)} of the serving wave), median [min, max] "
                f"over those: tokens/s {spread([w['tokens_per_s'] for w in ws0])}; TTFT p50 ms "
                f"{spread([w['ttft_p50_ms'] for w in ws0])}; inner ticks "
                f"{[w['inner_ticks'] for w in ws]}, graph replays "
                f"{[w['graph_replays'] for w in ws]}, admission dispatches "
                f"{[w['admission_dispatches'] for w in ws]}, spec ticks "
                f"{[w['spec_ticks'] for w in ws]}; launches {ws[-1]['launches']}; "
                + (f"against the pipelined arm on the same admission {arm['equal']}; "
                   if "equal" in arm else "")
                + f"held {held(arm['checks'])}")
    moe = out["moe"]
    log(f"model families, MoE admissions as the trunk replays them: dropped choices "
        f"{moe['admission_drops']} (capacity by the config's formula over each admission, "
        "pads masked out)")
    cp = moe["chunked_prefix"]
    log(f"model families, MoE chunked + prefix on {card}, {len(cp['prefixed'])} wave pair(s): "
        f"prefixed TTFT p50 ms {spread([w['ttft_p50_ms'] for w in cp['prefixed']])} "
        f"({cp['prefixed'][0]['prefill_chunks']} chunks a wave), chunked {LONG_LENS} TTFT p50 ms "
        f"{spread([w['ttft_p50_ms'] for w in cp['long']])} ({cp['long'][0]['prefill_chunks']} "
        f"chunks); prefix hits {cp['prefix_hits']}, prefix block refcounts after the waves "
        f"{cp['prefix_refcounts']}; held {held(cp['checks'])}")
    pw = moe["prefill_witness"]
    log(f"model families, MoE admission, flash route against plain route on {pw['batches']} "
        f"batches ({pw['rows']} rows, {pw['tokens']} real tokens): first layer routing a token "
        f"otherwise {pw['first_layers']}, {pw['first_flips']} tokens there, widest plain "
        f"routing gap among them {pw['first_widest_gap']:.5f}; tokens routed otherwise a layer "
        f"{pw['experts_differ']}, tokens kept otherwise a layer {pw['kept_differ']}; first "
        f"tokens equal {pw['first_tokens_equal']} of {pw['rows']}")
    log("model families, MoE routing-margin sweep over the kernel arms' steps (logit margin "
        f">= {FORCED_MARGIN}): " + "; ".join(
            f"{r['route_margin']}: {r['held']} held, {r['flips']} differing"
            for r in moe["route_sweep"]) + f" (ROUTE_MARGIN {ROUTE_MARGIN})")
    med = {}
    for fam, name in (("moe", "pipelined"), ("ssm", "pipelined"), ("ssm", "device_loop")):
        tps = sorted(w["tokens_per_s"] for w in out[fam][name]["waves"] if not w.get("prompt_set"))
        med[f"{fam} {name}"] = tps[len(tps) // 2]
    log(f"model families on {card}, beside the dense main path's {main['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50 {main_ttft:.1f} ms (one wave, logprobs on): median tokens/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in med.items()))
    for fam in ("moe", "ssm"):
        a = out[fam]["admission"]
        log(f"model families, {fam.upper()} admission of 4 x {FAMILY_BUCKET} tokens on {card}: "
            f"{a['wall_ms']:.2f} ms wall (runs {[round(x, 2) for x in a['walls_ms']]}), peak "
            f"{a['peak_bytes'] / 2**30:.3f} GiB above what was allocated before it")
    log(f"model families, SSM scan alone at [4, {FAMILY_BUCKET}, 2048, 16] f32: peak "
        f"{out['ssm']['scan_peak_bytes'] / 2**30:.3f} GiB")
    sp = out["moe"]["ffn_split"]
    adm = out["moe"]["admission"]["wall_ms"]
    n_layers = MOE_FLAGSHIP["n_layers"]
    ein = sp["ms"]["dispatch_einsum"] + sp["ms"]["combine_einsum"]
    log(f"model families, MoE block at the admission shape (4096 tokens, capacity "
        f"{sp['capacity']}, {sp['kept_choices']} of {sp['choices']} choices kept) on {card}, "
        f"device ms a layer: " + ", ".join(f"{k} {v:.3f}" for k, v in sp["ms"].items())
        + f"; the dispatch and combine einsums ({sp['einsum_gflop']:.0f} GFLOP each, the "
        f"experts {sp['experts_gflop']:.0f}) x {n_layers} layers = {n_layers * ein:.2f} ms, "
        f"{100 * n_layers * ein / adm:.1f}% of the admission's {adm:.2f} ms")
    log(f"model families phase on {card}: {out['seconds']:.1f} s (MoE {out['moe_seconds']:.1f})")


# phase l, disaggregated prefill/decode: the flagship on the pipelined loop on
# graphs with 256-token chunks; two background streams of DG_BG_TOKENS, then
# a burst of the six wave prompts of DG_BURST_TOKENS each (the shape of
# benchmarks/disagg_bench.py's mixed load: steady decode plus a burst past
# the free slots)
DG_SERVING = dict(slots=4, prefill_buckets=(1024,), kv_page=128, prefill_chunk=256)
DG_BG_TOKENS = 128
DG_BURST_TOKENS = 16
# the co-scheduled arm's per-tick prompt budget (the reference A/B's arm)
DG_BUDGET = 2 * 1024


def dg_prompts(vocab: int) -> tuple[list, list]:
    """(two background prompts of 600-1024 tokens from SEED + 5, the six
    wave prompts)."""
    rs = np.random.RandomState(SEED + 5)
    bg = [rs.randint(0, vocab, (int(n),)).astype(np.int32) for n in rs.randint(600, 1025, 2)]
    return bg, wave_prompts(vocab)


def dg_engine(params, cfg, model=None, **kw):
    """A phase l engine on graphs (``model`` an adapter, else the dense
    flagship), its state addresses, its graph count, and its chunk timer:
    each call of the engine's chunk step stamped with the calling thread's
    host wall ms and CUDA events on that thread's current stream (a
    worker's own stream, or the loop's): chunk_ms."""
    from vtpu_torch.serving import ServingConfig, ServingEngine

    serving = ServingConfig(**DG_SERVING, max_new_tokens=DG_BG_TOKENS, **kw)
    eng = (ServingEngine(serving=serving, model=model) if model is not None
           else ServingEngine(params, cfg, serving))
    if eng.decode_graphs is None and eng.loop_graphs is None:
        raise AssertionError("a phase l engine does not serve on CUDA graphs")
    chunks = []
    step = eng._prefill_chunk

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step(*a, **kw)
        end.record()
        chunks.append((threading.current_thread().name, (time.perf_counter() - t0) * 1e3,
                       start, end))
        return out

    eng._prefill_chunk = timed
    return (eng, {k: x.data_ptr() for k, x in eng.state.items()},
            eng.stats()["graphs_captured"], chunks)


def dg_guard(eng) -> None:
    """The loop's handoff installs and swap dispatches (guard_sync: the
    evictions a worker's dry pool asks for, the swap-ins, the polling of
    swap-outs) run under set_sync_debug_mode("error"): a host wait there
    raises and the loop ends with loop_error. The mode is process-wide, so
    a prefill worker's chunk dispatch that overlaps those windows is held
    to it too and would end its request FAULTED; the worker's first-token
    fetch and its release fence are event waits (cudaEventSynchronize),
    which the mode does not flag."""
    guard_sync(eng, SWAP_DISPATCH + ("_install_handoffs",))


def chunk_ms(chunks: list, worker: bool) -> dict:
    """Host ms a chunk (its dispatch's wall time on the calling thread) and
    stream ms (from the event before its first kernel to the event after
    its last on that thread's stream: the stream's time for the chunk,
    gaps while the host enqueues included), median [min, max], of the
    chunks the workers (``worker``) or the loop thread dispatched; reads
    the events after a synchronize."""
    torch.cuda.synchronize()
    rows = [(h, s.elapsed_time(e)) for name, h, s, e in chunks
            if name.startswith("vtpu-prefill") == worker]
    if not rows:
        return {"n": 0}
    return {"n": len(rows), "host": spread([h for h, _ in rows]),
            "stream": spread([d for _, d in rows]),
            "host_med": sorted(h for h, _ in rows)[len(rows) // 2],
            "stream_med": sorted(d for _, d in rows)[len(rows) // 2]}


def dg_wave(eng, bg_prompts, burst, what: str, loop_k: int = 0) -> dict:
    """One counted wave: every launch count set to 0 just before it and read
    just after. The two background streams are submitted and stream two
    tokens, then the burst is submitted at once. Held: every stream OK with
    its tokens, one graph replay a dispatch, one fetch a dispatch (a tick;
    a flush of ``loop_k`` ticks), paged launches = 12 x inner ticks and
    no other paged kernel, no capture, the pool free at the end; under
    disaggregation no flash launch (worker chunks take the plain ragged
    route), a handoff a request and handoff_copies 0. Returns the streams
    and the wave's figures: burst TTFT, the background ITL while the burst
    is served, tokens/s, queue wait and prefill exec (the trace's split of
    TTFT), the counters' deltas and the launches."""
    from vtpu_torch.ops import _build

    settle(eng)
    before = eng.stats()
    reps = [g.replays for g in eng._graph_sets()]
    _build.reset_launches()
    t0 = time.perf_counter()
    bg = [Session(eng, p, DG_BG_TOKENS) for p in bg_prompts]
    for s in bg:
        s.wait_tokens(2)
    t_burst = time.perf_counter()
    bs = [Session(eng, p, DG_BURST_TOKENS) for p in burst]
    for s in bs + bg:
        s.join()
    settle(eng)
    launches = _build.launches()
    after = eng.stats()
    played = sum(g.replays for g in eng._graph_sets()) - sum(reps)
    d = {k: after[k] - before[k] for k in (
        "decode_ticks", "loop_flushes", "tick_fetches", "handoffs", "handoff_copies",
        "prefill_chunks", "admissions", "generated_tokens", "worker_restarts",
        "faulted_requests", "repartitions")}
    d["admission_dispatches"] = sum(after["prefill_batch_hist"]) - sum(before["prefill_batch_hist"])
    for s, n in zip(bg + bs, [DG_BG_TOKENS] * 2 + [DG_BURST_TOKENS] * 6):
        if len(s.toks) != n:
            raise AssertionError(f"{what}: a stream delivered {len(s.toks)} of {n} tokens")
    disagg = after["disagg"]
    inner = d["decode_ticks"]
    dispatches = d["loop_flushes"] if loop_k else inner
    paged = ("paged_decode_attention_int8kv" if "k_scale" in eng.state
             else "paged_decode_attention")
    others = {k: n for k, n in launches.items() if k not in (paged, "flash_attention") and n}
    if launches[paged] != FLAGSHIP["n_layers"] * inner or others:
        raise AssertionError(f"{what}: {paged} launched {launches[paged]} times over {inner} "
                             f"inner ticks (expected {FLAGSHIP['n_layers']} each), others {others}")
    want_flash = 0 if disagg else FLAGSHIP["n_layers"] * d["admission_dispatches"]
    if launches["flash_attention"] != want_flash:
        raise AssertionError(f"{what}: flash launched {launches['flash_attention']} times, "
                             f"expected {want_flash}")
    if played != dispatches or d["tick_fetches"] != dispatches:
        raise AssertionError(f"{what}: {played} graph replays and {d['tick_fetches']} tick "
                             f"fetches for {dispatches} dispatches")
    gets = after["device_gets_per_tick"]
    if gets != (1.0 / loop_k if loop_k else 1.0):
        raise AssertionError(f"{what}: device_gets_per_tick {gets}")
    if after["graphs_captured"] != before["graphs_captured"]:
        raise AssertionError(f"{what}: a graph was captured while serving")
    if after["kv_pool_free"] != after["kv_pool_blocks"]:
        raise AssertionError(f"{what}: the pool is not free at the end of the wave")
    if disagg and (d["handoffs"] != 8 or after["handoff_copies"] != 0):
        raise AssertionError(f"{what}: {d['handoffs']} handoffs for 8 requests, "
                             f"handoff_copies {after['handoff_copies']}")
    t_end = max(s.times[-1] for s in bs)
    gaps = sorted((b - a) * 1e3 for s in bg for a, b in zip(s.times, s.times[1:])
                  if a >= t_burst and b <= t_end)
    ttft = sorted((s.times[0] - s.t_submit) * 1e3 for s in bs)
    spans = eng.trace.spans()
    split = [spans.get(s.req.rid, {}) for s in bs]
    wall = max(s.times[-1] for s in bg + bs) - t0
    total = sum(len(s.toks) for s in bg + bs)
    return {"streams": [s.toks for s in bg + bs], "ttft_ms": ttft,
            "ttft_p50_ms": ttft[len(ttft) // 2], "ttft_p99_ms": ttft[-1],
            "bg_itl_ms": gaps, "bg_itl_p50_ms": gaps[len(gaps) // 2] if gaps else None,
            "bg_itl_p99_ms": nearest_rank(gaps, 0.99) if gaps else None,
            "tokens_per_s": total / wall, "wall_s": wall,
            "queue_wait_ms": sorted(x.get("queue_wait_ms") or 0.0 for x in split),
            "prefill_exec_ms": sorted(x.get("prefill_exec_ms") or 0.0 for x in split),
            "launches": launches, "graph_replays": played, **d}


def nearest_rank(vals: list, q: float) -> float:
    """The q-quantile of sorted ``vals`` (nearest rank)."""
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def dg_equal(forced, prompts, streams: list, cosched: list, what: str) -> dict:
    """Every token of every stream against the plain trunk teacher-forced on
    it (check_forced), and each stream against the co-scheduled arm's
    stream of the same prompt: equal token for token up to their first
    difference, which must come at a step whose margin in that trunk fed
    the shared tokens is under FORCED_MARGIN (a bf16 near-tie). Returns the
    tokens equal to the co-scheduled arm's and check_forced's figures."""
    out = {"equal_tokens": 0, "equal_streams": 0, "differences": [],
           # first: it forces each whole stream once, and the lookups below
           # read those runs' steps
           "forced": check_forced(forced, [(p, t, len(t)) for p, t in zip(prompts, streams)],
                                  what)}
    for prompt, toks, other in zip(prompts, streams, cosched):
        i = next((j for j, (a, b) in enumerate(zip(toks, other)) if a != b), None)
        if i is None:
            out["equal_streams"] += 1
            out["equal_tokens"] += len(toks)
            continue
        out["equal_tokens"] += i
        _, margins = forced(prompt, toks[:i + 1])
        out["differences"].append([i, margins[i]])
        if margins[i] >= FORCED_MARGIN:
            raise AssertionError(f"{what}: token {i} of a stream is {toks[i]}, the co-scheduled "
                                 f"arm's {other[i]}, at a plain-trunk margin of {margins[i]:.4f}")
    return out


def dg_held(eng, ptrs: dict, captured: int, what: str) -> None:
    """After the loop stopped: no loop error, no worker fault, no capture
    while serving, every state tensor at its address."""
    oc_held(eng, ptrs, captured, what)
    if eng.stats()["faulted_requests"]:
        raise AssertionError(f"{what}: {eng.stats()['faulted_requests']} requests faulted")


def dg_arm(log, card: str, params, cfg, name: str, prompts, forced, cosched=None,
           waves: int = 1, model=None, loop_k: int = 0, **kw) -> dict:
    """``waves`` counted waves (dg_wave) of one engine after a warm-up
    request, under dg_guard when it disaggregates; streams
    held against the co-scheduled arm's (``cosched``) and the
    teacher-forced plain trunk (``forced``), or, for the MoE (``model``),
    against its plain trunk behind the chunked admission the worker ran
    (check_routed, each stream up to its first skipped step whose token
    differs), with waves of phase k's new prompt sets until FAMILY_HELD
    steps are held (FAMILY_MAX_WAVES at most)."""
    bg_prompts, burst = prompts
    t0 = time.perf_counter()
    eng, ptrs, captured, chunks = dg_engine(params, cfg, model=model, **kw)
    if eng._disagg is not None:
        dg_guard(eng)
    seconds = {"build": time.perf_counter() - t0, "check": 0.0}
    eng.start()
    out, routed = [], {}
    try:
        Session(eng, burst[0][:64], 2).join()
        while len(out) < waves or (model is not None and routed["held"] < FAMILY_HELD):
            if len(out) >= FAMILY_MAX_WAVES:
                raise AssertionError(f"disagg {name}: {routed['held']} steps held (floor "
                                     f"{FAMILY_HELD}) after {FAMILY_MAX_WAVES} waves")
            if out and model is not None:  # a later MoE wave: phase k's new prompt sets
                bg_prompts = family_prompts(cfg.vocab, 100 + len(out))[:2]
                burst = family_prompts(cfg.vocab, len(out))
            out.append(dg_wave(eng, bg_prompts, burst, f"disagg {name}", loop_k))
            if model is not None:
                t1 = time.perf_counter()
                part = check_routed(forced, [(p, t, ("chunks", None)) for p, t in
                                             zip(bg_prompts + burst, out[-1]["streams"])],
                                    f"disagg {name}", until_flip=True)
                seconds["check"] += time.perf_counter() - t1
                part.pop("steps")
                out[-1]["routed"] = part
                routed = add_checks(routed, part)
        st = eng.stats()
    finally:
        eng.stop()
    dg_held(eng, ptrs, captured, f"disagg {name}")
    t1 = time.perf_counter()
    every = bg_prompts + burst
    for w in out if model is None else ():
        if cosched is not None:
            w["held"] = dg_equal(forced, every, w["streams"], cosched, f"disagg {name}")
        else:
            w["held"] = {"forced": check_forced(forced, [(p, t, len(t)) for p, t in
                                                         zip(every, w["streams"])],
                                                f"disagg {name}")}
    seconds["check"] += time.perf_counter() - t1
    seconds["serve"] = time.perf_counter() - t0 - seconds["build"] - seconds["check"]
    arm = {"waves": out, "routed": routed or None, "seconds": seconds,
           "worker_chunk_ms": chunk_ms(chunks, True),
           "loop_chunk_ms": chunk_ms(chunks, False), "worker_restarts": st["worker_restarts"],
           "repartitions": st["repartitions"], "handoffs": st["handoffs"],
           "handoff_copies": st["handoff_copies"], "chunks": chunks, "engine": eng}
    report_dg_arm(log, card, name, arm)
    return arm


def report_dg_arm(log, card: str, name: str, arm: dict) -> None:
    ws = arm["waves"]
    held = [w.get("held", {}).get("forced") or w.get("routed") for w in ws]
    log(f"disagg {name} on {card}: {len(ws)} waves of 2 x {DG_BG_TOKENS} + 6 x "
        f"{DG_BURST_TOKENS} tokens; burst TTFT p50 {spread([w['ttft_p50_ms'] for w in ws])} "
        f"p99 {spread([w['ttft_p99_ms'] for w in ws])} ms; background ITL p50 "
        f"{spread([w['bg_itl_p50_ms'] for w in ws])} p99 "
        f"{spread([w['bg_itl_p99_ms'] for w in ws])} ms; tokens/s "
        f"{spread([w['tokens_per_s'] for w in ws])}; queue wait p50 "
        f"{spread([w['queue_wait_ms'][3] for w in ws])} ms, prefill exec p50 "
        f"{spread([w['prefill_exec_ms'][3] for w in ws])} ms")
    wc, lc = arm["worker_chunk_ms"], arm["loop_chunk_ms"]
    log(f"disagg {name} on {card}: handoffs {arm['handoffs']}, handoff_copies "
        f"{arm['handoff_copies']}, repartitions {arm['repartitions']}, worker_restarts "
        f"{arm['worker_restarts']}; worker chunks {wc['n']}"
        + (f" host {wc['host']} ms, stream {wc['stream']} ms a chunk" if wc["n"] else "")
        + f"; loop chunks {lc['n']}"
        + (f" host {lc['host']} ms, stream {lc['stream']} ms a chunk" if lc["n"] else "")
        + f"; launches a wave {[w['launches'] for w in ws][0]}; inner ticks "
        f"{[w['decode_ticks'] for w in ws]}, replays {[w['graph_replays'] for w in ws]}; held "
        + "; ".join(f"{h['held']} steps ({h['flips']} flips skipped, the widest at "
                    f"{h['widest_flip']})" for h in held if h)
        + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in arm["seconds"].items()))


def dg_overcommit_arm(log, card: str, params, cfg, forced) -> dict:
    """Disaggregation on phase i's overcommit engine (kv_pool_blocks=37,
    kv_swap=36): one round of phase i's traffic (overcommit_round), whose
    second four are claimed by the worker while the first four hold the
    pool parked, so each of their claims misses, posts its blocks and the
    loop evicts parked pages to the host tier: handoffs land in blocks an
    eviction freed. Held: every swapped-in block byte for byte
    (watch_swaps), every token of every stream against the teacher-forced
    plain trunk, 8 parks and 8 resumes, blocks evicted, handoffs = 8 and
    handoff_copies 0, one fetch a tick, one replay a tick, paged launches =
    12 x ticks, the pool and host tier free, under dg_guard."""
    from vtpu_torch.serving import DisaggConfig, ServingConfig

    serving = ServingConfig(**OC_SERVING, max_new_tokens=2 * OC_TOKENS, kv_swap=OC_HOST,
                            disagg=DisaggConfig())
    eng, lc, ptrs, captured = oc_engine(params, cfg, serving)
    swaps = watch_swaps(eng)
    dg_guard(eng)
    prompts = overcommit_prompts(cfg.vocab)
    eng.start()
    try:
        Session(eng, prompts[0][:64], 2).join()
        r = overcommit_round(eng, lc, prompts)
    finally:
        eng.stop()
    what = "disagg overcommit"
    dg_held(eng, ptrs, captured, what)
    torch.cuda.synchronize()
    s1, s2 = r["s1"], r["s2"]
    d = {k: s2[k] - s1[k] for k in ("parks", "resumes", "evicted_blocks", "swap_in_bytes",
                                    "swap_faults", "fault_recomputes", "decode_ticks",
                                    "tick_fetches", "handoffs", "pool_blocked_admissions")}
    bpb = block_bytes(eng)
    bad, swapped = int(swaps["bad"]), s2["swap_in_bytes"] // bpb
    if bad or swaps["checked"] != swapped or not swapped:
        raise AssertionError(f"{what}: {bad} bytes of the {swaps['checked']} blocks held differ "
                             f"from what left the pool ({swapped} blocks swapped in)")
    if (d["parks"], d["resumes"], d["handoffs"]) != (8, 8, 8) or not d["evicted_blocks"]:
        raise AssertionError(f"{what}: counters {d}")
    if s2["handoff_copies"] or d["tick_fetches"] != d["decode_ticks"]:
        raise AssertionError(f"{what}: handoff_copies {s2['handoff_copies']}, "
                             f"{d['tick_fetches']} fetches for {d['decode_ticks']} ticks")
    if r["replays"] != d["decode_ticks"]:
        raise AssertionError(f"{what}: {r['replays']} graph replays for {d['decode_ticks']} ticks")
    launches = r["launches"]
    others = {k: n for k, n in launches.items()
              if k not in ("paged_decode_attention", "flash_attention") and n}
    if launches["paged_decode_attention"] != FLAGSHIP["n_layers"] * d["decode_ticks"] or others:
        raise AssertionError(f"{what}: launches {launches} over {d['decode_ticks']} ticks")
    if (s2["kv_pool_free"] != s2["kv_pool_blocks"] or s2["parked_sessions"]
            or s2["swap_host_free"] != s2["swap_host_blocks"]):
        raise AssertionError(f"{what}: the pool or the host tier is not free at the end")
    held = check_forced(forced, [(s.prompt, s.toks, n) for s, n in
                                 zip(r["sessions"], r["at_park"])], what)
    unparked = check_forced(forced, [(s.prompt, s.toks, len(s.toks)) for s in r["unparked"]],
                            f"{what} unparked wave")
    log(f"{what} on {card}: one round of phase i's traffic on a disaggregated engine: "
        f"{d['parks']} parks, {d['resumes']} resumes, {d['evicted_blocks']} blocks evicted, "
        f"{swapped} swapped in, every one byte-equal to what left the pool, "
        f"{d['fault_recomputes']} rebuilt; worker allocator misses (posted reclaims) "
        f"{d['pool_blocked_admissions']}; handoffs {d['handoffs']}, handoff_copies 0; "
        f"launches {launches}; held against the teacher-forced plain trunk {held['held']} "
        f"tokens ({held['held_after_park']} after a park, {held['flips']} flips skipped), "
        f"unparked wave {unparked['held']}; eviction wave TTFT p50 "
        f"{r['eviction_split']['ttft_p50_ms']:.1f} ms, ITL p50 "
        f"{r['eviction_split']['itl_p50_ms']:.2f} ms")
    return {"counters": d, "launches": launches, "swap_in_blocks_held": swaps["checked"],
            "forced": held, "forced_unparked": unparked,
            "eviction_split": r["eviction_split"], "unparked_split": r["unparked_split"]}


def disagg_path(log, card: str, params) -> dict:
    """Phase l: disaggregated prefill/decode on the flagship at full width
    and depth, on graphs captured when each engine is built. The A/B:
    co-scheduled (prefill_budget = 2 x 1024, bucketed admission through
    flash) and DisaggConfig() (one prefill worker on its own stream,
    256-token chunks), interleaved, REPEATS waves each; then one wave each
    of int8 KV, prefill_workers=2, decode_loop_k=8, a worker_death at the
    counted wave's first claim (one restart, the request re-queued),
    the overcommit engine of phase i where handoffs race evictions
    (dg_overcommit_arm), and the MoE of phase k (waves until it holds
    FAMILY_HELD steps). A loop chunk is timed by a 1024-token prefix build
    on the idle co-scheduled engine. Every wave is held by dg_wave and its
    streams by dg_equal (or check_forced, check_routed)."""
    from vtpu_torch.models import ModelConfig, MoEConfig, init_moe_params
    from vtpu_torch.serving import DisaggConfig, FaultPlan, FaultSpec, ServingConfig
    from vtpu_torch.serving.adapters import MoeSlotModel

    t0 = time.perf_counter()
    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    cfg8 = dataclasses.replace(cfg, kv_int8=True)
    forced = {kv: forced_trunk(params, dataclasses.replace(c, use_kernels=False))
              for kv, c in (("bf16", cfg), ("int8", cfg8))}
    prompts = dg_prompts(cfg.vocab)
    every = prompts[0] + prompts[1]
    arms = {"cosched": dg_engine(params, cfg, prefill_budget=DG_BUDGET),
            "disagg": dg_engine(params, cfg, disagg=DisaggConfig())}
    t1 = time.perf_counter()
    for name, (eng, *_) in arms.items():
        if eng._disagg is not None:
            dg_guard(eng)
        eng.start()
        Session(eng, prompts[1][0][:64], 2).join()
    waves = {name: [] for name in arms}
    try:
        for _ in range(REPEATS):
            for name, (eng, *_) in arms.items():
                waves[name].append(dg_wave(eng, *prompts, f"{name} A/B"))
        eng = arms["cosched"][0]
        pid = eng.register_prefix(prompts[1][5][:1024])
        eng.unregister_prefix(pid)
    finally:
        for eng, *_ in arms.values():
            eng.stop()
    out: dict = {}
    cosched = waves["cosched"][0]["streams"]
    t2 = time.perf_counter()
    for name, (eng, ptrs, captured, chunks) in arms.items():
        dg_held(eng, ptrs, captured, f"{name} A/B")
        for w in waves[name]:
            w["held"] = dg_equal(forced["bf16"], every, w["streams"], cosched, f"{name} A/B")
        st = eng.stats()
        # the two engines' build and serving, and this arm's checks
        out[name] = {"waves": waves[name], "seconds": {
                         "build": t1 - t0, "serve": t2 - t1, "check": time.perf_counter() - t2},
                     "worker_chunk_ms": chunk_ms(chunks, True),
                     "loop_chunk_ms": chunk_ms(chunks, False),
                     "worker_restarts": st["worker_restarts"], "repartitions": st["repartitions"],
                     "handoffs": st["handoffs"], "handoff_copies": st["handoff_copies"]}
        report_dg_arm(log, card, name, out[name])
    loop_chunks = out["cosched"]["loop_chunk_ms"]
    if not loop_chunks["n"] or not out["disagg"]["worker_chunk_ms"]["n"]:
        raise AssertionError("phase l timed no loop chunk or no worker chunk")
    torch.cuda.empty_cache()
    out["int8"] = dg_arm(log, card, params, cfg8, "int8", prompts, forced["int8"],
                         disagg=DisaggConfig())
    out["workers2"] = dg_arm(log, card, params, cfg, "prefill_workers=2", prompts,
                             forced["bf16"], cosched, disagg=DisaggConfig(prefill_workers=2))
    out["loop_k"] = dg_arm(log, card, params, cfg, f"decode_loop_k={LOOP_K}", prompts,
                           forced["bf16"], cosched, loop_k=LOOP_K, decode_loop_k=LOOP_K,
                           disagg=DisaggConfig())
    death = dg_arm(log, card, params, cfg, "worker_death", prompts, forced["bf16"], cosched,
                   disagg=DisaggConfig(), faults=FaultPlan([FaultSpec("worker_death", at=1)]))
    if death["worker_restarts"] != 1 or death["engine"].stats()["faults_injected"] != 1:
        raise AssertionError(f"disagg worker_death: {death['worker_restarts']} restarts, "
                             f"{death['engine'].stats()['faults_injected']} injected; expected "
                             "one each")
    out["worker_death"] = death
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["overcommit"] = dg_overcommit_arm(log, card, params, cfg, forced["bf16"])
    out["overcommit"]["seconds"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    mcfg = MoEConfig(**MOE_FLAGSHIP, dtype=torch.bfloat16)
    mparams = init_moe_params(SEED, mcfg, device="cuda")
    mplain = dataclasses.replace(mcfg, use_kernels=False)
    mforced = moe_forced_trunk(mparams, mcfg, mplain, ServingConfig(**DG_SERVING))
    out["moe"] = dg_arm(log, card, None, mcfg, "MoE", dg_prompts(mcfg.vocab), mforced,
                        model=MoeSlotModel(mparams, mcfg, kv_page=128), disagg=DisaggConfig())
    del mparams
    for arm in out.values():
        arm.pop("chunks", None)
        arm.pop("engine", None)
    torch.cuda.empty_cache()
    ab = {name: out[name]["waves"] for name in ("cosched", "disagg")}
    med = {name: {k: sorted(w[k] for w in ws)[REPEATS // 2]
                  for k in ("ttft_p50_ms", "ttft_p99_ms", "bg_itl_p50_ms", "bg_itl_p99_ms",
                            "tokens_per_s")} for name, ws in ab.items()}
    out["ab_medians"] = med
    out["seconds"] = time.perf_counter() - t0
    log(f"disagg A/B on {card} (median of {REPEATS} interleaved waves, co-scheduled -> "
        f"disaggregated): burst TTFT p50 {med['cosched']['ttft_p50_ms']:.1f} -> "
        f"{med['disagg']['ttft_p50_ms']:.1f} ms, p99 {med['cosched']['ttft_p99_ms']:.1f} -> "
        f"{med['disagg']['ttft_p99_ms']:.1f} ms; background ITL p50 "
        f"{med['cosched']['bg_itl_p50_ms']:.2f} -> {med['disagg']['bg_itl_p50_ms']:.2f} ms, p99 "
        f"{med['cosched']['bg_itl_p99_ms']:.2f} -> {med['disagg']['bg_itl_p99_ms']:.2f} ms; "
        f"tokens/s {med['cosched']['tokens_per_s']:.1f} -> {med['disagg']['tokens_per_s']:.1f}; "
        f"a chunk: worker {out['disagg']['worker_chunk_ms']['host_med']:.2f} ms host / "
        f"{out['disagg']['worker_chunk_ms']['stream_med']:.2f} ms stream in the waves, loop "
        f"{loop_chunks['host_med']:.2f} / {loop_chunks['stream_med']:.2f} ms idle")
    log(f"disaggregation phase on {card}: {out['seconds']:.1f} s (overcommit arm "
        f"{out['overcommit']['seconds']:.1f} s)")
    return out


# the migration phase: sessions of the serving wave's prompts, each parked
# inside the delivery of its MG_PARK_AT-th token and moved; MG_BUDGET tokens
# a stream (the main path's plain-trunk references run COMPARE_TOKENS), the
# drain arm's live session MG_LIVE_BUDGET. The host arm's source has a pool
# of MG_SMALL_POOL blocks, so a second session's admission evicts the parked
# first to its host tier of MG_HOST blocks
MG_BUDGET = 48
MG_PARK_AT = 16
MG_LIVE_BUDGET = 64
MG_SMALL_POOL = 10
MG_HOST = 8
# a held loop thread lets go after this many seconds at most (a hang
# guard: the phase fails when one expired)
MG_HOLD_S = 120.0
MG_EXPIRED_HOLDS: list = []


def mg_serving(**kw):
    """The flagship's serving config of the migration phase: the main
    path's (pipelined on graphs, paged, slots 4, the 1024 bucket) with
    kv_swap set, and ``kw``."""
    from vtpu_torch.serving import ServingConfig

    return ServingConfig(**{**dict(slots=4, prefill_buckets=(1024,), kv_page=128,
                                   max_new_tokens=MG_BUDGET, kv_swap=0), **kw})


def park_asked(eng, req) -> bool:
    """Whether a park command for ``req`` waits in ``eng``'s lifecycle
    queue."""
    return any(kind == "park" and item is req for kind, item in list(eng._lifecycle_q.queue))


def hold_loop(held: threading.Event, until):
    """A delivery action (on_token) that holds the loop thread, setting
    ``held``, until ``until()`` is true: a request submitted meanwhile stays
    in the engine's pending queue, and a command the client queues is taken
    at the next tick head, whatever the host's speed. MG_HOLD_S ends a hold
    that waits in vain, and the phase then fails (MG_EXPIRED_HOLDS)."""
    def hold():
        held.set()
        t0 = time.perf_counter()
        while not until():
            if time.perf_counter() - t0 > MG_HOLD_S:
                MG_EXPIRED_HOLDS.append(held)
                return
            time.sleep(0.0005)

    return hold


def wait_event(lc, event: str, s) -> None:
    """Block until the engine's trace (Lifecycle ``lc``) recorded ``event``
    for session ``s``."""
    with lc.cond:
        if not lc.cond.wait_for(lambda: lc.counts[event, s.req.rid] >= 1, timeout=120):
            raise AssertionError(f"no {event} event within 120 s")


def migration_path(log, card: str, params, refs: dict) -> dict:
    """Live migration and drain at the flagship's full width and depth,
    bf16, on the pipelined loop on graphs: three engines on the card with
    the seeded weights, a source (a FaultPlan of migrate_src_death at 0), a
    source with a small pool and a host tier, and a destination. Arms, each
    session parked from inside its MG_PARK_AT-th token's delivery unless
    said otherwise: recompute (the source dies after the handshake: the
    destination rebuilds from the token history), resident (pages uploaded
    into the destination's pool), requeue (a request held in the source's
    queue by a held loop, parked unstarted by migrate() and admitted on the
    destination), host (a parked session evicted to the small source's host
    tier by a second admission, its payload read from host memory), and
    drain (a live, a parked and a waiting session and a cancelled one, then
    src.drain(dst)). Held: every moved stream against the plain trunk
    (refs["bf16"], the margin rule; the rebuilt one teacher-forced,
    check_forced), each report's path, the migration counters and bytes,
    migration_copies 0, every pool and host tier free, the drained source
    empty with submit refused, the cancelled request CANCELLED, no state
    tensor moved and no graph captured, one replay and 12 paged launches a
    decode tick on each engine, every stats() key in the exporter's
    tables."""
    import importlib

    from vtpu_torch.models import ModelConfig
    from vtpu_torch.obs import export
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import FaultPlan, FaultSpec, migrate

    t_phase = time.perf_counter()
    laps = Laps()
    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    forced = forced_trunk(params, dataclasses.replace(cfg, use_kernels=False))
    prompts = wave_prompts(cfg.vocab)
    wave_refs = refs["bf16"]
    # the extract's snapshot (staging gathers and the one D2H wait, or the
    # host tier's read), timed on the source's loop thread
    mig = importlib.import_module("vtpu_torch.serving.migrate")
    snapshot, snaps = mig._snapshot_payload, []

    def timed_snapshot(eng, e):
        t0 = time.perf_counter()
        out = snapshot(eng, e)
        snaps.append({"ms": (time.perf_counter() - t0) * 1e3, "pages": e["n_pages"],
                      "bytes": e["n_pages"] * eng._block_bytes,
                      "from_host": e["host"] is not None})
        return out

    mig._snapshot_payload = timed_snapshot
    E = {"src": oc_engine(params, cfg, mg_serving(
             faults=FaultPlan([FaultSpec("migrate_src_death", at=0)]))),
         "host_src": oc_engine(params, cfg, mg_serving(kv_pool_blocks=MG_SMALL_POOL,
                                                       kv_swap=MG_HOST)),
         "dst": oc_engine(params, cfg, mg_serving())}
    engines = {name: e[0] for name, e in E.items()}
    src, lc = E["src"][0], E["src"][1]
    hsrc, hlc = E["host_src"][0], E["host_src"][1]
    dst = engines["dst"]
    laps.lap("build")
    for eng in engines.values():
        eng.start()
    moves, rows = [], {}
    try:
        before = {name: eng.stats() for name, eng in engines.items()}
        replays = {name: eng.decode_graphs.replays for name, eng in engines.items()}
        _build.reset_launches()

        def moved(arm, path, sess, rep, n):
            if rep["path"] != path:
                raise AssertionError(f"migration {arm} arm: report path {rep['path']!r}, "
                                     f"expected {path!r}")
            moves.append((arm, sess, rep, n))

        # recompute: the source's plan fires at its first extract
        s0 = Session(src, prompts[0], MG_BUDGET, park_at=MG_PARK_AT)
        lc.wait_parked([s0])
        drained(s0)
        n0 = len(s0.toks)
        moved("recompute", "recompute", s0, migrate(s0.req, src, dst), n0)
        s0.join()
        laps.lap("recompute")
        # requeue and resident: s1's first token holds the loop while w is
        # submitted and migrate() asks for its park
        s1 = Session(src, prompts[1], MG_BUDGET, park_at=MG_PARK_AT)
        held, box = threading.Event(), {}
        on_token(s1.req, 1, hold_loop(held, lambda: "w" in box
                                      and park_asked(src, box["w"].req)))
        if s1.req.delivered:
            raise AssertionError("a token was delivered before the hold was in place")
        if not held.wait(120):
            raise AssertionError("the loop was not held within 120 s")
        box["w"] = w = Session(src, prompts[2], MG_BUDGET)
        moved("requeue", "requeue", w, migrate(w.req, src, dst), 0)
        lc.wait_parked([s1])
        drained(s1)
        n1 = len(s1.toks)
        moved("resident", "resident", s1, migrate(s1.req, src, dst), n1)
        w.join()
        s1.join()
        laps.lap("requeue + resident")
        # host: y's admission evicts the parked x to the small source's tier
        x = Session(hsrc, prompts[2], MG_BUDGET, park_at=MG_PARK_AT)
        hlc.wait_parked([x])
        y = Session(hsrc, prompts[3], MG_BUDGET)
        wait_event(hlc, "evict", x)
        drained(x)
        nx = len(x.toks)
        # read from the source's host tier, landed in the destination's pool
        moved("host", "resident", x, migrate(x.req, hsrc, dst), nx)
        x.join()
        y.join()
        laps.lap("host")
        # drain: p parked, live held (by its next token) until drain asks
        # for its park, waiting and cancelled submitted while it is held
        p = Session(src, prompts[3], MG_BUDGET, park_at=MG_PARK_AT)
        live = Session(src, prompts[4], MG_LIVE_BUDGET)
        lc.wait_parked([p])
        go, held2 = threading.Event(), threading.Event()
        on_token(live.req, 1, hold_loop(held2, lambda: go.is_set()
                                        and park_asked(src, live.req)))
        if not held2.wait(120):
            raise AssertionError("the loop was not held within 120 s")
        waiting = Session(src, prompts[5], MG_BUDGET)
        cancelled = src.submit(prompts[0], max_new_tokens=MG_BUDGET)
        cancelled.cancel()
        go.set()
        t0 = time.perf_counter()
        report = src.drain(dst)
        drain_ms = (time.perf_counter() - t0) * 1e3
        try:
            src.submit(prompts[0])
        except RuntimeError as exc:
            if "draining" not in str(exc):
                raise
        else:
            raise AssertionError("a drained source accepted a submit")
        for q in (p, live, waiting):
            q.join()
        list(cancelled.stream())
        if cancelled.status != "CANCELLED":
            raise AssertionError(f"the cancelled request ended {cancelled.status}")
        if (report["migrated"] + report["completed"], report["faulted"]) != (3, 0):
            raise AssertionError(f"drain report {report}: three sessions owed, none faulted")
        laps.lap("drain")
        for eng in engines.values():
            settle(eng)
        after = {name: eng.stats() for name, eng in engines.items()}
        launches = _build.launches()
        played = {name: eng.decode_graphs.replays - replays[name]
                  for name, eng in engines.items()}
    finally:
        mig._snapshot_payload = snapshot
        for eng in engines.values():
            eng.stop()
    if MG_EXPIRED_HOLDS:
        raise AssertionError("a held loop was never asked for the command it waited for")
    for name, (eng, _, ptrs, captured) in E.items():
        oc_held(eng, ptrs, captured, f"migration {name}")
    # streams: the rebuilt one teacher-forced, every other under the margin rule
    held_forced = check_forced(forced, [(prompts[0], s0.toks, n0)], "migration recompute arm")
    streams = [(s1, 1), (w, 2), (x, 2), (y, 3), (p, 3), (live, 4), (waiting, 5)]
    compared, ties = check_streams([q.toks for q, _ in streams],
                                   [wave_refs[i] for _, i in streams], "migration")
    # counters
    d = {name: {k: after[name][k] - before[name][k] for k in (
        "decode_ticks", "paged_attn_kernel_ticks", "migrations_out", "migrations_in",
        "migrate_out_bytes", "migrate_in_bytes", "migration_copies", "migrate_recomputes",
        "migrate_failures", "faults_injected", "swap_out_bytes")} for name in engines}
    bpb = block_bytes(dst)
    shipped = [rep["bytes"] for _, _, rep, _ in moves if rep["path"] == "resident"]
    want = {"src": {"migrations_out": 3 + report["migrated"], "faults_injected": 1},
            "host_src": {"migrations_out": 1},
            "dst": {"migrations_in": 4 + report["migrated"], "migrate_recomputes": 1}}
    for name, kv in want.items():
        got = {k: d[name][k] for k in kv}
        if got != kv:
            raise AssertionError(f"migration {name}: counters {got}, the moves imply {kv}")
    out_bytes = d["src"]["migrate_out_bytes"] + d["host_src"]["migrate_out_bytes"]
    if not (out_bytes == d["dst"]["migrate_in_bytes"] > 0 and len(shipped) == 2
            and all(b > 0 and b % bpb == 0 for b in shipped) and sum(shipped) <= out_bytes
            and (out_bytes - sum(shipped)) % bpb == 0):
        raise AssertionError(f"migration bytes: out {out_bytes}, in "
                             f"{d['dst']['migrate_in_bytes']}, reports {shipped}")
    if any(d[n]["migration_copies"] or d[n]["migrate_failures"] for n in engines):
        raise AssertionError(f"migration copies or failures: {d}")
    if d["host_src"]["swap_out_bytes"] <= 0 or [sn["from_host"] for sn in snaps].count(True) != 1:
        raise AssertionError("the host arm's payload was not read from the host tier")
    for name, s in after.items():
        if (s["kv_pool_free"] != s["kv_pool_blocks"] or s["parked_sessions"]
                or s["active_slots"] or s["queued"] or s["admitting_slots"]
                or (s["swap_host_blocks"] and s["swap_host_free"] != s["swap_host_blocks"])):
            raise AssertionError(f"migration {name}: not empty at the end: pool "
                                 f"{s['kv_pool_free']} of {s['kv_pool_blocks']} free, host "
                                 f"{s['swap_host_free']} of {s['swap_host_blocks']}, "
                                 f"{s['parked_sessions']} parked, {s['active_slots']} live, "
                                 f"{s['queued']} queued")
        if s["draining"] != (name == "src"):
            raise AssertionError(f"migration {name}: draining {s['draining']}")
        missing = sorted(k for k in s if k not in set(export.COUNTERS) | set(export.GAUGES)
                         | set(export.HIST_COUNTERS) | export.SPECIAL | export.ALLOWLIST)
        if missing:
            raise AssertionError(f"migration {name}: stats() keys with no exporter family: "
                                 f"{missing}")
    ticks = sum(d[n]["decode_ticks"] for n in engines)
    others = {k: v for k, v in launches.items()
              if k not in ("paged_decode_attention", "flash_attention") and v}
    if (launches["paged_decode_attention"] != FLAGSHIP["n_layers"] * ticks or others
            or launches["flash_attention"] <= 0):
        raise AssertionError(f"migration: launches {launches} over {ticks} decode ticks")
    for name in engines:
        if not (played[name] == d[name]["decode_ticks"] == d[name]["paged_attn_kernel_ticks"]):
            raise AssertionError(f"migration {name}: {played[name]} replays, "
                                 f"{d[name]['decode_ticks']} decode ticks, "
                                 f"{d[name]['paged_attn_kernel_ticks']} on the kernel route")
    if d["dst"]["decode_ticks"] <= 0:
        raise AssertionError("the destination decoded no tick")
    for arm, sess, rep, n in moves:
        rows[arm] = {"path": rep["path"], "ms": rep["ms"], "bytes": rep["bytes"], "src_died": rep["src_died"],
                      "gb_per_s": rep["bytes"] / (rep["ms"] * 1e6) if rep["bytes"] else None,
                      "pause_ms": ((sess.times[n] - sess.times[n - 1]) * 1e3 if n else None),
                      "tokens_at_move": n}
    seconds = time.perf_counter() - t_phase
    for arm, r in rows.items():
        log(f"migration {arm} arm on {card}: path {r['path']}, migrate() {r['ms']:.2f} ms, "
            f"payload {r['bytes']} "
            f"bytes" + (f" ({r['bytes'] / bpb:.0f} blocks of {bpb}, {r['gb_per_s']:.2f} GB/s "
                        "over the call)" if r["bytes"] else "")
            + (f", pause {r['pause_ms']:.2f} ms (last source token to first destination "
               f"token, {r['tokens_at_move']} tokens before the move)" if r["pause_ms"] else "")
            + (", the source died after the handshake" if r["src_died"] else ""))
    for sn in snaps:
        log(f"migration snapshot on {card}: {sn['pages']} blocks, {sn['bytes']} bytes "
            f"{'from the host tier' if sn['from_host'] else 'gathered and copied to the host'} "
            f"in {sn['ms']:.2f} ms on the loop thread ({sn['bytes'] / (sn['ms'] * 1e6):.2f} GB/s)")
    log(f"migration drain on {card}: {drain_ms:.2f} ms, {report['migrated']} sessions moved, "
        f"{report['completed']} completed on the source, {report['faulted']} faulted")
    log(f"migration streams: {compared} tokens equal to the plain trunk, {ties} cut at a margin "
        f"< {MARGIN}; the rebuilt stream teacher-forced: {held_forced['held']} held, "
        f"{held_forced['skipped']} skipped (widest flip {held_forced['widest_flip']:.4f}); "
        f"counters {d}; launches {launches}; replays {played}")
    log(f"migration phase on {card}: {seconds:.1f} s; sub-steps, wall s: {laps.line()}")
    return {"launches": launches, "moves": rows, "snapshots": snaps,
            "drain": {**report, "ms": drain_ms}, "counters": d, "replays": played,
            "compared_tokens": compared, "margin_cuts": ties, "forced": held_forced,
            "seconds": seconds, "laps_s": laps.s, "block_bytes": bpb}


# phase o, the engine fleet: three flagship engines behind one EngineFleet
# on the card. FL_BUDGET tokens a stream (the failover arm's FL_LONG), a
# host tier of FL_HOST blocks a member; the doomed member's sessions are
# parked at FL_PARK_AT and the death armed once the live one has delivered
# FL_KILL_AT. Prefix-backed requests ride a PREFIX_LEN-token prefix with
# suffixes of FL_SUFFIXES tokens. FL_QUEUE_SLOT_MS prices a millisecond of
# avoided prefill as one queue slot of pressure, so a resident wins the
# route against a peer one queue slot less busy per ms its build took
FL_BUDGET = 32
FL_LONG = 64
FL_HOST = 16
FL_PARK_AT = 4
FL_KILL_AT = 12
FL_SUFFIXES = (96, 160)
FL_QUEUE_SLOT_MS = 1.0


# the flagship's serving config of the fleet phases: the main path's
# (pipelined on graphs, paged, slots 4, the 1024 bucket) with kv_swap and
# prefill_chunk set
FL_SERVING = dict(slots=4, prefill_buckets=(1024,), kv_page=128, prefill_chunk=CHUNK,
                  max_new_tokens=FL_LONG, kv_swap=FL_HOST)


def fl_serving(**kw):
    """FL_SERVING as a ServingConfig, with ``kw``."""
    from vtpu_torch.serving import ServingConfig

    return ServingConfig(**{**FL_SERVING, **kw})


class SteerPolicy:
    """The fleet's route policy in phase o: LeastPressureRoutePolicy,
    except that while ``pin`` names an engine that engine wins (the arm
    that fills the member it then kills)."""

    def __init__(self):
        from vtpu_torch.serving import LeastPressureRoutePolicy

        self.base, self.pin = LeastPressureRoutePolicy(), None

    def score(self, name, signals):
        s = self.base.score(name, signals)
        if s is None or self.pin is None:
            return s
        return s + (100.0 if name == self.pin else 0.0)


def fl_prompts(vocab: int) -> tuple:
    """(the prefix, the suffixes, a second prefix for the spill arm) of the
    fleet phase from SEED."""
    rs = np.random.RandomState(SEED + 7)
    prefix = rs.randint(0, vocab, (PREFIX_LEN,)).astype(np.int32)
    sufs = [rs.randint(0, vocab, (n,)).astype(np.int32) for n in FL_SUFFIXES]
    cold = rs.randint(0, vocab, (PREFIX_LEN,)).astype(np.int32)
    return prefix, sufs, cold


def fleet_path(log, card: str, params, refs: dict) -> dict:
    """The engine fleet at the flagship's full width and depth, bf16, on
    the pipelined loop on graphs: three engines on the card with the seeded
    weights behind one EngineFleet (members a, b and c; c carries an
    engine_death FaultPlan; the fleet a probe_loss plan eating b's probes
    in its first two rounds). Arms: suspect (b walks to SUSPECT and back,
    no failover), route (the wave prompts through fleet.submit), prefix (a
    prefix registered on a, prefix-aware submits routed onto its resident,
    hot replication onto a peer through chunked prefill, a second prefix
    spilled cold to the host tier and installed on the route's winner),
    failover (c holds a live, a parked and a prefix-backed session when its
    loop dies at a tick head; each is rebuilt on a survivor, the
    prefix-backed one around a resident copy of its prefix), drain (b's
    sessions placed on the best survivor), export (register_fleet and one
    scrape). Held: every stream against the plain trunk (refs["bf16"] or
    its own plain reference under the margin rule; the rebuilt ones
    teacher-forced, check_forced), the fleet counters and health states
    the arms imply, prefix_install_copies 0, failover_prefix_reuses with a
    rebuild of the tail alone, one replay and 12 paged launches a decode
    tick on each member, no graph captured while serving and no state
    tensor moved, every pool and host tier free at the end (the corpse
    reaped), the corpse's post-mortem bundle valid, every fleet and member
    stats() key in the exporter's tables."""
    import importlib

    from vtpu_torch.models import ModelConfig
    from vtpu_torch.obs import ServingCollector, export
    from vtpu_torch.obs.fleettrace import validate_bundle
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import EngineFleet, FaultPlan, FaultSpec, FleetConfig

    t_phase = time.perf_counter()
    laps = Laps()
    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    forced = forced_trunk(params, plain)
    prompts = wave_prompts(cfg.vocab)
    wave_refs = refs["bf16"]
    prefix, sufs, cold = fl_prompts(cfg.vocab)
    full = [np.concatenate([prefix, s]) for s in sufs]
    cold_full = np.concatenate([cold, sufs[0]])
    pre_refs = [reference_stream(params, plain, p, FL_BUDGET) for p in full + [cold_full]]
    laps.lap("references")
    # the prefix movement (export on a donor's loop, install on the
    # destination's) and every rebuild, timed where the fleet calls them
    fl_mod = importlib.import_module("vtpu_torch.serving.fleet")
    export_fn, install_fn, moves = fl_mod.export_prefix, fl_mod.install_prefix, []

    def timed_export(eng, lid, timeout=30.0):
        t0 = time.perf_counter()
        meta, payload = export_fn(eng, lid, timeout=timeout)
        moves.append({"op": "export", "ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": sum(x.numel() * x.element_size() for x in payload.values())})
        return meta, payload

    def timed_install(eng, meta, payload, timeout=30.0):
        t0 = time.perf_counter()
        res = install_fn(eng, meta, payload, timeout=timeout)
        moves.append({"op": "install", "ms": (time.perf_counter() - t0) * 1e3,
                      "bytes": sum(x.numel() * x.element_size() for x in payload.values()),
                      "installed": res.get("installed", True)})
        return res

    fl_mod.export_prefix, fl_mod.install_prefix = timed_export, timed_install
    death = FaultPlan()
    E = {"a": oc_engine(params, cfg, fl_serving()), "b": oc_engine(params, cfg, fl_serving()),
         "c": oc_engine(params, cfg, fl_serving(faults=death))}
    engines = {name: e[0] for name, e in E.items()}
    for name in engines:
        # the rebuilds' fault_recompute events (val: positions recomputed)
        E[name] = (E[name][0], Lifecycle(engines[name], ("park", "fault_recompute")),
                   *E[name][2:])
    a, b, c = engines["a"], engines["b"], engines["c"]
    policy = SteerPolicy()
    # probes walk the members in name order each round: arrivals 1 and 4
    # are b's probes in the first two rounds
    probes = FaultPlan([FaultSpec("probe_loss", at=1), FaultSpec("probe_loss", at=4)])
    fleet = EngineFleet(engines, FleetConfig(route_policy=policy, faults=probes,
                                             prefix_queue_slot_ms=FL_QUEUE_SLOT_MS))
    rebuilds = []
    note_rebuild = fleet.trace.note_rebuild

    def timed_rebuild(seconds):
        rebuilds.append(seconds * 1e3)
        note_rebuild(seconds)

    fleet.trace.note_rebuild = timed_rebuild
    laps.lap("build")
    out: dict = {}
    try:
        before = {name: eng.stats() for name, eng in engines.items()}
        replays = {name: eng.decode_graphs.replays for name, eng in engines.items()}
        _build.reset_launches()
        fleet.start()

        def wait_for(cond, what: str, timeout: float = 120.0):
            t0 = time.perf_counter()
            while not cond():
                if time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"fleet: {what} did not happen within {timeout:.0f} s")
                time.sleep(0.002)

        # suspect: b's first two probes are eaten; it recovers at its next beat
        wait_for(lambda: fleet.stats(include_engines=False)["suspects"] >= 1, "b's SUSPECT")
        wait_for(lambda: fleet.stats(include_engines=False)["engine_states"]["b"] == "HEALTHY",
                 "b's recovery")
        laps.lap("suspect")
        # route: the wave through the front door, least pressure first
        wave = [Session(fleet, p, FL_BUDGET) for p in prompts]
        placed = collections.Counter(fleet._assigned.get(s.req, "done") for s in wave)
        for s in wave:
            s.join()
        laps.lap("route")
        # cold: a prefix registered on b and never used spills to the host
        # tier (the only prefix registered, so the only candidate); a pid
        # submit then installs it on the route's winner, and it is dropped
        # there again so it never competes in the hot arm
        qpid = fleet.register_prefix(cold, engine="b")
        fleet.fleet = dataclasses.replace(fleet.fleet, prefix_spill_idle_s=0.2)
        wait_for(lambda: fleet.prefixdir.in_host_tier(qpid)
                 and not fleet.prefixdir.residents(qpid), "the cold spill")
        fleet.fleet = dataclasses.replace(fleet.fleet, prefix_spill_idle_s=None)
        tiered = Session(fleet, sufs[0], FL_BUDGET, pid=qpid)
        tier_at = fleet._assigned.get(tiered.req)
        tiered.join()
        engines[tier_at].unregister_prefix(fleet.prefixdir.residents(qpid)[tier_at])
        # prefix: registered on a, then routed onto its resident
        cpid = fleet.register_prefix(prefix, engine="a")
        routed = [Session(fleet, s, FL_BUDGET, prefix_tokens=prefix) for s in sufs]
        route_at = [fleet._assigned.get(s.req) for s in routed]
        for s in routed:
            s.join()
        # hot: past one hit it replicates onto the least-pressured peer
        # through chunked prefill
        fleet.fleet = dataclasses.replace(fleet.fleet, prefix_replicate_hits=1,
                                          prefix_max_replicas=2)
        wait_for(lambda: len(fleet.prefixdir.residents(cpid)) == 2, "the hot replication")
        fleet.fleet = dataclasses.replace(fleet.fleet, prefix_replicate_hits=None)
        replica = sorted(set(fleet.prefixdir.residents(cpid)) - {"a"})[0]
        laps.lap("prefix")
        # failover: c holds a live session, a parked one and a prefix-backed
        # one; its loop dies at the tick head after the live one's
        # FL_KILL_AT-th token, once the park settled
        if "c" not in fleet.prefixdir.residents(cpid):
            fleet.register_prefix(prefix, engine="c")
        policy.pin = "c"
        live = Session(fleet, prompts[0], FL_LONG)
        parked = Session(fleet, prompts[1], FL_LONG, park_at=FL_PARK_AT, parker=c)
        pref = Session(fleet, sufs[1], FL_LONG, prefix_tokens=prefix)
        policy.pin = None
        doomed = [live, parked, pref]
        if any(fleet._assigned.get(s.req) != "c" for s in doomed):
            raise AssertionError("fleet failover arm: a session was not placed on c")
        armed = []
        put = live.req.out.put

        def arm_death(item):
            # inside the live session's delivery, on c's loop thread: the
            # next tick head records the ledger, beats, and dies
            put(item)
            if (not armed and live.req.delivered >= FL_KILL_AT and parked.req in c._parked
                    and pref.req.delivered >= 2):
                armed.append([s.req.delivered for s in doomed])
                death.arm("engine_death")

        live.req.out.put = arm_death
        for s in doomed:
            s.join()
        if not armed:
            raise AssertionError("fleet failover arm: the death was never armed")
        wait_for(lambda: fleet.stats(include_engines=False)["failovers"] >= 1, "the failover")
        laps.lap("failover")
        # drain: b's sessions (pinned there) land on the best survivor
        policy.pin = "b"
        drained_s = [Session(fleet, prompts[j], FL_BUDGET) for j in (2, 3)]
        policy.pin = None
        t0 = time.perf_counter()
        report = fleet.drain("b")
        drain_ms = (time.perf_counter() - t0) * 1e3
        for s in drained_s:
            s.join()
        try:
            b.submit(prompts[0])
        except RuntimeError as exc:
            if "draining" not in str(exc):
                raise
        else:
            raise AssertionError("a drained member accepted a submit")
        laps.lap("drain")
        # export: one scrape of the registered fleet
        col = ServingCollector()
        col.register_fleet("fleet", fleet)
        fams = list(col.collect())
        col.unregister_fleet("fleet")
        for eng in (a, b):
            settle(eng)
        fs = fleet.stats()
        after = {name: eng.stats() for name, eng in engines.items()}
        launches = _build.launches()
        played = {name: eng.decode_graphs.replays - replays[name]
                  for name, eng in engines.items()}
    finally:
        fl_mod.export_prefix, fl_mod.install_prefix = export_fn, install_fn
        fleet.stop()
    # every prefix still registered (the corpse's included) goes, then every
    # pool and host tier must read free
    for eng in engines.values():
        for lid in list(eng._prefixes):
            eng.unregister_prefix(lid)
    for name, (eng, _, ptrs, captured) in E.items():
        oc_held(eng, ptrs, captured, f"fleet {name}")
        s = eng.stats()
        if (s["kv_pool_free"] != s["kv_pool_blocks"] or s["parked_sessions"]
                or s["active_slots"] or s["queued"] or s["admitting_slots"]
                or s["swap_host_free"] != s["swap_host_blocks"]):
            raise AssertionError(f"fleet {name}: not empty at the end: pool {s['kv_pool_free']} "
                                 f"of {s['kv_pool_blocks']} free, host {s['swap_host_free']} of "
                                 f"{s['swap_host_blocks']}, {s['parked_sessions']} parked, "
                                 f"{s['active_slots']} live, {s['queued']} queued")
    # streams: the route wave and the drained under the margin rule, the
    # prefixed against their own plain references, the rebuilt teacher-forced
    compared, ties = check_streams([s.toks for s in wave], wave_refs, "fleet route")
    n2, t2 = check_streams([s.toks for s in drained_s], [wave_refs[2], wave_refs[3]],
                           "fleet drain")
    n3, t3 = check_streams([s.toks for s in routed + [tiered]], pre_refs, "fleet prefix")
    compared, ties = compared + n2 + n3, ties + t2 + t3
    held_forced = check_forced(forced, [(prompts[0], live.toks, armed[0][0]),
                                        (prompts[1], parked.toks, armed[0][1]),
                                        (full[1], pref.toks, armed[0][2])], "fleet failover")
    # counters and health: two SUSPECT transitions, b's and c's on its way
    # to DEAD
    want = {"failovers": 1, "failover_sessions": 3, "failover_faulted": 0, "suspects": 2,
            "prefix_replications": 1, "prefix_spills": 1, "dead_engines": 1,
            "healthy_engines": 2, "draining_engines": 1, "postmortem_bundles": 1}
    got = {k: fs[k] for k in want}
    if got != want or fs["engine_states"] != {"a": "HEALTHY", "b": "HEALTHY", "c": "DEAD"}:
        raise AssertionError(f"fleet counters {got}, states {fs['engine_states']}: the arms "
                             f"imply {want}")
    if route_at != ["a", "a"] or fs["prefix_routes"] != 4 or fs["prefix_installs"] < 1:
        raise AssertionError(f"fleet prefix routes: {route_at}, prefix_routes "
                             f"{fs['prefix_routes']}, installs {fs['prefix_installs']}")
    if (report["faulted"], report["migrated"] + report["completed"]) != (0, 2):
        raise AssertionError(f"fleet drain report {report}: two sessions owed, none faulted")
    d = {name: {k: after[name][k] - before[name][k] for k in (
        "decode_ticks", "paged_attn_kernel_ticks", "prefix_install_copies",
        "prefix_tier_installs", "prefix_exports", "failover_prefix_reuses",
        "migration_copies")} for name in engines}
    if any(d[n]["prefix_install_copies"] or d[n]["migration_copies"] for n in engines):
        raise AssertionError(f"fleet: staged copies beyond the contract: {d}")
    reuses = sum(d[n]["failover_prefix_reuses"] for n in engines)
    tails = [val for n in ("a", "b") for ev, _, val in E[n][1].events("fault_recompute")]
    bundle = fleet.trace.bundles().get("c")
    if not validate_bundle(bundle):
        raise AssertionError("fleet: the corpse's post-mortem bundle is not valid")
    # the prefix-backed session's cache length at death, from the corpse's
    # ledger census: its rebuild recomputed exactly the positions past the
    # prefix
    (census,) = [e for e in bundle["ledger"] if e["jid"] == pref.req.jid]
    tail = census["seq_len"] - PREFIX_LEN
    if reuses != 1 or tail not in tails:
        raise AssertionError(f"fleet failover: {reuses} prefix reuses, rebuilt tails {tails}; "
                             f"expected one of {tail} positions")
    journeys = fleet.trace.journeys()
    doomed_j = [journeys[s.req.jid] for s in doomed]
    if any([h["kind"] for h in j["hops"]] != ["route", "failover"] or not j["conserved"]
           for j in doomed_j):
        raise AssertionError("fleet failover journeys: "
                             f"{[[h['kind'] for h in j['hops']] for j in doomed_j]}")
    fleet_keys = (set(export.FLEET_COUNTERS) | set(export.FLEET_GAUGES)
                  | export.FLEET_SPECIAL | export.FLEET_ALLOWLIST)
    engine_keys = (set(export.COUNTERS) | set(export.GAUGES) | set(export.HIST_COUNTERS)
                   | export.SPECIAL | export.ALLOWLIST)
    missing = sorted(k for k in fs if k not in fleet_keys) + sorted(
        {k for s in after.values() for k in s if k not in engine_keys})
    names = [f.name for f in fams]
    if missing or len(names) != len(set(names)) or not any(
            n.startswith("vtpu_serving_fleet_") for n in names):
        raise AssertionError(f"fleet export: unmapped keys {missing}, {len(names)} families "
                             f"({len(set(names))} names)")
    ticks = sum(d[n]["decode_ticks"] for n in engines)
    others = {k: v for k, v in launches.items()
              if k not in ("paged_decode_attention", "flash_attention") and v}
    if (launches["paged_decode_attention"] != FLAGSHIP["n_layers"] * ticks or others
            or launches["flash_attention"] <= 0):
        raise AssertionError(f"fleet: launches {launches} over {ticks} decode ticks")
    for name in engines:
        if not (played[name] == d[name]["decode_ticks"] == d[name]["paged_attn_kernel_ticks"]):
            raise AssertionError(f"fleet {name}: {played[name]} replays, "
                                 f"{d[name]['decode_ticks']} decode ticks, "
                                 f"{d[name]['paged_attn_kernel_ticks']} on the kernel route")
    # figures: detection (c's last beat -> DEAD), rebuilds, the pauses
    dead_ev = [e for e in fleet.trace.events() if e["event"] == "dead"]
    detect_ms = ((dead_ev[0]["ts_ns"] - c._beat_ns) / 1e6) if dead_ev else None
    pauses = [bo["ms"] for j in doomed_j for bo in j["blackouts"] if bo["ms"] is not None]
    seconds = time.perf_counter() - t_phase
    out = {"launches": launches, "placed": dict(placed), "prefix_routes_at": route_at,
           "replica": replica, "tier_install_at": tier_at, "counters": d,
           "fleet": {k: fs[k] for k in want}, "detect_ms": detect_ms, "rebuild_ms": rebuilds,
           "pause_ms": pauses, "drain": {**report, "ms": drain_ms}, "prefix_moves": moves,
           "replays": played, "compared_tokens": compared, "margin_cuts": ties,
           "forced": held_forced, "tails": tails, "prefix_tail": tail, "seconds": seconds,
           "laps_s": laps.s}
    log(f"fleet route wave on {card}: {sum(placed.values())} requests placed {dict(placed)} by "
        f"least pressure; prefix routes {route_at}, replicated onto {replica}, the spilled "
        f"prefix installed from the host tier on {tier_at}")
    log(f"fleet failover on {card}: detection {detect_ms:.1f} ms (c's last beat to DEAD), "
        f"rebuild ms per session {[round(x, 2) for x in rebuilds]}, pause across the failover "
        f"(last token on c to first on the survivor) ms {[round(x, 2) for x in pauses]}, "
        f"tokens at death {armed[0]}, rebuilt tails {tails}")
    for m in moves:
        log(f"fleet prefix {m['op']} on {card}: {m['ms']:.2f} ms, {m['bytes']} bytes "
            f"({m['bytes'] / (m['ms'] * 1e6):.2f} GB/s over the call)")
    log(f"fleet drain on {card}: {drain_ms:.2f} ms, {report['migrated']} moved, "
        f"{report['completed']} completed on the source")
    log(f"fleet streams: {compared} tokens equal to the plain trunk, {ties} cut at a margin "
        f"< {MARGIN}; rebuilt streams teacher-forced: {held_forced['held']} held, "
        f"{held_forced['skipped']} skipped; counters {d}; launches {launches}; replays {played}")
    log(f"fleet phase on {card}: {seconds:.1f} s; sub-steps, wall s: {laps.line()}")
    return out


# phase p, the fabric: the child's decode stalls FB_THROTTLE_S a fetch (so a
# SIGKILL lands mid-stream: its token rate is no speed figure), and is
# killed once the stream pinned to it has delivered FB_KILL_AT tokens
FB_THROTTLE_S = 0.01
FB_KILL_AT = 3
FB_SPAWN_TIMEOUT_S = 120.0


def hook_submits(eng, action_for):
    """Run ``action_for(req)`` on every request ``eng.submit`` queues, before
    the loop can see it (the engine's pending queue's put is wrapped): a
    hook installed there races no delivery. Returns the unhook function."""
    put = eng._pending.put

    def hooked(req, *a, **kw):
        action_for(req)
        return put(req, *a, **kw)

    eng._pending.put = hooked

    def unhook():
        eng._pending.put = put

    return unhook


def on_loop_token(req, eng, n: int, action) -> None:
    """on_token counting only the tokens ``eng``'s loop thread puts on
    ``req``'s stream (a migrated stream is fed by several engines, a fabric
    proxy's from its receive thread)."""
    put, seen = req.out.put, [0]

    def hook(item):
        put(item)
        if isinstance(item, int) and threading.current_thread() is eng._thread:
            seen[0] += 1
            if seen[0] == n:
                action()

    req.out.put = hook


def fabric_path(log, card: str, params, refs: dict) -> dict:
    """The fabric at the flagship's full width and depth, bf16, on the
    pipelined loop on graphs: a spawned child engine host on the card over
    TCP (r1, host h0), an in-proc EngineHost over a loopback link (r0) and a
    local engine (l), behind one EngineFleet. See phase p in the module
    docstring for the arms, what is held and what is printed."""
    import os
    import signal

    from vtpu_torch.models import ModelConfig
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import (
        EngineFleet,
        EngineHost,
        FleetConfig,
        connect_host,
        export_prefix,
        install_prefix,
        loopback_pair,
        spawn_host,
        tcp_connect,
    )

    t_phase = time.perf_counter()
    laps = Laps()
    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    forced = forced_trunk(params, plain)
    prompts = wave_prompts(cfg.vocab)
    wave_refs = refs["bf16"]
    prefix, sufs, _ = fl_prompts(cfg.vocab)
    pre_ref = reference_stream(params, plain, np.concatenate([prefix, sufs[0]]), FL_BUDGET)
    laps.lap("references")
    # p2's child first, alone on the host's side of the card: its start-up
    # (interpreter, CUDA context, the seeded weights, graph capture) is timed
    # without this process competing
    spec = {"model": {**FLAGSHIP, "dtype": "bfloat16", "use_kernels": True}, "seed": SEED,
            "device": "cuda",
            "engines": {"r1": {**FL_SERVING, "prefill_buckets": list(FL_SERVING[
                "prefill_buckets"]), "faults": [dict(seam="delayed_fetch", at=0, count=10 ** 6,
                                                     arg=FB_THROTTLE_S)]}}}
    t0 = time.perf_counter()
    proc, port = spawn_host(spec, timeout=FB_SPAWN_TIMEOUT_S)
    fleet = tcp_client = lo_client = srv = None
    E: dict = {}
    try:
        spawn_ms = (time.perf_counter() - t0) * 1e3
        tcp_client, tcp_engines = connect_host(tcp_connect("127.0.0.1", port), host="h0",
                                               proc=proc)
        r1 = tcp_engines["r1"]
        while r1._beat_ns == 0:
            if time.perf_counter() - t0 > FB_SPAWN_TIMEOUT_S:
                raise AssertionError("the child's engine never beat")
            time.sleep(0.001)
        beat_ms = (time.perf_counter() - t0) * 1e3
        laps.lap("spawn")
        E = {"h": oc_engine(params, cfg, fl_serving()), "l": oc_engine(params, cfg, fl_serving())}
        h, l = E["h"][0], E["l"][0]
        h.start()
        srv = EngineHost({"r0": h})
        a, b, _ = loopback_pair(delay_s=0.0)
        threading.Thread(target=srv.serve_channel, args=(b,), daemon=True).start()
        lo_client, lo_engines = connect_host(a, host="loopback")
        r0 = lo_engines["r0"]
        policy = SteerPolicy()
        policy.pin = "r0"
        fleet = EngineFleet({"r0": r0, "r1": r1, "l": l}, FleetConfig(route_policy=policy))
        fleet.start()

        def join(sess, what):
            """Session.join with a short hang guard that says where the
            stream stands."""
            with sess.cond:
                if not sess.cond.wait_for(lambda: sess.ended, timeout=60):
                    fs_ = fleet.stats()
                    raise AssertionError(
                        f"fabric {what}: the stream holds {len(sess.toks)} tokens after 60 s "
                        f"(status {sess.req.status}, placed on "
                        f"{fleet._assigned.get(sess.req)}); states {fs_['engine_states']}; "
                        + "; ".join(f"{n}: live {st['active_slots']}, parked "
                                    f"{st['parked_sessions']}, migrations in/out "
                                    f"{st['migrations_in']}/{st['migrations_out']}"
                                    for n, st in fs_["engines"].items()))
            return sess.join()
        while r0._beat_ns == 0:
            time.sleep(0.001)
        laps.lap("build")
        _build.reset_launches()
        before = {"h": r0.stats(), "l": l.stats()}
        replays = {name: e[0].decode_graphs.replays for name, e in E.items()}
        # p1 route: the wave through the proxy r0
        wave = [Session(fleet, p, FL_BUDGET) for p in prompts]
        for s in wave:
            join(s, "route wave")
        settle(h)
        wave_stats = r0.stats()
        laps.lap("p1 route")
        # p1 migrate: a stream on r0 parks inside its FL_PARK_AT-th token on
        # h's loop (held there until the park is asked), moves to l, parks
        # inside its FL_PARK_AT-th token on l and moves back
        held1, held2 = threading.Event(), threading.Event()
        mirrors = []

        def hold_mirror(req):
            mirrors.append(req)
            on_token(req, FL_PARK_AT, hold_loop(held1, lambda: park_asked(h, req)))

        unhook = hook_submits(h, hold_mirror)
        m = Session(fleet, prompts[0], FL_LONG)
        unhook()
        on_loop_token(m.req, l, FL_PARK_AT, hold_loop(held2, lambda: park_asked(l, m.req)))
        if not held1.wait(120):
            raise AssertionError("fabric: r0's loop was not held within 120 s")
        lo_moves = [fleet.migrate_session(m.req, "l")]
        if not held2.wait(120):
            raise AssertionError("fabric: l's loop was not held within 120 s")
        lo_moves.append(fleet.migrate_session(m.req, "r0"))
        join(m, f"loopback migration {[r['path'] for r in lo_moves]}")
        laps.lap("p1 migrate")
        # p1 prefix: registered on l, exported there, installed on r0 over
        # the wire, a suffix streamed through the proxy
        lid = l.register_prefix(prefix)
        t0 = time.perf_counter()
        meta, payload = export_prefix(l, lid)
        export_ms = (time.perf_counter() - t0) * 1e3
        pre_bytes = sum(x.numel() * x.element_size() for x in payload.values())
        t0 = time.perf_counter()
        inst = install_prefix(r0, meta, payload)
        install_ms = (time.perf_counter() - t0) * 1e3
        pre = Session(r0, sufs[0], FL_BUDGET, prefix=inst["lid"])
        join(pre, "prefix")
        l.unregister_prefix(lid)
        r0.unregister_prefix(inst["lid"])
        laps.lap("p1 prefix")
        # p2 migrate: l -> r1 -> l over TCP, the park on l held as above;
        # the child's throttled decode keeps the stream live on r1
        held3 = threading.Event()
        policy.pin = "l"
        unhook = hook_submits(l, lambda req: on_token(
            req, FL_PARK_AT, hold_loop(held3, lambda: park_asked(l, req))))
        z = Session(fleet, prompts[1], FL_LONG)
        unhook()
        if not held3.wait(120):
            raise AssertionError("fabric: l's loop was not held within 120 s")
        tcp_moves = [fleet.migrate_session(z.req, "r1")]
        log(f"fabric: l -> r1 {tcp_moves[0]}, {len(z.toks)} tokens")
        tcp_moves.append(fleet.migrate_session(z.req, "l"))
        log(f"fabric: r1 -> l {tcp_moves[1]}, {len(z.toks)} tokens")
        join(z, f"TCP migration {[r['path'] for r in tcp_moves]}")
        laps.lap("p2 migrate")
        # p2 kill: a stream pinned to r1, the child SIGKILLed after
        # FB_KILL_AT tokens; the fleet fails it over onto l
        policy.pin = "r1"
        k = Session(fleet, prompts[2], FL_LONG)
        k.wait_tokens(FB_KILL_AT)
        child = r1.stats()
        policy.pin = "l"
        rate = (len(k.toks) - 1) / (k.times[-1] - k.times[0]) if len(k.toks) > 1 else None
        at_kill = k.req.delivered
        os.kill(proc.pid, signal.SIGKILL)
        rc = proc.wait(timeout=30)
        join(k, "failover")
        wait_s = time.perf_counter()
        while not fleet.trace.journeys()[k.req.jid]["ended"]:
            if time.perf_counter() - wait_s > 60:
                raise AssertionError("fabric: the failed-over journey did not close")
            time.sleep(0.002)
        laps.lap("p2 kill")
        settle(h)
        settle(l)
        fs = fleet.stats(include_engines=False)
        after = {"h": r0.stats(), "l": l.stats()}
        launches = _build.launches()
        played = {name: e[0].decode_graphs.replays - replays[name] for name, e in E.items()}
        journeys = fleet.trace.journeys()
        dead_ev = [e for e in fleet.trace.events() if e["event"] == "dead"]
        detect_ms = ((dead_ev[0]["ts_ns"] - r1._beat_ns) / 1e6) if dead_ev else None
        rtt = {"loopback": lo_client.rtt_ms, "tcp": tcp_client.rtt_ms}
    finally:
        if fleet is not None:
            fleet.stop()
        for c in (lo_client, tcp_client):
            if c is not None:
                c.close()
        if srv is not None:
            srv.stop()
        for e in E.values():
            e[0].stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if MG_EXPIRED_HOLDS:
        raise AssertionError("fabric: a held loop was never asked for the park it waited for")
    for name, (eng, _, ptrs, captured) in E.items():
        oc_held(eng, ptrs, captured, f"fabric {name}")
    # streams: the route wave, the migrated ones and the prefixed one under
    # the margin rule, the failed-over one teacher-forced
    compared, ties = check_streams([s.toks for s in wave] + [m.toks, z.toks],
                                   wave_refs + [wave_refs[0], wave_refs[1]], "fabric")
    n2, t2 = check_streams([pre.toks], [pre_ref], "fabric prefix")
    compared, ties = compared + n2, ties + t2
    held_forced = check_forced(forced, [(prompts[2], k.toks, at_kill)], "fabric failover")
    # r0's launches as its stats() report them over the wire: the process's
    # counts over the wave, which l (idle) and the child (another process)
    # add nothing to
    d = {key: wave_stats[key] - before["h"][key]
         for key in ("decode_ticks", "flash_launches", "paged_attn_launches")}
    d["admission_dispatches"] = (sum(wave_stats["prefill_batch_hist"])
                                 - sum(before["h"]["prefill_batch_hist"]))
    n_layers = FLAGSHIP["n_layers"]
    if (d["flash_launches"] != n_layers * d["admission_dispatches"]
            or d["paged_attn_launches"] != n_layers * d["decode_ticks"]
            or not d["admission_dispatches"]):
        raise AssertionError(f"fabric: r0's stats() report launches {d} over the wave")
    if not (child["flash_launches"] > 0 and child["paged_attn_launches"] > 0):
        raise AssertionError(f"fabric: the child reports flash {child['flash_launches']}, "
                             f"paged {child['paged_attn_launches']} launches")
    paths = [rep["path"] for rep in lo_moves + tcp_moves]
    if paths != ["resident"] * 4 or not inst.get("installed", True):
        raise AssertionError(f"fabric: migration paths {paths}, prefix install {inst}")
    copies = {name: {key: after[name][key] - before[name][key]
                     for key in ("migration_copies", "prefix_install_copies",
                                 "prefix_tier_installs", "migrations_in", "migrations_out")}
              for name in after}
    if any(c["migration_copies"] or c["prefix_install_copies"] for c in copies.values()):
        raise AssertionError(f"fabric: staged copies beyond the contract: {copies}")
    if copies["h"]["prefix_tier_installs"] != 1:
        raise AssertionError(f"fabric: the prefix did not install on r0's host: {copies}")
    hops = [(hp["kind"], hp["host"]) for hp in journeys[k.req.jid]["hops"]]
    if (rc != -signal.SIGKILL or fs["fabric_links_down"] != 1 or fs["fabric_checksum_faults"]
            or fs["failovers"] != 1 or fs["engine_states"]["r1"] != "DEAD"
            or hops != [("route", "h0"), ("failover", "local")]
            or not journeys[k.req.jid]["conserved"]):
        raise AssertionError(
            f"fabric failover: exit code {rc}, links down {fs['fabric_links_down']}, checksum "
            f"faults {fs['fabric_checksum_faults']}, failovers {fs['failovers']}, states "
            f"{fs['engine_states']}, hops {hops}")
    for name in ("h", "l"):
        st = after[name]
        if (st["kv_pool_free"] != st["kv_pool_blocks"] or st["parked_sessions"]
                or st["active_slots"] or st["queued"] or st["admitting_slots"]
                or st["swap_host_free"] != st["swap_host_blocks"]):
            raise AssertionError(f"fabric {name}: not empty at the end: pool "
                                 f"{st['kv_pool_free']} of {st['kv_pool_blocks']} free, "
                                 f"{st['parked_sessions']} parked, {st['active_slots']} live")
    for name in E:
        dt = after[name]["decode_ticks"] - before[name]["decode_ticks"]
        if played[name] != dt:
            raise AssertionError(f"fabric {name}: {played[name]} replays, {dt} decode ticks")
    pauses = [bo["ms"] for bo in journeys[k.req.jid]["blackouts"] if bo["ms"] is not None]

    def move_row(rep):
        return {"path": rep["path"], "ms": rep["ms"], "bytes": rep["bytes"],
                "gb_per_s": rep["bytes"] / (rep["ms"] * 1e6) if rep["bytes"] else None}

    seconds = time.perf_counter() - t_phase
    out = {"spawn_to_port_ms": spawn_ms, "spawn_to_beat_ms": beat_ms, "rtt_ms": rtt,
           "loopback_moves": [move_row(r) for r in lo_moves],
           "tcp_moves": [move_row(r) for r in tcp_moves],
           "prefix": {"bytes": pre_bytes, "export_ms": export_ms, "install_ms": install_ms},
           "r0_wave": d, "child_launches": {k_: child[k_] for k_ in (
               "flash_launches", "paged_attn_launches", "decode_ticks", "admissions")},
           "launches": launches, "throttled_tokens_per_s": rate, "tokens_at_kill": at_kill,
           "detect_ms": detect_ms, "pause_ms": pauses, "copies": copies, "replays": played,
           "fabric": {k_: fs[k_] for k_ in fs if k_.startswith(("fabric", "remote"))},
           "compared_tokens": compared, "margin_cuts": ties, "forced": held_forced,
           "exit_code": rc, "seconds": seconds, "laps_s": laps.s}
    log(f"fabric child on {card}: spawn to port line {spawn_ms:.1f} ms, to first beat "
        f"{beat_ms:.1f} ms (interpreter, CUDA context, seeded weights, graph capture); RTT "
        f"EMA loopback {rtt['loopback']:.3f} ms, TCP {rtt['tcp']:.3f} ms")
    for what, rows in (("loopback r0", out["loopback_moves"]), ("TCP r1", out["tcp_moves"])):
        for r, way in zip(rows, ("there", "back")):
            log(f"fabric migration over {what} ({way}) on {card}: path {r['path']}, "
                f"{r['bytes']} bytes, {r['ms']:.2f} ms ({r['gb_per_s']:.3f} GB/s over the call)")
    log(f"fabric prefix on {card}: {pre_bytes} bytes exported from l in {export_ms:.2f} ms, "
        f"installed on r0 over the loopback wire in {install_ms:.2f} ms "
        f"({pre_bytes / (install_ms * 1e6):.3f} GB/s)")
    log(f"fabric launches: r0's stats() over the wave {d}; the child's stats() "
        f"{out['child_launches']}")
    log(f"fabric failover on {card}: child exit {rc}, {at_kill} tokens delivered at the kill "
        f"(throttled at {FB_THROTTLE_S * 1e3:.0f} ms a fetch: "
        f"{rate if rate is None else round(rate, 1)} tokens/s, not a speed figure), detection "
        f"{detect_ms if detect_ms is None else round(detect_ms, 1)} ms (r1's last beat to "
        f"DEAD), pause {[round(x, 2) for x in pauses]} ms, hops {hops}")
    log(f"fabric streams: {compared} tokens equal to the plain trunk, {ties} cut at a margin "
        f"< {MARGIN}; the failed-over stream teacher-forced: {held_forced['held']} held, "
        f"{held_forced['skipped']} skipped; fabric counters {out['fabric']}; copies {copies}; "
        f"replays {played}")
    log(f"fabric phase on {card}: {seconds:.1f} s; sub-steps, wall s: {laps.line()}")
    return out


# ------------------------------------------------------- q. kv_int8="auto"

# the router's measured grid (hack/torch_int8_ab.py, INT8_AB_H100.json)
AUTO_SLOTS = (4, 8, 16, 32, 64)
AUTO_WINDOWS = (1024, 2048)
AUTO_TOKENS = 16


def auto_shapes() -> list[tuple]:
    """(slots, max_seq, verdict) of one engine a verdict choose_kv_int8
    gives within its measured grid: the first cell of each verdict (fewest
    slots, then the shorter window), or the flagship's shape alone where
    the grid gives one verdict."""
    from vtpu_torch.serving.engine import choose_kv_int8

    first: dict = {}
    for slots in AUTO_SLOTS:
        for window in AUTO_WINDOWS:
            first.setdefault(choose_kv_int8(slots, window, paged=True), (slots, window))
    if len(first) < 2:
        return [(4, FLAGSHIP["max_seq"], choose_kv_int8(4, FLAGSHIP["max_seq"], paged=True))]
    return [(*first[v], v) for v in (True, False)]


def auto_path(log, card: str, params) -> dict:
    """Phase q: ModelConfig(kv_int8="auto") at the flagship's depth and
    widths on a paged pool (kv_page=128) and the default loop (pipelined,
    on graphs), one engine a verdict of the router (auto_shapes). Each
    engine's resolved flag is choose_kv_int8(slots, max_seq) and its pool's
    dtype follows (int8 with f32 scale planes, or bf16); the wave's decode
    ticks went through the matching paged kernel, 12 launches a tick, one
    replay a tick, and the other paged kernel not at all (launch counts set
    to 0 just before the wave, read just after); every stream OK and held
    against the plain trunk of the resolved KV type teacher-forced on it
    (check_forced)."""
    from vtpu_torch.models import ModelConfig
    from vtpu_torch.ops import _build
    from vtpu_torch.serving import ServingConfig, ServingEngine
    from vtpu_torch.serving.engine import choose_kv_int8

    grid = "; ".join(f"{pool} {s}x{w} {'int8' if choose_kv_int8(s, w, paged=paged) else 'bf16'}"
                     for pool, paged in (("dense", False), ("paged", True))
                     for w in AUTO_WINDOWS for s in AUTO_SLOTS)
    log(f"kv_int8 router (choose_kv_int8, measured by hack/torch_int8_ab.py), pool slots x "
        f"window: {grid}")
    prompts = wave_prompts(FLAGSHIP["vocab"])
    out = {"router": grid, "engines": []}
    for slots, window, verdict in auto_shapes():
        cfg = ModelConfig(**dict(FLAGSHIP, max_seq=window), dtype=torch.bfloat16,
                          use_kernels=True, kv_int8="auto")
        eng = ServingEngine(params, cfg, ServingConfig(
            slots=slots, prefill_buckets=(1024,), max_new_tokens=AUTO_TOKENS, kv_page=128))
        what = f"kv_int8='auto' at {slots} slots, max_seq {window}"
        kv = eng.state["k"].dtype
        if (eng.cfg.kv_int8 is not verdict or kv != (torch.int8 if verdict else torch.bfloat16)
                or ("k_scale" in eng.state) != verdict):
            eng.stop()
            raise AssertionError(f"{what}: resolved kv_int8={eng.cfg.kv_int8!r}, pool {kv} "
                                 f"(scales {'k_scale' in eng.state}); the router says {verdict}")
        paged, other = "paged_decode_attention", "paged_decode_attention_int8kv"
        if verdict:
            paged, other = other, paged
        graphs = eng.decode_graphs
        eng.start()
        try:
            stream_all(eng, [prompts[0]])  # warm-up, not counted
            base, replays = eng.stats(), graphs.replays
            _build.reset_launches()
            recs, wall = stream_all(eng, prompts)
            launches = _build.launches()
            after, replays = eng.stats(), graphs.replays - replays
        finally:
            eng.stop()
        if eng.loop_error is not None:
            raise AssertionError(f"{what}: serving loop failed: {eng.loop_error!r}")
        ticks = after["decode_ticks"] - base["decode_ticks"]
        for rec in recs:
            if rec.get("status") != "OK" or len(rec["toks"]) != AUTO_TOKENS:
                raise AssertionError(f"{what}: a stream ended {rec.get('status')} after "
                                     f"{len(rec['toks'])} of {AUTO_TOKENS} tokens")
        if (launches[paged] != cfg.n_layers * ticks or launches[other] or replays != ticks
                or launches["flash_attention"] <= 0):
            raise AssertionError(f"{what}: launches {launches} over {ticks} decode ticks and "
                                 f"{replays} replays (expected {cfg.n_layers} {paged} a tick, "
                                 f"no {other}, one replay a tick)")
        forced = forced_trunk(params, dataclasses.replace(eng.cfg, use_kernels=False))
        held = check_forced(forced, [(p, rec["toks"], AUTO_TOKENS)
                                     for p, rec in zip(prompts, recs)], what)
        total = sum(len(rec["toks"]) for rec in recs)
        ttft = sorted((rec["first"] - rec["submit"]) * 1e3 for rec in recs)
        log(f"{what} on {card}: resolved kv_int8={eng.cfg.kv_int8}, pool {kv}; {len(prompts)} "
            f"requests, {total} tokens in {wall:.3f} s ({total / wall:.1f} tokens/s), TTFT "
            f"p50 {ttft[len(ttft) // 2]:.1f} ms; decode ticks {ticks}, graph replays "
            f"{replays}; {paged} {launches[paged]}, {other} {launches[other]}, flash "
            f"{launches['flash_attention']}; {held['held']} tokens held against the plain "
            f"{'int8' if verdict else 'bf16'} trunk teacher-forced, {held['skipped']} "
            f"near-ties skipped (widest skipped flip {held['widest_flip']:.4f})")
        out["engines"].append({"slots": slots, "max_seq": window, "kv_int8": verdict,
                               "pool_dtype": str(kv), "decode_ticks": ticks,
                               "graph_replays": replays, "launches": launches,
                               "tokens_per_s": total / wall, "ttft_ms": ttft,
                               "held": held["held"], "skipped": held["skipped"]})
    return out


# phase h's arms beyond the main path's waves (tp=2 only): 16-token waves
# in the same world (TP_OPS_TAG on every tokens/s of a gloo world). Each
# arm holds TP_HELD tokens at least against its plain trunk: it serves
# TP_FIRST_WAVES of its prompt sets in the first world and, if short, the
# rest up to FAMILY_MAX_WAVES in a second
TP_TOKENS = 16
TP_PARK_AFTER = 8
TP_WATCHDOG = dict(fetch_watchdog_ms=500.0, fetch_watchdog_recover_ms=1.0)
TP_STALLS = ("delayed_fetch", 2, 2, 0.75)
TP_OPS_TAG = "gloo, two ranks on one card: a sharding check, not a TP speed figure"
TP_HELD = FAMILY_HELD
TP_FIRST_WAVES = {"dense": 1, "chunked": 1, "moe": 3}
# phase h's depth: the flagship's and phase k's MoE widths at 4 of their 12
# layers. A sharding check needs every layer's collectives, not 12 of them;
# the main path, phase c and every kernel check keep the full depth
TP_LAYERS = 4
TP_FLAGSHIP = dict(FLAGSHIP, n_layers=TP_LAYERS)
TP_MOE = dict(MOE_FLAGSHIP, n_layers=TP_LAYERS)


def tp_swap_watch(model):
    """A rank hook of phase h (``Run.hook`` "chip_smoke:tp_swap_watch"):
    every block this rank swaps in, held byte for byte against a copy of
    what left its pool at the swap-out to the same host block, taken on the
    rank's stream before the gather (``swap_checked``, ``swap_differ``).
    Rank 0 wraps its adapter's swap calls, a follower its run of the swap
    ops; the null block 0 of the construction's staging pair is skipped."""
    from vtpu_torch.models.transformer import kv_keys
    from vtpu_torch.serving.adapters import _OP_SWAP_IN, _OP_SWAP_OUT

    counts = {"swap_checked": 0, "swap_differ": 0}
    saved = {}

    def out(state, blocks, host):
        for b, h in zip(blocks, host):
            if b:
                saved[h] = {k: state[k][:, b].clone() for k in kv_keys(state)}

    def back(state, blocks, host):
        for b, h in zip(blocks, host):
            if b:
                same = all(torch.equal(state[k][:, b], x) for k, x in saved.pop(h).items())
                counts["swap_checked"] += 1
                counts["swap_differ"] += 0 if same else 1

    if model.mesh.rank == 0:
        swap_out, swap_in = model.swap_out, model.swap_in

        def watched_out(state, blocks, host, stage):
            out(state, blocks, host)
            return swap_out(state, blocks, host, stage)

        def watched_in(state, blocks, host, stage):
            state = swap_in(state, blocks, host, stage)
            back(state, blocks, host)
            return state

        model.swap_out, model.swap_in = watched_out, watched_in
    else:
        run = model._run

        def watched_run(op, dims, args, state):
            if op == _OP_SWAP_OUT:
                out(state, args[0].tolist(), args[1].tolist())
            state = run(op, dims, args, state)
            if op == _OP_SWAP_IN:
                back(state, args[0].tolist(), args[1].tolist())
            return state

        model._run = watched_run
    return lambda state: dict(counts)


def tp_ops_arms(serving) -> list[tuple]:
    """Phase h's arms of the broadcast protocol's ops, as (name, what the
    streams are held against, wave): ``wave(j)`` is the arm's Run on its
    prompt set j, 0 its one-device phase's prompts and j > 0 the same
    lengths redrawn from SEED + 300 + j. h1 phase e's chunks and prefix,
    h2-h4 the loops, h5 the MoE, h6 overcommit, h7 the watchdog, h8
    disaggregation (h9, migration, is tp_move_rounds' and runs in the same
    world). ``serving`` is the main path waves'."""
    from vtpu_torch.models import ModelConfig, MoEConfig
    from vtpu_torch.parallel.launch import Run, Script
    from vtpu_torch.serving import DisaggConfig, FaultPlan, FaultSpec

    cfg = ModelConfig(**TP_FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    c8 = dataclasses.replace(cfg, kv_int8=True)
    moe = MoEConfig(**TP_MOE, dtype=torch.bfloat16)
    vocab = FLAGSHIP["vocab"]
    prefix, sufs, longs = chunked_prefix_prompts(vocab)
    bg, burst = dg_prompts(vocab)
    rep = dataclasses.replace

    def redraw(prompts, j):
        if not j:
            return list(prompts)
        rs = np.random.RandomState(SEED + 300 + j)
        return [rs.randint(0, vocab, (len(p),)).astype(np.int32) for p in prompts]

    def fresh(arm_serving):
        # a wave's own fault plan: a plan counts its arrivals
        if arm_serving.faults is None:
            return arm_serving
        return rep(arm_serving, faults=FaultPlan(arm_serving.faults.specs))

    def arm(name, held_by, arm_cfg, arm_serving, prompts, **script):
        hook = script.pop("hook", None)
        return (name, held_by, lambda j: Run(arm_cfg, fresh(arm_serving), redraw(prompts, j),
                                             TP_TOKENS, script=Script(**script), hook=hook))

    def prefixed(j):
        pre, *rest = redraw([prefix] + sufs + longs, j)
        return Run(cfg, rep(serving, prefill_chunk=CHUNK), rest, TP_TOKENS,
                   script=Script(prefix=tuple(int(x) for x in pre), prefixed=len(sufs)))

    wave = wave_prompts(vocab)
    spec = dict(spec_tokens=SPEC_K, spec_min_mean=0.0)
    return [
        ("h1 chunks + prefix", "chunked", prefixed),
        arm("h2 decode_loop_k=8", "dense", cfg, rep(serving, decode_loop_k=LOOP_K), wave),
        arm("h3 spec_tokens=4", "dense", cfg, rep(serving, **spec), wave),
        arm("h3 spec_tokens=4 int8", "dense", c8, rep(serving, **spec), wave),
        arm("h4 fused (8, 4)", "dense", cfg, rep(serving, decode_loop_k=LOOP_K, **spec), wave),
        arm("h5 MoE pipelined", "moe", moe, rep(serving, prefill_batch_sizes=(1,)), wave),
        arm("h5 MoE spec_tokens=4", "moe", moe, rep(serving, prefill_batch_sizes=(1,), **spec),
            wave),
        arm("h6 overcommit", "dense", cfg, rep(serving, **OC_SERVING, kv_swap=OC_HOST),
            overcommit_prompts(vocab), park_after=TP_PARK_AFTER,
            hook="chip_smoke:tp_swap_watch"),
        arm("h7 watchdog", "dense", cfg,
            rep(serving, decode_loop_k=LOOP_K, **TP_WATCHDOG,
                faults=FaultPlan([FaultSpec(*TP_STALLS)])), wave),
        arm("h8 disagg", "dense", cfg, rep(serving, **DG_SERVING, disagg=DisaggConfig()),
            bg + burst),
    ]


# phase h9: migration under the mesh, two rounds in phase h's tp=2 world.
# Sessions of MG_BUDGET tokens, moved at their MG_PARK_AT-th token; the
# spilling source has phase n's small pool and host tier, the destination
# of round A a pool and a host tier that hold every session moved onto it
H9_DST = dict(slots=8, kv_pool_blocks=64, kv_swap=OC_HOST)
# the round runner h9 shares with the CPU tests (tests/torch_move_kit.py,
# no jax), imported by the world's rank 0 from tests/ on its sys.path
MOVE_RUNNER = "torch_move_kit:port_round"


def tp_tier_watch(model):
    """A rank hook of phase h9 (``Run.hook`` "chip_smoke:tp_tier_watch"):
    this rank's host tier across a migration round. A block a swap-out or
    a tier upload fills is held until a swap-in or a snapshot reads it
    back; ``tier_held`` is the blocks still held at the end ([] when the
    tier is free). Rank 0 wraps its adapter's calls, a follower its run of
    the ops. (The CPU tests' hook also compares the tier byte for byte
    around each op: tests/torch_tp_hooks.py.)"""
    from vtpu_torch.serving.adapters import _OP_SNAPSHOT, _OP_SWAP_IN, _OP_SWAP_OUT, _OP_UPLOAD

    held: set = set()

    def seen(op, ids):
        if op in (_OP_SWAP_OUT, _OP_UPLOAD):
            held.update(ids)
        else:
            held.difference_update(ids)

    if model.mesh.rank == 0:
        swap_out, swap_in = model.swap_out, model.swap_in
        snapshot, upload = model.snapshot, model.upload

        def watched_out(state, blocks, host, stage):
            seen(_OP_SWAP_OUT, host)
            return swap_out(state, blocks, host, stage)

        def watched_in(state, blocks, host, stage):
            seen(_OP_SWAP_IN, host)
            return swap_in(state, blocks, host, stage)

        def watched_snapshot(state, blocks, host, stage):
            seen(_OP_SNAPSHOT, host)
            return snapshot(state, blocks, host, stage)

        def watched_upload(state, payload, ids, stage, tier=False):
            if tier:
                seen(_OP_UPLOAD, ids)
            return upload(state, payload, ids, stage, tier)

        model.swap_out, model.swap_in = watched_out, watched_in
        model.snapshot, model.upload = watched_snapshot, watched_upload
    else:
        run = model._run

        def watched_run(op, dims, args, state):
            if op in (_OP_SWAP_OUT, _OP_SWAP_IN, _OP_SNAPSHOT):
                seen(op, args[1].tolist())
            elif op == _OP_UPLOAD and dims[2]:
                seen(op, args[0].tolist())
            return run(op, dims, args, state)

        model._run = watched_run
    return lambda state: {"tier_held": sorted(held)}


def tp_move_rounds() -> list[tuple]:
    """Phase h9's rounds, as (name, Run, the direct moves' paths): the
    flagship on the main path's serving config with kv_swap (phase n's
    mg_serving), MG_BUDGET tokens a session. Round A, bf16: tp engines
    src, small (phase n's small pool and host tier) and dst (H9_DST; its
    second pool reservation reads dry, alloc_exhaust), and the one-device
    engine one on rank 0's card. A live move src -> dst (held inside its
    16th token until the move asks its park), a parked session moved onto
    dst's dry pool (into every rank's host tier, resumed by swap-in), src
    -> one -> dst (parked at 16 and 32), a session parked on small and
    evicted to every rank's tier by the next admission, moved to dst, then
    src drained into dst (a parked, a live and a waiting session). Round
    B, int8 KV: tp engines a and b under an EngineFleet pinned to a, a
    live move a -> b, then fleet.drain("a") (a parked, a live and a
    waiting session)."""
    import os

    from vtpu_torch.models import ModelConfig
    from vtpu_torch.parallel.launch import Moves, Run, Script
    from vtpu_torch.serving import FaultPlan, FaultSpec

    # a spawned rank starts on this process's sys.path
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    cfg = ModelConfig(**TP_FLAGSHIP, dtype=torch.bfloat16, use_kernels=True)
    p = wave_prompts(FLAGSHIP["vocab"])
    at = MG_PARK_AT
    hook = "chip_smoke:tp_tier_watch"
    dry = FaultPlan([FaultSpec("alloc_exhaust", at=1)])
    a = Moves(
        runner=MOVE_RUNNER,
        engines=(("src", {}), ("small", dict(kv_pool_blocks=MG_SMALL_POOL, kv_swap=MG_HOST)),
                 ("dst", dict(H9_DST, faults=dry)), ("one", {})),
        one_device=("one",),
        steps=(("submit", 0, "src"), ("park_at", 0, at), ("submit", 1, "src"),
               ("hold_at", 1, at), ("submit", 4, "src"), ("park_at", 4, at),
               ("park_at", 4, 2 * at), ("submit", 2, "small"), ("park_at", 2, at), ("start",),
               # dst's first reservation: the live move, resident
               ("held", 1), ("move", 1, "dst"),
               # its second reads dry: every rank's host tier
               ("parked", 0), ("move", 0, "dst"),
               ("parked", 4), ("move", 4, "one"), ("parked", 4), ("move", 4, "dst"),
               ("parked", 2), ("submit", 3, "small"), ("evicted", 2), ("move", 2, "dst"),
               ("submit", 5, "src"), ("park_at", 5, at), ("parked", 5), ("submit", 6, "src"),
               ("hold_at", 6, 1), ("held", 6), ("submit", 7, "src"), ("drain", "src", "dst")))
    b = Moves(
        runner=MOVE_RUNNER, engines=(("a", {}), ("b", {})), fleet=("a", "b"),
        steps=(("start",), ("gate", "a"), ("submit", 0, "fleet"), ("hold_at", 0, at),
               ("submit", 1, "fleet"), ("park_at", 1, at // 2), ("ungate", "a"),
               ("parked", 1), ("held", 0), ("move", 0, "b"),
               ("submit", 2, "fleet"), ("hold_at", 2, 1), ("held", 2), ("submit", 3, "fleet"),
               ("drain", "a", None)))
    return [
        ("h9 moves bf16", Run(cfg, mg_serving(), p + [p[1], p[0]], MG_BUDGET,
                              script=Script(moves=a), hook=hook),
         [(1, "src", "dst", "resident"), (0, "src", "dst", "host"),
          (4, "src", "one", "resident"), (4, "one", "dst", "resident"),
          (2, "small", "dst", "resident")]),
        ("h9 fleet int8", Run(dataclasses.replace(cfg, kv_int8=True), mg_serving(),
                              [p[1], p[5], p[4], p[0]], MG_BUDGET, script=Script(moves=b),
                              hook=hook),
         [(0, "a", "b", "resident")]),
    ]


def check_tp_moves(name: str, run, paths: list, ranks: list, forced: dict, tp: int) -> dict:
    """Hold one round of phase h9: every stream OK and MG_BUDGET tokens
    long, each against the plain trunk of its KV type teacher-forced on it
    (check_forced, a near-tie skipped); the direct moves' paths; every
    moved payload pages x the whole-head block bytes (a session holds its
    prompt and budget's pages), out and in bytes equal over the engines;
    migration_copies 0; the drain's three sessions moved or completed,
    none faulted (and under the fleet, one engine draining, no failover);
    every engine's pool and host tier free on rank 0 and every rank's tier
    free (tp_tier_watch); and on each rank
    12 x the tp engines' kernel-route ticks head-local paged launches, 12
    x the one-device engine's ticks single-device paged launches (rank 0
    only), 12 x its engines' admission dispatches flash launches. Returns
    what it held and each move's figures."""
    lead = ranks[0]
    moves = run.script.moves
    int8 = bool(run.cfg.kv_int8)
    for toks, status in zip(lead["streams"], lead["statuses"]):
        if status != "OK" or len(toks) != MG_BUDGET:
            raise AssertionError(f"tp={tp} {name}: a stream ended {status} after {len(toks)} "
                                 f"of {MG_BUDGET} tokens")
    got = [m[:4] for m in lead["moves"]]
    if got != paths:
        raise AssertionError(f"tp={tp} {name}: moves {got}, expected {paths}")
    bpb = block_bytes_of(run.cfg, run.serving.kv_page)
    rows = []
    for i, src, dst, path, nbytes, ms in lead["moves"]:
        pages = -(-(len(run.prompts[i]) + MG_BUDGET) // run.serving.kv_page)
        if nbytes != pages * bpb:
            raise AssertionError(f"tp={tp} {name}: session {i} {src} -> {dst} moved {nbytes} "
                                 f"bytes, expected {pages} pages x {bpb} (whole heads)")
        rows.append({"session": i, "from": src, "to": dst, "path": path, "bytes": nbytes,
                     "ms": ms, "gb_per_s": nbytes / ms / 1e6})
    st = lead["stats"]
    out_b = sum(s["migrate_out_bytes"] for s in st.values())
    in_b = sum(s["migrate_in_bytes"] for s in st.values())
    if out_b != in_b or out_b <= 0 or any(s["migration_copies"] or s["migrate_failures"]
                                          for s in st.values()):
        raise AssertionError(f"tp={tp} {name}: out {out_b} and in {in_b} bytes, copies and "
                             f"failures {[(s['migration_copies'], s['migrate_failures']) for s in st.values()]}")
    ((migrated, completed, faulted, drain_ms),) = lead["drains"]
    if (migrated + completed, faulted) != (3, 0):
        raise AssertionError(f"tp={tp} {name}: drain moved {migrated}, completed {completed}, "
                             f"faulted {faulted} of three")
    if moves.fleet and (lead["fleet"]["draining_engines"], lead["fleet"]["failovers"]) != (1, 0):
        raise AssertionError(f"tp={tp} {name}: fleet {lead['fleet']}")
    for eng, s in st.items():
        if (s["kv_pool_free"] != s["kv_pool_blocks"] or s["parked_sessions"] or s["queued"]
                or (s["swap_host_blocks"] and s["swap_host_free"] != s["swap_host_blocks"])):
            raise AssertionError(f"tp={tp} {name} {eng}: not empty at the end: {s}")
    tp_names = [n for n, _ in moves.engines if n not in moves.one_device]
    for rank, res in enumerate(ranks):
        for eng in tp_names:
            if res["hooks"][eng]["tier_held"]:
                raise AssertionError(f"tp={tp} {name} rank {rank} {eng}: host tier blocks "
                                     f"{res['hooks'][eng]['tier_held']} still held")
        mine = [n for n in st if rank == 0 or n in tp_names]
        ticks = sum(st[n]["paged_attn_kernel_ticks"] for n in tp_names)
        one = sum(st[n]["paged_attn_kernel_ticks"] for n in mine if n in moves.one_device)
        dispatches = sum(sum(st[n]["prefill_batch_hist"]) for n in mine)
        L = run.cfg.n_layers
        kern = "paged_decode_attention_int8kv" if int8 else "paged_decode_attention"
        want = {f"{kern}_tp": L * ticks, kern: L * one, "flash_attention": L * dispatches}
        have = {k: res["launches"][k] for k in want}
        others = {k: v for k, v in res["launches"].items() if v and k not in want}
        if have != want or others:
            raise AssertionError(f"tp={tp} {name} rank {rank}: launches {have} (and {others}), "
                                 f"expected {want}")
    held = check_forced(forced["int8" if int8 else "bf16"],
                        [(np.asarray(pr, np.int32), t, MG_PARK_AT)
                         for pr, t in zip(run.prompts, lead["streams"])], f"tp={tp} {name}")
    return {"moves": rows, "drain_ms": drain_ms, "wall_s": lead["wall_s"],
            "held": held["held"], "skipped": held["skipped"],
            "launches": [r["launches"] for r in ranks],
            "counters": {n: {k: s[k] for k in ("migrations_out", "migrations_in",
                                                "migrate_out_bytes", "migrate_in_bytes",
                                                "swap_out_bytes", "swap_in_bytes", "tp")}
                         for n, s in st.items()}}


def check_tp_arm(name: str, run, held_by: str, ranks: list, forced: dict, tp: int) -> dict:
    """Hold one wave of phase h's arms (``run``, its Run) as its one-device
    phase holds it: every stream OK and against the plain trunk of its KV
    type or family, teacher-forced on it (check_forced; the MoE through
    check_routed behind its one-row admission, each stream only up to its
    first skipped step whose token differs); on every rank head-local paged
    launches = 12 x the decode ticks on the kernel route under the _tp name
    and 12 x the verify ticks under the _tp_verify name (the wrapper counts
    a call with T > 1 there), no single-device paged launch, flash launches
    = 12 x admission dispatches (a bucketed rebuild may add 12 under
    overcommit), and the wave's own counters. Returns what it held."""
    cfg, serving, script = run.cfg, run.serving, run.script
    lead = ranks[0]
    st = lead["stats"]
    n_layers = cfg.n_layers
    for toks, status in zip(lead["streams"], lead["statuses"]):
        if status != "OK" or len(toks) != TP_TOKENS:
            raise AssertionError(f"tp={tp} {name}: a stream ended {status} after {len(toks)} "
                                 f"of {TP_TOKENS} tokens")
    if st["tp"] != tp:
        raise AssertionError(f"tp={tp} {name}: stats report tp {st['tp']}")
    int8 = bool(getattr(cfg, "kv_int8", False))
    tp_name = "paged_decode_attention_int8kv_tp" if int8 else "paged_decode_attention_tp"
    other = "paged_decode_attention_tp" if int8 else "paged_decode_attention_int8kv_tp"
    ticks, verify = st["paged_attn_kernel_ticks"], st["spec_ticks"]
    if verify and st["paged_attn_gather_ticks"]:
        raise AssertionError(f"tp={tp} {name}: a speculating arm served "
                             f"{st['paged_attn_gather_ticks']} ticks on the gather route")
    dispatches = sum(st["prefill_batch_hist"])
    for rank, res in enumerate(ranks):
        got = res["launches"]
        extra = got["flash_attention"] - n_layers * dispatches
        rebuilt = extra % n_layers == 0 and 0 <= extra <= n_layers * st["fault_recomputes"]
        if (got[tp_name] != n_layers * (ticks - verify)
                or got[f"{tp_name}_verify"] != n_layers * verify
                or got[other] or got[f"{other}_verify"] or got["paged_decode_attention"]
                or got["paged_decode_attention_int8kv"] or not (extra == 0 or rebuilt)):
            raise AssertionError(
                f"tp={tp} {name} rank {rank}: launches {got} over {ticks} kernel-route inner "
                f"ticks ({verify} verify) and {dispatches} admission dispatches (expected "
                f"{n_layers} {tp_name} a decode tick, {n_layers} {tp_name}_verify a verify "
                f"tick, none single-device, {n_layers} flash a dispatch)")
    prefix = script.prefix
    prompts = [np.asarray(p, np.int32) for p in run.prompts]
    if held_by == "moe":
        # one row an admission dispatch (prefill_batch_sizes=(1,))
        held = check_routed(forced["moe"], [(p, t, ("batch", (p,), 0))
                                            for p, t in zip(prompts, lead["streams"])],
                            f"tp={tp} {name}", until_flip=True)
        skipped = held["skipped_logit"] + held["skipped_route"]
    else:
        after = script.park_after or TP_TOKENS
        if prefix is not None:
            pre = np.asarray(prefix, np.int32)
            prompts = [np.concatenate([pre, p]) if i < script.prefixed else p
                       for i, p in enumerate(prompts)]
        held = check_forced(forced["int8" if int8 else "bf16"],
                            [(p, t, after) for p, t in zip(prompts, lead["streams"])],
                            f"tp={tp} {name}")
        skipped = held["skipped"]
    # the wave's own counters: exact values, and those that must be > 0
    want: dict = {}
    positive = []
    pool_held = 0
    if prefix is not None:
        pool_held = len(prefix) // serving.kv_page
        want = {"prefix_install_copies": 0,
                "prefix_blocks_shared": script.prefixed * pool_held,
                "prefill_chunks": sum(-(-len(p) // serving.prefill_chunk)
                                      for p in run.prompts)}
    if serving.decode_loop_k:
        positive.append("loop_flushes")
    if serving.spec_tokens:
        positive.append("spec_ticks")
        if serving.decode_loop_k:
            positive.append("fused_flushes")
    if serving.kv_swap is not None:
        want.update(parks=len(run.prompts), resumes=len(run.prompts),
                    swap_host_free=st["swap_host_blocks"])
        positive += ["evicted_blocks", "swap_out_bytes"]
        # the swap byte counters count whole heads, blocks every rank swaps
        bpb = block_bytes_of(cfg, serving.kv_page)
        swapped = st["swap_in_bytes"] // bpb
        for rank, res in enumerate(ranks):
            if res["swap_checked"] != swapped or res["swap_differ"]:
                raise AssertionError(f"tp={tp} {name} rank {rank}: {res['swap_checked']} "
                                     f"swapped-in blocks checked of {swapped}, "
                                     f"{res['swap_differ']} differ from what left the pool")
    if serving.fetch_watchdog_ms:
        want.update(watchdog_degrades=2, watchdog_recoveries=2)
        positive.append("paged_attn_gather_ticks")
    if serving.disagg is not None:
        want.update(handoffs=len(run.prompts), handoff_copies=0)
    got = {k: st[k] for k in list(want) + positive}
    if {k: got[k] for k in want} != want or not all(got[k] > 0 for k in positive):
        raise AssertionError(f"tp={tp} {name}: counters {got}, expected {want} and "
                             f"{positive} > 0")
    if st["paged"] and st["kv_pool_free"] != st["kv_pool_blocks"] - pool_held:
        raise AssertionError(f"tp={tp} {name}: {st['kv_pool_free']} of {st['kv_pool_blocks']} "
                             f"pool blocks free at the end ({pool_held} held by the prefix)")
    total = sum(len(t) for t in lead["streams"])
    return {"tokens": total, "wall_s": lead["wall_s"], "tokens_per_s": total / lead["wall_s"],
            "kernel_ticks": ticks, "decode_ticks": st["decode_ticks"], "spec_ticks": verify,
            "gather_ticks": st["paged_attn_gather_ticks"], "dispatches": dispatches,
            "counters": got, "held": held["held"], "skipped": skipped,
            "launches": [r["launches"] for r in ranks],
            "verify_launches": lead["launches"][f"{tp_name}_verify"],
            "swap_checked": [r.get("swap_checked") for r in ranks]}


def block_bytes_of(cfg, page: int) -> int:
    """Bytes one pool block holds across every rank: every layer's page of
    all n_heads heads, K and V (and their f32 scales under int8), the unit
    of the swap and migration byte counters."""
    per = cfg.n_layers * page * cfg.n_heads
    int8 = bool(getattr(cfg, "kv_int8", False))
    return 2 * per * (cfg.head_dim * (1 if int8 else 2) + (4 if int8 else 0))


def tp_serving_paths(log, card: str, tp: int = TP) -> dict:
    """Tensor-parallel serving at TP_LAYERS deep: ``tp`` ranks, spawned,
    serve the main path's wave, once with bf16 and once with int8 KV, and
    at tp=2 in the same world phase h's arms (tp_ops_arms), each wave after
    a warm-up request served by an engine of its own. Every launch count is
    set to 0 on every rank just before each counted wave and read just
    after; the counts of every rank come back to this process. The main
    path's streams are held against the single-card plain trunk of the
    same depth and KV type, the arms' by check_tp_arm (teacher-forced
    trunks of the same seeded weights the ranks draw), each arm over
    TP_HELD tokens at least (a second world serves the prompt sets of the
    arms still short). The kernels were built by this process before: the
    ranks only load them."""
    import tempfile

    from vtpu_torch.models import ModelConfig, MoEConfig, init_moe_params, init_params
    from vtpu_torch.parallel.launch import Run, launch_tp, serve_requests
    from vtpu_torch.serving import ServingConfig

    if torch.cuda.device_count() >= tp:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(tp)]
        how = f"{tp} ranks on {tp} cards over nccl"
        tag = f"nccl, {tp} ranks on {tp} cards, eager"
    else:
        backend, devices = "gloo", ["cuda:0"] * tp
        how = (f"{tp} ranks sharing one card over gloo (collectives staged through "
               "host memory: a check of the sharding, not a TP speed figure)")
        tag = TP_OPS_TAG
    log(f"tensor-parallel serving: {how}")
    new_tokens = 16
    serving = ServingConfig(slots=4, prefill_buckets=(1024,), max_new_tokens=new_tokens,
                            kv_page=128)
    cfgs = {kv: ModelConfig(**TP_FLAGSHIP, dtype=torch.bfloat16, use_kernels=True,
                            kv_int8=kv == "int8") for kv in ("bf16", "int8")}
    prompts = wave_prompts(FLAGSHIP["vocab"])
    # every rank draws these weights from SEED at this depth
    params = init_params(SEED, cfgs["bf16"])
    refs = {kv: [reference_stream(params, dataclasses.replace(c, use_kernels=False), p,
                                  new_tokens) for p in prompts] for kv, c in cfgs.items()}
    arms = tp_ops_arms(serving) if tp == TP else []
    # own_group is gloo only (several engines' NCCL groups driven at once
    # have no common collective order): h9 runs where the ranks share a card
    rounds = tp_move_rounds() if tp == TP and backend == "gloo" else []
    if tp == TP and not rounds:
        log(f"tp={tp} h9 (migration between tp engines) not run: its engines' process "
            "groups are gloo only, and this world runs nccl")

    def world(runs):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ranks = launch_tp(serve_requests, tp, backend, devices, f"file://{tmp}/store",
                              args=([SEED] * len(runs), runs, True), timeout=900)
        wall = time.perf_counter() - t0
        runs_s = [r["run_s"] for r in ranks[0]]
        moves_s = sum(t for t, run in zip(runs_s, runs) if run.script.moves is not None)
        log(f"tensor-parallel world: {wall:.1f} s wall, start-up and {len(runs)} runs "
            f"included; rank 0's runs {sum(runs_s):.1f} s (migration rounds {moves_s:.1f} s), "
            f"start-up and exit {wall - sum(runs_s):.1f} s")
        return ranks

    # (arm, prompt set) of each arm wave in the world
    pending = [(a, j) for a in arms for j in range(TP_FIRST_WAVES[a[1]])]
    ranks = world([Run(cfgs[kv], serving, prompts, new_tokens) for kv in cfgs]
                  + [wave(j) for (_, _, wave), j in pending] + [run for _, run, _ in rounds])
    moved = [r[len(ranks[0]) - len(rounds):] for r in ranks]
    ranks = [r[:len(ranks[0]) - len(rounds)] for r in ranks]
    heads = FLAGSHIP["n_heads"] // tp
    pool = [TP_LAYERS, 41, 128, heads, FLAGSHIP["head_dim"]]
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
            if (got[tp_name] != TP_LAYERS * ticks or got[other_tp] != 0
                    or got[f"{tp_name}_verify"] or got[f"{other_tp}_verify"]
                    or got["paged_decode_attention"] != 0
                    or got["paged_decode_attention_int8kv"] != 0
                    or got["flash_attention"] <= 0 or res["kv_shape"] != pool):
                raise AssertionError(
                    f"tp={tp} {kv} rank {rank}: launches {got} over {ticks} decode ticks "
                    f"(expected {TP_LAYERS} {tp_name} per tick, no single-device "
                    f"paged launch, flash > 0), KV plane {res['kv_shape']} (expected {pool})")
        compared, ties = check_streams(lead["streams"], refs[kv], f"tp={tp} {kv}")
        total = sum(len(t) for t in lead["streams"])
        log(f"tp={tp} {kv} serving on {card} ({how}): {len(prompts)} requests, {total} tokens in "
            f"{lead['wall_s']:.3f} s ({total / lead['wall_s']:.1f} tokens/s; {tag}); decode "
            f"ticks {ticks} ({st['pipelined_ticks']} pipelined, eager); per rank {tp_name} "
            f"{[r[i]['launches'][tp_name] for r in ranks]}, KV plane {pool}")
        log(f"tp={tp} {kv} streams vs plain {kv} trunk: {compared} tokens compared equal, "
            f"{ties} streams cut at a top-1/top-2 margin < {MARGIN}")
        out[kv] = {"backend": backend, "devices": devices, "ranks": [r[i] for r in ranks],
                   "decode_ticks": ticks, "pipelined_ticks": st["pipelined_ticks"],
                   "tick_phase_ms": st["tick_phase_ms"], "tokens": total,
                   "wall_s": lead["wall_s"],
                   "tokens_per_s": total / lead["wall_s"], "launches": lead["launches"],
                   "compared_tokens": compared, "margin_cuts": ties}
    if not arms:
        return out
    t0 = time.perf_counter()
    cfg = cfgs["bf16"]
    moe_cfg = MoEConfig(**TP_MOE, dtype=torch.bfloat16)
    moe_params = init_moe_params(SEED, moe_cfg, device="cuda")
    forced = {"bf16": forced_trunk(params, dataclasses.replace(cfg, use_kernels=False)),
              "int8": forced_trunk(params, dataclasses.replace(cfgs["int8"], use_kernels=False)),
              "moe": moe_forced_trunk(moe_params, moe_cfg,
                                      dataclasses.replace(moe_cfg, use_kernels=False), serving)}
    waves = {name: [] for name, _, _ in arms}
    results = [r[len(cfgs):] for r in ranks]
    while True:
        for k, ((name, held_by, wave), j) in enumerate(pending):
            res = check_tp_arm(name, wave(j), held_by, [r[k] for r in results], forced, tp)
            res["prompt_set"] = j
            waves[name].append(res)
            local = [la["paged_decode_attention_tp"] + la["paged_decode_attention_int8kv_tp"]
                     for la in res["launches"]]
            verify = [la["paged_decode_attention_tp_verify"]
                      + la["paged_decode_attention_int8kv_tp_verify"] for la in res["launches"]]
            log(f"tp={tp} {name} prompt set {j} on {card}: {res['tokens']} tokens in "
                f"{res['wall_s']:.3f} s ({res['tokens_per_s']:.1f} tokens/s; {tag}); "
                f"kernel-route inner ticks {res['kernel_ticks']} (verify {res['spec_ticks']}), "
                f"gather {res['gather_ticks']}, admission dispatches {res['dispatches']}; "
                f"per-rank head-local paged launches {local} at T=1, {verify} at T=5, flash "
                f"{[la['flash_attention'] for la in res['launches']]}; {res['held']} tokens "
                f"held against the teacher-forced plain trunk, {res['skipped']} near-ties "
                f"skipped; counters {res['counters']}"
                + (f"; swapped-in blocks byte-equal per rank {res['swap_checked']}"
                   if res["swap_checked"][0] is not None else ""))
        short = [a for a in arms if sum(w["held"] for w in waves[a[0]]) < TP_HELD]
        pending = [(a, j) for a in short for j in range(len(waves[a[0]]), FAMILY_MAX_WAVES)]
        if not short:
            break
        if not pending:
            raise AssertionError(
                f"tp={tp} phase h: {[a[0] for a in short]} held fewer than {TP_HELD} tokens "
                f"after {FAMILY_MAX_WAVES} prompt sets")
        log(f"tp={tp} {[a[0] for a in short]} held fewer than {TP_HELD} tokens: a second "
            f"world serves prompt sets up to {FAMILY_MAX_WAVES - 1}")
        results = world([wave(j) for (_, _, wave), j in pending])
    out["arms"] = {}
    for name, _, _ in arms:
        ws = waves[name]
        tokens, wall = sum(w["tokens"] for w in ws), sum(w["wall_s"] for w in ws)
        out["arms"][name] = {"waves": ws, "held": sum(w["held"] for w in ws),
                             "skipped": sum(w["skipped"] for w in ws), "tokens": tokens,
                             "wall_s": wall, "tokens_per_s": tokens / wall}
        log(f"tp={tp} {name}: {len(ws)} wave(s), {tokens} tokens at {tokens / wall:.1f} "
            f"tokens/s ({tag}), {out['arms'][name]['held']} held (floor {TP_HELD})")
    # rows 4v: the verify calls rank 0's wrappers counted in the speculating arms
    out["verify_launches"] = {
        kv: sum(w["verify_launches"] for name, held_by, wave in arms for w in waves[name]
                if wave(0).serving.spec_tokens
                and bool(getattr(wave(0).cfg, "kv_int8", False)) == (kv == "int8"))
        for kv in ("bf16", "int8")}
    log(f"tp={tp} phase h arms checked in {time.perf_counter() - t0:.1f} s")
    out["moves"] = {}
    for k, (name, run, paths) in enumerate(rounds):
        t_check = time.perf_counter()
        res = check_tp_moves(name, run, paths, [r[k] for r in moved], forced, tp)
        lead = moved[0][k]
        res["check_s"] = time.perf_counter() - t_check
        # what the round adds to phase h: its run in the world (a weights
        # load, the groups, engines, round and stops) and its checks here
        res["seconds"] = lead["run_s"] + res["check_s"]
        out["moves"][name] = res
        for m in res["moves"]:
            log(f"tp={tp} {name} on {card}: session {m['session']} {m['from']} -> {m['to']} "
                f"{m['path']} in {m['ms']:.1f} ms, {m['bytes']} bytes "
                f"({m['gb_per_s']:.3f} GB/s; {tag})")
        log(f"tp={tp} {name} on {card}: drain {res['drain_ms']:.1f} ms; {res['held']} tokens "
            f"held against the teacher-forced plain trunk, {res['skipped']} near-ties skipped; "
            f"per-rank launches {res['launches']}; counters {res['counters']}; every rank's "
            f"pool and tier free; {res['seconds']:.1f} s (in the world {lead['run_s']:.1f} s: "
            f"groups {lead['groups_s']:.1f}, engines built {lead['build_s']:.1f}, round "
            f"{lead['wall_s']:.1f}, stops {lead['stop_s']:.1f}; checks "
            f"{res['check_s']:.1f} s)")
    out["h9_seconds"] = sum(r["seconds"] for r in out["moves"].values())
    return out


# ------------------------------------------------------------ m. training

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 10, 1e-3
# bf16 first-step gradients against the same weights' f32 gradients: each
# tensor's cosine at least this, the loss within TRAIN_LOSS_REL (measured on
# an H100 at 700 W: lowest cosine 0.99965, loss rel 1.5e-5)
TRAIN_COSINE = 0.999
TRAIN_LOSS_REL = 1e-3
# phase m2: the other families at full width, a few AdamW steps on a
# fixed batch each (the SSM's log-depth scan keeps every round's [B, S,
# d_inner, d_state] f32 tensors for the backward: a short batch)
FAMILY_TRAIN = {"moe": (4, 512), "ssm": (2, 256)}
FAMILY_STEPS = 5
# phase m3: one 4-rank world at the flagship's widths, depth 4, f32, each
# arm against the single-device port on the card
M3_RANKS = 4
M3_DEPTH = 4
M3_BATCH, M3_SEQ = 4, 512
M3_MOE_SEQ = 256
# sequence-parallel attention at the flagship's attention widths
M3_ATTN = (2, 2048, 8, 128)
# f32 on the card, different reduction orders: a gradient leaf's largest
# difference over its largest magnitude, a loss's relative difference, an
# attention output's absolute difference (measured on an H100 at 700 W over
# gloo: gradients at most 5.7e-6, losses 0, ring 6.0e-7, Ulysses 0)
M3_GRAD_REL = 5e-5
M3_LOSS_REL = 1e-5
M3_ATTN_ATOL = 1e-5
# the MoE arms: capacity factor E / k, so no choice drops and the expert
# route computes the dense route's function (tests/test_moe.py's config)
M3_MOE_ATOL = 2e-4


def tree_items(tree: dict) -> list:
    return ([("embed", tree["embed"])] + [(f"layers.{k}", w) for k, w in tree["layers"].items()]
            + [("final_norm", tree["final_norm"])])


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over b's largest magnitude."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))


def train_flops_per_token(cfg, seq: int) -> float:
    """The model's FLOPs a trained token: 6 x the matmul parameters (the
    layers' and the tied LM head's) plus the attention's 12 x L x H x Dh x
    S, the whole S x S computed (the plain path masks, it skips nothing)."""
    d, f, qd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    per_layer = 4 * d * qd + 3 * d * f
    return 6 * (cfg.n_layers * per_layer + cfg.vocab * d) + 12 * cfg.n_layers * qd * seq


def dense_train_path(log, card: str, device: str = "cuda") -> dict:
    """m1: the flagship, bf16, AdamW, ten steps on one fixed batch; the
    first step's loss and gradients against an f32 copy of the same
    weights."""
    from vtpu_torch.models import ModelConfig, init_params
    from vtpu_torch.parallel import init_train_state, make_train_step, next_token_loss

    cfg = ModelConfig(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=False)
    gen = torch.Generator(device=device).manual_seed(SEED + 500)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                           device=device, dtype=torch.int32)
    params = init_params(SEED, cfg, device=device)
    # the f32 reference first, its activations freed before the bf16 run
    f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref = {"embed": params["embed"].float().requires_grad_(),
           "layers": {k: w.float().requires_grad_() for k, w in params["layers"].items()},
           "final_norm": params["final_norm"].float().requires_grad_()}
    ref_loss = next_token_loss(ref, f32_cfg, tokens)
    ref_loss.backward()
    ref_grads = {path: p.grad for path, p in tree_items(ref)}
    ref_loss = ref_loss.item()
    del ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, opt = init_train_state(params, cfg, lr=TRAIN_LR)
    del params
    step = make_train_step(cfg, opt)
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(loss.item())  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            checks = {path: (cosine(p.grad, ref_grads[path]), rel_err(p.grad, ref_grads[path]))
                      for path, p in tree_items(state["params"])}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, ref_grads
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"m1: ten AdamW steps on one batch did not lower the loss: {losses}")
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    worst = min(checks, key=lambda k: checks[k][0])
    if loss_rel > TRAIN_LOSS_REL or checks[worst][0] < TRAIN_COSINE:
        raise AssertionError(
            f"m1: the bf16 first step against the f32 copy: loss {losses[0]} vs {ref_loss} "
            f"(rel {loss_rel:.2e}, bound {TRAIN_LOSS_REL}); lowest gradient cosine {worst} "
            f"{checks[worst][0]:.5f} (bound {TRAIN_COSINE})")
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    mfu = train_flops_per_token(cfg, TRAIN_SEQ) * tokens_per_s / PEAK_BF16_FLOPS
    log(f"m1 dense train step on {card}: flagship bf16, AdamW lr {TRAIN_LR}, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, use_kernels=False: median step {med:.1f} ms "
        f"[{min(ms[1:]):.1f}, {max(ms[1:]):.1f}] over steps 2-{TRAIN_STEPS} (first {ms[0]:.1f} "
        f"ms), {tokens_per_s:.0f} training tokens/s, peak memory {peak:.2f} GiB, model FLOPs "
        f"{100 * mfu:.1f}% of 989 TFLOP/s (information)")
    log(f"m1 losses over {TRAIN_STEPS} steps: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"m1 first step against the f32 copy: loss {losses[0]:.5f} vs {ref_loss:.5f} (rel "
        f"{loss_rel:.2e}, bound {TRAIN_LOSS_REL}); gradient cosine min {checks[worst][0]:.5f} "
        f"({worst}, bound {TRAIN_COSINE}), largest difference over largest magnitude "
        f"{max(v[1] for v in checks.values()):.3e}")
    return {"losses": losses, "step_ms": ms, "median_step_ms": med, "tokens_per_s": tokens_per_s,
            "peak_gib": peak, "mfu": mfu, "f32_loss": ref_loss, "loss_rel": loss_rel,
            "grad_checks": checks}


def family_train_path(log, card: str, device: str = "cuda") -> dict:
    """m2: the MoE and the SSM of phase k at full width, bf16, a few AdamW
    steps each on one fixed batch: the loss falls."""
    from vtpu_torch.models import (
        MoEConfig, SSMConfig, init_moe_params, init_ssm_params, moe_loss, ssm_loss,
    )
    from vtpu_torch.parallel import adamw

    out = {}
    for name in ("moe", "ssm"):
        if name == "moe":
            cfg = MoEConfig(**MOE_FLAGSHIP, dtype=torch.bfloat16, use_kernels=False)
            params, loss_fn = init_moe_params(SEED, cfg, device=device), moe_loss
        else:
            cfg = SSMConfig(**SSM_FLAGSHIP, dtype=torch.bfloat16)
            params, loss_fn = init_ssm_params(SEED, cfg, device=device), ssm_loss
        params = {"embed": params["embed"].requires_grad_(),
                  "layers": {k: w.requires_grad_() for k, w in params["layers"].items()},
                  "final_norm": params["final_norm"].requires_grad_()}
        optim = adamw(TRAIN_LR).init(params)
        b, s = FAMILY_TRAIN[name]
        gen = torch.Generator(device=device).manual_seed(SEED + 501)
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=device,
                               dtype=torch.int32)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(FAMILY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optim.zero_grad()
            loss = loss_fn(params, cfg, tokens)
            loss.backward()
            optim.step()
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del params, optim
        torch.cuda.empty_cache()
        if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"m2 {name}: {FAMILY_STEPS} AdamW steps did not lower the "
                                 f"loss: {losses}")
        med = sorted(ms[1:])[len(ms[1:]) // 2]
        log(f"m2 {name} train steps on {card}: bf16, batch {b} x {s}: median step {med:.1f} "
            f"ms, {b * s / (med / 1e3):.0f} training tokens/s, peak memory {peak:.2f} GiB; "
            "losses " + ", ".join(f"{x:.4f}" for x in losses))
        out[name] = {"losses": losses, "step_ms": ms, "median_step_ms": med, "peak_gib": peak,
                     "batch": [b, s]}
    return out


def _m3_cfgs():
    from vtpu_torch.models import ModelConfig, MoEConfig

    dense = ModelConfig(**{**FLAGSHIP, "n_layers": M3_DEPTH}, dtype=torch.float32,
                        use_kernels=False)
    moe = MoEConfig(**{**MOE_FLAGSHIP, "n_layers": M3_DEPTH, "capacity_factor": 4.0},
                    dtype=torch.float32, use_kernels=False)
    return dense, moe


def _m3_check_grads(got: dict, ref: dict, split: dict, coords: dict, axis_of: dict) -> float:
    """The worst relative difference of a rank's gradient shards against
    the single-device gradients: a leaf split over a mesh axis compares to
    the rank's slice along it."""
    worst = 0.0
    for path, g in got.items():
        want = ref[path]
        ax = split.get(path)
        if ax is not None:
            n, i = axis_of["size"], coords[axis_of["name"]]
            part = want.shape[ax] // n
            want = want.narrow(ax, i * part, part)
        worst = max(worst, rel_err(g, want))
    return worst


def training_world(world, root: str) -> dict:
    """m3's rank program: every arm on the world's ranks, each against the
    single-device reference the parent saved under ``root``."""
    import hashlib

    import torch.distributed as dist

    from vtpu_torch.models import init_moe_params, init_params
    from vtpu_torch.ops import _build
    from vtpu_torch.parallel import (
        TrainCheckpointer, ep_moe_forward, init_train_state, make_axis_mesh, make_dp_ep_mesh,
        make_mesh, make_multislice_mesh, make_sp_mesh, make_train_step, param_split_axes,
        place_batch, place_sp_tokens, pp_loss, ring_attention, shard_ep_params, shard_stages,
        sp_loss, ulysses_attention,
    )

    _build.reset_launches()
    dev = world.device
    cfg, moe_cfg = _m3_cfgs()
    ref = torch.load(f"{root}/ref.pt", map_location=dev)
    tokens = ref["tokens"]
    split = param_split_axes()
    full = init_params(SEED, cfg, device=dev)
    out = {"rank": world.rank}

    def trained(mesh, name):
        state, opt = init_train_state(full, cfg, mesh)
        state, loss = make_train_step(cfg, opt)(state, place_batch(tokens, mesh))
        grads = {p: x.grad for p, x in tree_items(state["params"])}
        out[name] = {"loss": loss.item(), "loss_rel": abs(loss.item() - ref["loss"]) / ref["loss"],
                     "grad_rel": _m3_check_grads(grads, ref["grads"], split, mesh.coords,
                                                 {"name": "tp", "size": mesh.shape["tp"]})}
        return state, opt

    mesh = make_mesh(world, M3_RANKS, tp=2)
    state, opt = trained(mesh, "dp2_tp2")
    trained(make_multislice_mesh(world, 2, per_slice=2, tp=2), "multislice")

    # checkpoint: dp2 x tp2 saved, restored on dp1 x tp4, byte for byte: the
    # parameters, both AdamW moments and the step counts
    def shards_of(state):
        optim = state["opt_state"]
        out = {}
        for p, x in tree_items(state["params"]):
            out[p] = x.detach().cpu()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{key}:{p}"] = optim.state[x][key].detach().cpu()
        counts = {float(st["step"]) for st in optim.state.values()}
        return out, counts

    ckpt = TrainCheckpointer(f"{root}/ckpt")
    ckpt.save(1, state)
    shards, saved_counts = shards_of(state)
    torch.save(shards, f"{root}/shards_{world.rank}.pt")
    del state, shards
    mesh_b = make_mesh(world, M3_RANKS, tp=4)
    restored, _ = ckpt.restore(cfg, mesh_b, opt)
    dist.barrier()
    tp_b = mesh_b.coords["tp"]
    # the mesh-a rank (dp 0) whose tp shard holds this rank's quarter
    src = [r for r in range(M3_RANKS) if (r // 2, r % 2) == (0, tp_b // 2)][0]
    held = torch.load(f"{root}/shards_{src}.pt")
    got, counts = shards_of(restored)
    equal = {"params": True, "moments": True}
    for name, x in got.items():
        p = name.split(":")[-1]
        want = held[name]
        if split[p] is not None:
            part = want.shape[split[p]] // 2
            want = want.narrow(split[p], (tp_b % 2) * part, part)
        equal["moments" if ":" in name else "params"] &= torch.equal(x, want)
    out["checkpoint"] = {"byte_equal": bool(equal["params"]),
                         "moments_equal": bool(equal["moments"]),
                         "counts": sorted(counts), "saved_counts": sorted(saved_counts),
                         "step": ckpt.latest_step(),
                         "digest": hashlib.sha256(b"".join(
                             x.detach().cpu().numpy().tobytes()
                             for _, x in tree_items(restored["params"]))).hexdigest()}
    del restored, held

    # sequence parallelism: ring and Ulysses at sp=4, then sp_loss
    sp = make_sp_mesh(world, M3_RANKS)
    q, k, v = (place_sp_tokens(ref[x], sp) for x in ("q", "k", "v"))
    want = place_sp_tokens(ref["attn"], sp)
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        with torch.no_grad():
            o = fn(q, k, v, sp)
        out[name] = float((o - want).abs().max())

    def leaves_of(tree):
        return {"embed": tree["embed"].detach().clone().requires_grad_(),
                "layers": {kk: w.detach().clone().requires_grad_()
                           for kk, w in tree["layers"].items()},
                "final_norm": tree["final_norm"].detach().clone().requires_grad_()}

    params = leaves_of(full)
    loss = sp_loss(params, cfg, place_sp_tokens(tokens, sp), sp)
    loss.backward()
    out["sp_loss"] = {"loss_rel": abs(loss.item() - ref["loss"]) / ref["loss"],
                      "grad_rel": max(rel_err(x.grad, ref["grads"][p])
                                      for p, x in tree_items(params))}
    del params

    # the pipeline: pp=4, a layer a stage
    pp = make_axis_mesh(world, "pp", M3_RANKS)
    params = leaves_of(shard_stages(full, pp))
    loss = pp_loss(params, cfg, tokens, pp)
    loss.backward()
    layer_split = {p: (0 if p.startswith("layers.") else None) for p, _ in tree_items(params)}
    out["pp_loss"] = {"loss_rel": abs(loss.item() - ref["loss"]) / ref["loss"],
                      "grad_rel": _m3_check_grads({p: x.grad for p, x in tree_items(params)},
                                                  ref["grads"], layer_split, pp.coords,
                                                  {"name": "pp", "size": M3_RANKS})}
    del params, full

    # experts: ep=4 and dp2 x ep2 against the dense MoE's logits
    moe_full = init_moe_params(SEED, moe_cfg, device=dev)
    for name, mesh in (("ep4", make_axis_mesh(world, "ep", M3_RANKS)),
                       ("dp2_ep2", make_dp_ep_mesh(world, M3_RANKS, ep=2))):
        with torch.no_grad():
            logits, aux = ep_moe_forward(shard_ep_params(moe_full, mesh), moe_cfg,
                                         place_batch(ref["moe_tokens"], mesh), mesh)
        out[name] = {"max_abs": float((logits - place_batch(ref["moe_logits"], mesh))
                                      .abs().max()), "aux": float(aux)}
    out["launches"] = _build.launches()
    return out


def parallel_train_path(log, card: str, device: str = "cuda") -> dict:
    """m3: one spawned 4-rank world, a sharding check of every training
    mesh at the flagship's widths, depth 4, f32 (gloo with the ranks on
    card 0, or nccl with a card each when there are four)."""
    import tempfile

    from vtpu_torch.models import init_moe_params, init_params, moe_forward
    from vtpu_torch.ops import causal_attention
    from vtpu_torch.parallel import next_token_loss
    from vtpu_torch.parallel.launch import launch

    if device == "cuda" and torch.cuda.device_count() >= M3_RANKS:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(M3_RANKS)]
        how = f"{M3_RANKS} ranks on {M3_RANKS} cards over nccl"
    else:
        backend, devices = "gloo", [f"{device}:0" if device == "cuda" else device] * M3_RANKS
        how = (f"{M3_RANKS} ranks sharing one card over gloo (collectives staged through host "
               "memory: a sharding check, not a speed figure)")
    cfg, moe_cfg = _m3_cfgs()
    gen = torch.Generator(device=device).manual_seed(SEED + 502)
    tokens = torch.randint(0, cfg.vocab, (M3_BATCH, M3_SEQ), generator=gen, device=device,
                           dtype=torch.int32)
    params = init_params(SEED, cfg, device=device)
    params = {"embed": params["embed"].requires_grad_(),
              "layers": {k: w.requires_grad_() for k, w in params["layers"].items()},
              "final_norm": params["final_norm"].requires_grad_()}
    loss = next_token_loss(params, cfg, tokens)
    loss.backward()
    q, k, v = (torch.randn(M3_ATTN, generator=gen, device=device) for _ in range(3))
    moe_tokens = torch.randint(0, moe_cfg.vocab, (M3_BATCH, M3_MOE_SEQ), generator=gen, device=device,
                               dtype=torch.int32)
    with torch.no_grad():
        moe_logits, _ = moe_forward(init_moe_params(SEED, moe_cfg, device=device), moe_cfg,
                                    moe_tokens)
        attn = causal_attention(q, k, v)
    ref = {"tokens": tokens, "loss": loss.item(),
           "grads": {p: x.grad for p, x in tree_items(params)}, "q": q, "k": k, "v": v,
           "attn": attn, "moe_tokens": moe_tokens, "moe_logits": moe_logits}
    with tempfile.TemporaryDirectory() as root:
        torch.save(ref, f"{root}/ref.pt")
        del ref, params, moe_logits
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch(training_world, M3_RANKS, backend, devices, f"file://{root}/store",
                       args=(root,), timeout=600)
        wall = time.perf_counter() - t0
    log(f"m3 training world on {card} ({how}): {wall:.1f} s wall, start-up included; flagship "
        f"widths, depth {M3_DEPTH}, f32")
    fails = []
    for r in ranks:
        for arm in ("dp2_tp2", "multislice", "sp_loss", "pp_loss"):
            a = r[arm]
            if not (a["loss_rel"] <= M3_LOSS_REL and a["grad_rel"] <= M3_GRAD_REL):
                fails.append(f"rank {r['rank']} {arm}: {a}")
        for arm in ("ring", "ulysses"):
            if not r[arm] <= M3_ATTN_ATOL:
                fails.append(f"rank {r['rank']} {arm}: max abs {r[arm]}")
        for arm in ("ep4", "dp2_ep2"):
            if not r[arm]["max_abs"] <= M3_MOE_ATOL:
                fails.append(f"rank {r['rank']} {arm}: {r[arm]}")
        c = r["checkpoint"]
        if (not (c["byte_equal"] and c["moments_equal"]) or c["step"] != 1
                or c["counts"] != c["saved_counts"] or c["counts"] != [1.0]):
            fails.append(f"rank {r['rank']} checkpoint: {r['checkpoint']}")
        kern = {k: n for k, n in r["launches"].items() if n}
        if kern:
            fails.append(f"rank {r['rank']} launched kernels in phase m: {kern}")
    for arm in ("dp2_tp2", "multislice", "sp_loss", "pp_loss"):
        log(f"m3 {arm}: loss rel {max(r[arm]['loss_rel'] for r in ranks):.2e} (bound "
            f"{M3_LOSS_REL}), gradient max diff / max magnitude "
            f"{max(r[arm]['grad_rel'] for r in ranks):.2e} (bound {M3_GRAD_REL}) over "
            f"{M3_RANKS} ranks, against the single-device port")
    log(f"m3 ring / ulysses at sp={M3_RANKS}, {M3_ATTN}: max abs "
        f"{max(r['ring'] for r in ranks):.2e} / {max(r['ulysses'] for r in ranks):.2e} against "
        f"plain causal attention (bound {M3_ATTN_ATOL})")
    log(f"m3 ep4 / dp2_ep2 MoE logits: max abs {max(r['ep4']['max_abs'] for r in ranks):.2e} / "
        f"{max(r['dp2_ep2']['max_abs'] for r in ranks):.2e} against the dense MoE (bound "
        f"{M3_MOE_ATOL})")
    log(f"m3 checkpoint: dp2 x tp2 saved, dp1 x tp4 restored byte-equal on "
        f"{sum(r['checkpoint']['byte_equal'] for r in ranks)} of {M3_RANKS} ranks (parameters), "
        f"{sum(r['checkpoint']['moments_equal'] for r in ranks)} of {M3_RANKS} (AdamW "
        f"moments); step counts {sorted({x for r in ranks for x in r['checkpoint']['counts']})}")
    if fails:
        raise AssertionError("m3: " + "; ".join(fails))
    return {"backend": backend, "wall_s": wall, "ranks": ranks}


def training_path(log, card: str, device: str = "cuda") -> dict:
    """Phase m: training on one card (m1, m2) and over every mesh (m3),
    with no kernel launched. (``device`` "cpu" rehearses it at a tiny
    size, with the torch.cuda calls stubbed.)"""
    from vtpu_torch.ops import _build

    _build.reset_launches()
    out = {}
    for name, fn in (("m1", dense_train_path), ("m2", family_train_path),
                     ("m3", parallel_train_path)):
        t0 = time.perf_counter()
        out[name] = fn(log, card, device)
        out[name]["phase_s"] = time.perf_counter() - t0
        log(f"{name}: {out[name]['phase_s']:.1f} s")
    got = {k: n for k, n in _build.launches().items() if n}
    if got:
        raise AssertionError(f"phase m launched kernels: {got}")
    out["launches"] = _build.launches()
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
               *check_paged_tp(gen, log, int8=False), *check_paged_tp(gen, log, int8=True)]
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
    # wall seconds of each phase from the end of the one before it
    phase_s: dict = {}
    marks = [time.perf_counter()]

    trunk_s: dict = {}

    def mark(name: str) -> None:
        marks.append(time.perf_counter())
        phase_s[name] = marks[-1] - marks[-2]
        (free_s, free_n), (forced_s, forced_n) = TRUNK["free"], TRUNK["forced"]
        if free_n or forced_n:
            trunk_s[name] = {"free_s": free_s, "free_steps": free_n,
                             "forced_s": forced_s, "forced_steps": forced_n}
            log(f"{name}: plain-trunk references {free_s:.1f} s ({free_n} free-running "
                f"steps), teacher-forced checks {forced_s:.1f} s ({forced_n} steps), of "
                f"{phase_s[name]:.1f} s")
        for v in TRUNK.values():
            v[:] = [0.0, 0]

    runs = {"main_path": serving_path(log, card, params, kv_int8=False),
            "int8_serving_path": serving_path(log, card, params, kv_int8=True)}
    refs = {"bf16": runs["main_path"].pop("refs"), "int8": runs["int8_serving_path"].pop("refs")}
    mark("serving paths")
    runs["loop_comparison"] = {kv: loop_comparison(log, card, params, kv == "int8", refs[kv])
                               for kv in ("bf16", "int8")}
    mark("loop comparison")
    runs["host_sampler_path"] = host_sampler_path(log, card, params, refs["bf16"],
                                                  runs["main_path"]["tokens_per_s"])
    mark("host sampler")
    runs["chunked_prefix_path"] = chunked_prefix_path(log, card, params)
    mark("chunked + prefix")
    runs["device_loop_spec_path"] = device_loop_spec_path(log, card, params, refs)
    mark("device loop + speculation")
    runs["overcommit_path"] = overcommit_path(log, card, params, refs)
    mark("overcommit")
    runs["failure_domains_path"] = failure_domains_path(log, card, params)
    mark("failure domains")
    runs["model_families_path"] = model_families_path(log, card, runs["main_path"])
    mark("model families")
    runs["disagg_path"] = disagg_path(log, card, params)
    mark("disaggregation")
    runs["migration_path"] = migration_path(log, card, params, refs)
    mark("migration")
    runs["fleet_path"] = fleet_path(log, card, params, refs)
    mark("fleet")
    runs["fabric_path"] = fabric_path(log, card, params, refs)
    mark("fabric")
    runs["auto_path"] = auto_path(log, card, params)
    mark("kv_int8 auto")
    runs["study_path"] = study_path(gen, log)
    mark("study")
    torch.cuda.empty_cache()  # the TP ranks share this card when there is one
    for tp in (TP, 4):
        if tp == TP or torch.cuda.device_count() >= tp:
            out = tp_serving_paths(log, card, tp)
            pre = "tp" if tp == TP else f"tp{tp}"
            runs[f"{pre}_serving_path"], runs[f"{pre}_int8_serving_path"] = out["bf16"], out["int8"]
            if "arms" in out:
                runs["tp_ops_path"] = {"arms": out["arms"],
                                       "verify_launches": out["verify_launches"]}
                runs["tp_moves_path"] = out["moves"]
            mark(f"tp={tp}")
            if "h9_seconds" in out:
                phase_s["h9 (within tp=2)"] = out["h9_seconds"]
    del params
    PLAIN_STEPS.clear()
    torch.cuda.empty_cache()
    runs["training_path"] = training_path(log, card)
    mark("training")
    log("phase wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    bf16, int8 = runs["main_path"], runs["int8_serving_path"]
    log(f"serving waves on {card}: bf16 KV {bf16['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{bf16['ttft_ms'][len(bf16['ttft_ms']) // 2]:.1f} ms; int8 KV "
        f"{int8['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{int8['ttft_ms'][len(int8['ttft_ms']) // 2]:.1f} ms")
    for kv, cmp in runs["loop_comparison"].items():
        med = {name: sorted(w["tokens_per_s"] for w in cmp[name]["waves"])[REPEATS // 2]
               for name in ("pipelined", "sync")}
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
        if kern["name"].endswith("_verify"):
            # rows 4v: what rank 0's wrappers counted at T > 1 in phase h's
            # speculating arms (held there at n_layers x their verify ticks)
            kv = "int8" if "int8" in kern["name"] else "bf16"
            kern["launches"] = runs["tp_ops_path"]["verify_launches"][kv]
        else:
            kern["launches"] = runs[path_of[kern["name"]]]["launches"][kern["name"]]
        if not kern["launches"]:
            raise AssertionError(f"{kern['name']} was not launched on its path")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "builds": {k: v["seconds"] for k, v in builds.items()},
                       "phase_seconds": phase_s, "plain_trunk_seconds": trunk_s,
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
