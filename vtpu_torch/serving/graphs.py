"""CUDA graphs over the engine's decode steps.

A decode tick of the flagship model enqueues several hundred kernels from
Python; replayed from a graph it is one launch from the host. The engine
builds one ``DecodeGraphs`` per step it dispatches on one CUDA card (no
mesh): the sampled decode tick, the k-tick flush of ``decode_loop_k``, the
verify tick of ``spec_tokens`` and the fused speculation flush (one set
per flush window a LoopPolicy may pick). Each holds one graph per (kv
bucket, paged route, KV type), every graph captured when the engine is
built, each replayed with its inputs copied into static buffers. JAX has
no counterpart to port: its jitted step is already one dispatch.

What a graph holds fixed, and why that is sound here:
- the params, the state dict and its tensors: every step updates the
  cache, the page table and the lengths in place (an SSM's conv windows and
  states likewise), so their addresses never change (the engine's own
  writes into the table and lengths are in place too);
- the step's input tensors (tokens and the active mask; per step also the
  caps, a verify draft, a draft window and its lengths), copied into
  static buffers before each replay;
- the output (a tensor, or a tuple of them): each replay returns a copy,
  since the next replay overwrites the graph's own buffers;
- the split partials of the paged kernels and every other temporary,
  allocated inside the capture from the graph's own memory pool, which
  lives as long as the graph (no two graphs share a pool);
- the sampling generators: each slot's generator is registered with every
  graph, so a replay draws the numbers the eager step would draw (a
  k-tick flush draws k times).

The paged kernels launch on ``torch.cuda.current_stream``, which is the
capture stream during capture; their walk and combine are launched with
programmatic stream serialization and capture as a programmatic edge.

Launch counts: a wrapper counts its launch when its Python runs, which at
capture is a recording, not a launch. So the counts a capture adds are
taken back, kept with the graph, and added again by every replay.

Capture runs under ``torch.cuda.set_sync_debug_mode("error")``: a step
that reads the device from the host raises there. It runs with Python's
cyclic collector off, after one collection, so no earlier engine's graph
is destroyed inside it. A failed capture or
replay raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from vtpu_torch.ops import _build
from vtpu_torch.ops.decode_attn import paged_attn_route


class DecodeGraphs:
    """One engine step, ``step(params, state, *inputs, gens, kv_bucket) ->
    (out, state)``, captured once per kv bucket for one engine's params,
    state and generators, and called with the same signature. ``out`` is a
    tensor or a tuple of tensors (None entries pass through).

    ``inputs`` are the (shape, dtype) of the step's input tensors, each
    held in a static buffer; the default is the decode tick's tokens [B]
    int32 and active mask [B] bool. ``t`` is the queries a row the step's
    attention reads (1 for a tick or a flush of ticks, K+1 for a verify),
    which picks its paged route.

    ``kv_buckets`` are every read window the engine can dispatch (0 = the
    whole context; an SSM's one); each is warmed once eagerly with every
    input buffer zero-filled (no row active: the step writes nothing and
    leaves the lengths as they are) on throwaway generators, then
    captured."""

    def __init__(self, step: Callable, params, state: dict, gens: list, kv_buckets,
                 paged_attn=None, sampled: bool = False, inputs=None, t: int = 1):
        self._step = step
        self._params = params
        self._state = state
        self._gens = gens
        # a KV state's lengths, or an SSM state's [L, B, ...] planes
        b = state["len"].shape[0] if "len" in state else state["h"].shape[1]
        dev = next(iter(state.values())).device
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs need the state on a CUDA device, got {dev}")
        self.device = dev
        if inputs is None:
            inputs = (((b,), torch.int32), ((b,), torch.bool))
        self._inputs = [torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype in inputs]
        self._paged_attn = paged_attn
        self._t = t
        self._kv_type = ("int8" if "k_scale" in state else
                         str(state["k"].dtype) if "k" in state else "ssm")
        self._sampled = sampled
        self._graphs: dict = {}
        self._stream = torch.cuda.Stream(dev)
        self.replays = 0
        for bkt in kv_buckets:
            self._capture(bkt)

    def key(self, kv_bucket: int) -> tuple:
        """(kv bucket, paged route or "dense", KV type) of one graph."""
        route = ("dense" if "table" not in self._state
                 else paged_attn_route(self._paged_attn, kv_bucket, self.device, self._t))
        return (kv_bucket, route, self._kv_type)

    def keys(self) -> list:
        return list(self._graphs)

    def launches(self, kv_bucket: int) -> dict:
        """The kernel launches one replay of ``kv_bucket``'s graph makes."""
        return dict(self._graphs[self.key(kv_bucket)]["launches"])

    def _capture(self, kv_bucket: int) -> None:
        key = self.key(kv_bucket)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            # the warm-up runs every lazy first use (library handles, module
            # loads, the rope tables) outside the capture; no row active
            # and fresh generators, so no state and no slot's stream moves
            spare = [torch.Generator(device=self.device).manual_seed(i)
                     for i in range(len(self._gens))]
            self._step(self._params, self._state, *self._inputs, spare, kv_bucket)
            graph = torch.cuda.CUDAGraph()
            if self._sampled:
                for gen in self._gens:
                    graph.register_generator_state(gen)
            before = _build.launches()
            mode = torch.cuda.get_sync_debug_mode()
            # an unreachable graph of an earlier engine, reclaimed by the
            # cyclic collector while this capture runs, is reset inside the
            # capture ("operation not permitted when stream is capturing"),
            # which invalidates it: the step's next cuBLAS call then fails
            # with CUBLAS_STATUS_EXECUTION_FAILED. Collect first, as
            # torch.cuda.graph does, and hold the collector off until the
            # capture ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            torch.cuda.set_sync_debug_mode("error")
            try:
                graph.capture_begin()
                try:
                    out, state = self._step(self._params, self._state, *self._inputs,
                                            self._gens, kv_bucket)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already: the step's error is the cause
                    raise
                graph.capture_end()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                if collecting:
                    gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        recorded = {k: n - before[k] for k, n in _build.launches().items() if n != before[k]}
        for k, n in recorded.items():
            _build.LAUNCHES[k] -= n  # recorded at capture, launched by each replay
        if not self._same_state(state):
            raise RuntimeError("the decode step replaced a state tensor instead of updating it "
                               "in place: a graph cannot replay it")
        self._graphs[key] = {"graph": graph, "out": out, "launches": recorded}

    def _same_state(self, state: dict) -> bool:
        return state.keys() == self._state.keys() and all(
            state[k] is x for k, x in self._state.items())

    def __call__(self, params, state, *args):
        *inputs, gens, kv_bucket = args
        if params is not self._params or gens is not self._gens or not self._same_state(state):
            raise RuntimeError("DecodeGraphs replays the params, state and generators it "
                               "captured; these are others")
        if len(inputs) != len(self._inputs):
            raise TypeError(f"the captured step takes {len(self._inputs)} input tensors, "
                            f"got {len(inputs)}")
        entry = self._graphs.get(self.key(kv_bucket))
        if entry is None:
            raise RuntimeError(f"no decode graph captured for kv bucket {kv_bucket} "
                               f"(captured: {self.keys()})")
        for buf, x in zip(self._inputs, inputs):
            buf.copy_(x, non_blocking=True)
        entry["graph"].replay()
        for k, n in entry["launches"].items():
            _build.LAUNCHES[k] += n
        self.replays += 1
        out = entry["out"]
        if isinstance(out, tuple):
            return tuple(None if x is None else x.clone() for x in out), state
        return out.clone(), state
