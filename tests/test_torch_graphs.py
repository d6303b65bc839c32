"""CUDA graphs over the decode step (vtpu_torch/serving/graphs.py), on a
card. Every case needs a CUDA device and skips without one: a graph has no
CPU mode.

This file imports neither jax nor vtpu, so it runs on a machine that has
only PyTorch: ``pytest --noconftest -m cuda tests/test_torch_graphs.py``.

Held: a replayed step equals the eager step bit for bit (sampled tokens,
every KV plane, the lengths), bf16 and int8 KV, paged and dense; each
replay adds the launches its capture recorded and the capture itself adds
none; the paged kernels' split walk and combine capture as one
programmatic edge; a step that reads the device from the host cannot be
captured (the capture runs under ``set_sync_debug_mode("error")``) and
nothing falls back to the eager step; the engine's pipelined loop on
graphs streams what its synchronous eager loop streams, greedy and seeded
temperature sampling alike, with paged launches = n_layers x decode
ticks; a logprobs step's replay equals its eager step (tokens and
logprobs) bit for bit; chunked and prefixed admissions between replays
leave the streams equal to the eager loop's and every state tensor at its
address; a k-tick flush's replay equals k eager ticks (greedy and under
temperature, logprobs included), a verify tick's and a fused flush's
replays their eager steps, bit for bit; and the engine's multi-tick,
speculating and fused loops serve on graphs captured at construction
only, their streams held against the plain trunk; a replay after an
in-place swap-in (the staging scatter into other blocks, the table row
remapped in place) reads the restored blocks, bit for bit the eager step
on a state that never swapped; the engine's own swap-out and swap-in
(side copy stream, pinned tier, staging buffers) keep every byte of every
KV and scale plane while the released blocks are overwritten at once; and
an overcommit engine parks, evicts to its pinned host tier and resumes on
its graphs, streaming token for token what a twin engine that never parks
streams; a lost restore rebuilds through one bucket prefill inside the
swap-in dispatch with no host wait (that dispatch runs under
``set_sync_debug_mode("error")``); the MoE and SSM families' decode steps replay bit for bit their
eager steps (an SSM state written in place, masked by the active flags),
their engines on graphs stream what their synchronous eager loops stream,
an SSM prompt admitted beside another yields the logits it yields alone,
and MoE routing (comparisons with an arange, no one_hot) captures under
``set_sync_debug_mode("error")``, drops and pad mask included; and a
disaggregated engine's prefill worker chunks on its own stream beside the
loop's replays, its graphs captured once, with no block it writes ever
overwritten by the loop stream's work on that block from before its
release."""

import ctypes
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

from vtpu_torch.models import (
    LOOP_PAD_TOKEN, ModelConfig, MoEConfig, SSMConfig, init_moe_params, init_params,
    init_ssm_params,
)
from vtpu_torch.models.moe import moe_ffn, route
from vtpu_torch.ops import _build
from vtpu_torch.ops.decode_attn import paged_decode_attention, paged_split_plan
from vtpu_torch.serving import ServingConfig, ServingEngine, Status, TransformerSlotModel
from vtpu_torch.serving.adapters import (
    MoeSlotModel, SsmSlotModel, fused_spec_decode_step, multi_tick_decode_step,
    sampled_decode_step, swap_page_gather, swap_page_scatter, verify_step,
)
from vtpu_torch.serving.graphs import DecodeGraphs

pytestmark = pytest.mark.cuda

DIMS = dict(vocab=512, d_model=256, n_heads=2, n_layers=2, d_ff=512, max_seq=256,
            head_dim=128)
PAGE = 16
NEW = 12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(kv):
    return ModelConfig(**DIMS, dtype=torch.bfloat16, use_kernels=True, kv_int8=kv == "int8")


def _admitted_state(model, params, page):
    """Three slots of four prefilled (slot 3 idle, its stale row naming slot
    0's first block), as the engine leaves them after an admission."""
    dev = model.device
    state = model.init_state(4)
    lens = [37, 64, 5]
    gen = torch.Generator(device=dev).manual_seed(1)
    if page is not None:
        nxt = 1
        for s, n in enumerate(lens):
            pages = -(-(n + NEW) // page)
            state["table"][s, :pages] = torch.arange(nxt, nxt + pages, device=dev)
            nxt += pages
        state["table"][3, 0] = 1
    padded = torch.randint(1, DIMS["vocab"], (3, 64), generator=gen, device=dev,
                           dtype=torch.int32)
    _, state = model.prefill_into_slots(params, state, padded,
                                        torch.arange(3, device=dev),
                                        torch.tensor(lens, device=dev))
    return state


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
def test_replay_equals_eager_step(dev, kv, page):
    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=page, device=dev)
    eager_state = _admitted_state(model, params, page)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    step = sampled_decode_step(model, 0.0, 0, 1.0)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    graphs = DecodeGraphs(step, params, graph_state, gens, (128, 256), paged_attn=None)
    for key in eager_state:  # the warm-ups wrote nothing
        assert torch.equal(graph_state[key], eager_state[key]), key
    active = torch.tensor([True, True, True, False], device=dev)
    tok_e = tok_g = torch.tensor([3, 4, 5, 0], dtype=torch.int32, device=dev)
    for bucket in (128, 128, 256):
        tok_e, eager_state = step(params, eager_state, tok_e, active, gens, bucket)
        tok_g, graph_state = graphs(params, graph_state, tok_g, active, gens, bucket)
        torch.cuda.synchronize()
        assert torch.equal(tok_e, tok_g)
        for key in eager_state:
            assert torch.equal(graph_state[key], eager_state[key]), key
    assert graphs.replays == 3
    assert [k[0] for k in graphs.keys()] == [128, 256]
    assert all(k[1] == ("kernel" if page else "dense") for k in graphs.keys())


def test_launch_counts_follow_replays(dev):
    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=PAGE, device=dev)
    state = _admitted_state(model, params, PAGE)
    step = sampled_decode_step(model, 0.0, 0, 1.0)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    _build.reset_launches()
    graphs = DecodeGraphs(step, params, state, gens, (128, 256))
    # one eager warm-up per bucket launched; the captures launched nothing
    assert _build.launches()["paged_decode_attention"] == 2 * cfg.n_layers
    assert graphs.launches(128) == {"paged_decode_attention": cfg.n_layers}
    _build.reset_launches()
    active = torch.tensor([True, True, True, False], device=dev)
    tok = torch.zeros((4,), dtype=torch.int32, device=dev)
    for bucket in (128, 256, 256, 128, 128):
        tok, state = graphs(params, state, tok, active, gens, bucket)
    torch.cuda.synchronize()
    got = _build.launches()
    assert got["paged_decode_attention"] == 5 * cfg.n_layers
    assert sum(got.values()) == got["paged_decode_attention"]


def _graph_edges(graph) -> list[tuple[int, int, int]]:
    """(from_port, to_port, type) of every edge of a kept graph, read with
    libcuda's cuGraphGetEdges_v2 (CUgraphEdgeData: three bytes, then
    five reserved)."""
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert fn(handle, None, None, None, ctypes.byref(n)) == 0
    ends = [(ctypes.c_void_p * n.value)() for _ in range(2)]
    data = (ctypes.c_ubyte * (8 * n.value))()
    assert fn(handle, ends[0], ends[1], data, ctypes.byref(n)) == 0
    return [tuple(data[8 * i:8 * i + 3]) for i in range(n.value)]


def test_split_walk_and_combine_capture_as_a_programmatic_edge(dev):
    """One paged call (the split walk, then the combine launched with
    programmatic stream serialization) captured alone: two kernel nodes
    joined by one programmatic edge (type 1, from the walk's programmatic
    port 1), and its replay equals the eager call bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = [torch.randn((2, 17, 16, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2)]
    table = torch.arange(1, 17, dtype=torch.int32, device=dev).view(2, 8)
    kv_len = torch.tensor([[100], [37]], dtype=torch.int32, device=dev)
    q = torch.randn((2, 1, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
    assert paged_split_plan(2, 2, 8, 16) > 1
    want = paged_decode_attention(q, *pool, table, kv_len, layer=1)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = paged_decode_attention(q, *pool, table, kv_len, layer=1)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    assert _graph_edges(graph) == [(1, 0, 1)]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_a_step_that_syncs_cannot_be_captured(dev):
    """The capture runs under set_sync_debug_mode("error"): a host read of
    the device inside the step raises, and no graph (and no eager
    stand-in) is left behind."""
    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=PAGE, device=dev)
    state = model.init_state(4)
    step = sampled_decode_step(model, 0.0, 0, 1.0)

    def syncing_step(params, state, tokens, active, gens, kv_bucket):
        tok, state = step(params, state, tokens, active, gens, kv_bucket)
        if int(tok.sum()) < 0:  # a device->host read
            raise AssertionError("unreachable")
        return tok, state

    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    with pytest.raises(RuntimeError):
        DecodeGraphs(syncing_step, params, state, gens, (256,))
    assert torch.cuda.get_sync_debug_mode() == 0  # restored


def _serve(params, cfg, prompts, **kw):
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(64,), max_new_tokens=NEW, **kw))
    reqs = [eng.submit(p) for p in prompts]  # before start: one admission sweep
    _build.reset_launches()
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert eng.loop_error is None
    assert [r.status for r in reqs] == [Status.OK] * len(prompts)
    return eng, outs, _build.launches()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "temperature"])
def test_engine_graphs_stream_what_the_eager_loop_streams(dev, kv, page, temperature):
    """Four prompts submitted before start (one admission sweep, so both
    loops dispatch the same ticks and every slot's generator draws the
    same numbers): the pipelined loop on graphs and the synchronous eager
    loop give the same streams."""
    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, DIMS["vocab"], (n,), generator=gen).numpy()
               for n in (9, 64, 33, 17)]
    kw = dict(kv_page=page, temperature=temperature, top_k=16, sampling_seed=5)
    eng, outs, launches = _serve(params, cfg, prompts, **kw)
    _, sync_outs, _ = _serve(params, cfg, prompts, pipeline_decode=False, **kw)
    assert outs == sync_outs
    assert all(len(o) == NEW for o in outs)
    st = eng.stats()
    assert eng.decode_graphs is not None and eng.decode_graphs.replays == st["decode_ticks"]
    assert st["pipelined"] and st["pipelined_ticks"] > 0
    assert st["device_gets_per_tick"] == 1.0
    name = "paged_decode_attention_int8kv" if kv == "int8" else "paged_decode_attention"
    assert launches[name] == (cfg.n_layers * st["decode_ticks"] if page else 0)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "temperature"])
@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
def test_logprobs_replay_equals_eager_step(dev, page, temperature):
    """A logprobs engine's step records the logprobs as one more graph
    output: a replay gives the eager step's tokens and logprobs bit for bit,
    and the state it leaves."""
    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=page, device=dev)
    eager_state = _admitted_state(model, params, page)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    step = sampled_decode_step(model, temperature, 16, 1.0, logprobs=True)
    gens_e = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    gens_g = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    graphs = DecodeGraphs(step, params, graph_state, gens_g, (128, 256),
                          sampled=temperature > 0.0)
    active = torch.tensor([True, True, True, False], device=dev)
    tok_e = tok_g = torch.tensor([3, 4, 5, 0], dtype=torch.int32, device=dev)
    for bucket in (128, 256, 256):
        (tok_e, lp_e), eager_state = step(params, eager_state, tok_e, active, gens_e, bucket)
        (tok_g, lp_g), graph_state = graphs(params, graph_state, tok_g, active, gens_g, bucket)
        torch.cuda.synchronize()
        assert torch.equal(tok_e, tok_g) and torch.equal(lp_e, lp_g)
        assert lp_g.dtype == torch.float32 and bool((lp_g[:3] <= 0).all())
        for key in eager_state:
            assert torch.equal(graph_state[key], eager_state[key]), key
    assert graphs.replays == 3


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
def test_chunked_and_prefixed_admissions_between_replays(dev, kv, page):
    """Prompts past the 64 bucket (chunks of 32) and two prefixed suffixes
    admit while the other slots decode: on the pipelined loop their chunks
    and the prefix's install or block share run between graph replays, and
    the streams equal the synchronous eager loop's. Every state tensor keeps
    its address, graph replays equal decode ticks, and paged launches are
    n_layers x decode ticks."""
    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, DIMS["vocab"], (n,), generator=gen).numpy()
               for n in (9, 150, 33, 200)]
    prefix = torch.randint(1, DIMS["vocab"], (40,), generator=gen).numpy()
    suffixes = [torch.randint(1, DIMS["vocab"], (n,), generator=gen).numpy() for n in (20, 0)]
    got = {}
    for name, pipeline in (("graphs", None), ("eager", False)):
        eng = ServingEngine(params, cfg, ServingConfig(
            slots=4, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=page,
            prefill_chunk=32, pipeline_decode=pipeline))
        ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
        pid = eng.register_prefix(prefix)
        reqs = ([eng.submit(p) for p in prompts]
                + [eng.submit(s, prefix=pid) for s in suffixes])
        _build.reset_launches()
        eng.start()
        try:
            outs = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
        assert eng.loop_error is None
        assert [r.status for r in reqs] == [Status.OK] * len(reqs)
        st = eng.stats()
        assert st["prefill_chunks"] == 5 + 7 + 1 and st["prefix_hits"] == 2
        assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
        name_k = "paged_decode_attention_int8kv" if kv == "int8" else "paged_decode_attention"
        assert _build.launches()[name_k] == (cfg.n_layers * st["decode_ticks"] if page else 0)
        if pipeline is None:
            assert eng.decode_graphs.replays == st["decode_ticks"]
        got[name] = outs
    assert got["graphs"] == got["eager"]
    assert all(len(o) == NEW for o in got["graphs"])


def _flush_inputs(dev):
    """Tokens, the active mask and caps of a flush over _admitted_state's
    slots: slot 1 stops at its cap of 2 inside the flush, slot 3 is idle."""
    return (torch.tensor([3, 4, 5, 0], dtype=torch.int32, device=dev),
            torch.tensor([True, True, True, False], device=dev),
            torch.tensor([4, 2, 4, 0], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "temperature"])
@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
def test_flush_replay_equals_k_eager_ticks(dev, page, temperature):
    """A 4-tick flush (decode_loop_k) captured as one graph: each replay
    gives, bit for bit, the tokens, counts, carry and logprobs of four
    eager sampled ticks of the port on generators with the same seeds (a
    lane leaves the eager ticks after its cap, as it freezes in the
    flush), and the same caches and lengths; the capture records one paged
    launch a layer a tick."""
    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=page, device=dev)
    eager_state = _admitted_state(model, params, page)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    k = 4
    flush = multi_tick_decode_step(model, temperature, 16, 1.0, True, k, -1)
    tick = sampled_decode_step(model, temperature, 16, 1.0, logprobs=True)
    gens_e = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    gens_g = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    b = 4
    inputs = (((b,), torch.int32), ((b,), torch.bool), ((b,), torch.int32))
    graphs = DecodeGraphs(flush, params, graph_state, gens_g, (128, 256), inputs=inputs,
                          sampled=temperature > 0.0)
    if page is not None:
        assert graphs.launches(256) == {"paged_decode_attention": k * cfg.n_layers}
    tokens, active, cap = _flush_inputs(dev)
    for bucket in (128, 256):
        (out, cnt, carry, lps), graph_state = graphs(params, graph_state, tokens, active, cap,
                                                     gens_g, bucket)
        tok, want, want_lps = tokens, [[] for _ in range(b)], [[] for _ in range(b)]
        caps = cap.tolist()
        for i in range(k):
            act = torch.tensor([bool(active[s]) and i < caps[s] for s in range(b)], device=dev)
            (nxt, lp), eager_state = tick(params, eager_state, tok, act, gens_e, bucket)
            for s in range(b):
                if act[s]:
                    want[s].append(int(nxt[s]))
                    want_lps[s].append(float(lp[s]))
            tok = torch.where(act, nxt, tok)
        torch.cuda.synchronize()
        assert cnt.tolist() == [len(w) for w in want] == [4, 2, 4, 0]
        for s in range(b):
            assert out[s, :cnt[s]].tolist() == want[s]
            assert lps[s, :cnt[s]].tolist() == want_lps[s]
            assert (out[s, cnt[s]:] == LOOP_PAD_TOKEN).all()
        assert carry.tolist()[:3] == [w[-1] for w in want[:3]]
        for key in eager_state:
            assert torch.equal(graph_state[key], eager_state[key]), key
        tokens = carry
    assert graphs.replays == 2


@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
def test_verify_replay_equals_eager_verify(dev, page):
    """The verify tick of spec_tokens 4 (T = 5) captured with the draft and
    caps as static buffers: a replay gives the eager step's pred and count
    and leaves the same caches and lengths, bit for bit; it launches the
    paged kernel once a layer (T = 5 <= 16 under auto)."""
    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=page, device=dev)
    eager_state = _admitted_state(model, params, page)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    step = verify_step(model)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    b, t = 4, 5
    inputs = (((b, t), torch.int32), ((b,), torch.bool), ((b,), torch.int32))
    graphs = DecodeGraphs(step, params, graph_state, gens, (128, 256), inputs=inputs, t=t)
    if page is not None:
        assert graphs.launches(128) == {"paged_decode_attention": cfg.n_layers}
        assert all(key[1] == "kernel" for key in graphs.keys())
    gen = torch.Generator(device=dev).manual_seed(7)
    active = torch.tensor([True, True, True, False], device=dev)
    cap = torch.tensor([5, 2, 5, 0], dtype=torch.int32, device=dev)
    for bucket in (128, 256):
        draft = torch.randint(1, DIMS["vocab"], (b, t), generator=gen, device=dev,
                              dtype=torch.int32)
        (pe, ce), eager_state = step(params, eager_state, draft, active, cap, gens, bucket)
        (pg, cg), graph_state = graphs(params, graph_state, draft, active, cap, gens, bucket)
        torch.cuda.synchronize()
        assert torch.equal(pe, pg) and torch.equal(ce, cg)
        assert cg[3] == 0 and 1 <= cg[1] <= 2
        for key in eager_state:
            assert torch.equal(graph_state[key], eager_state[key]), key


@pytest.mark.parametrize("page", [PAGE, None], ids=["paged", "dense"])
def test_fused_replay_equals_eager_fused_step(dev, page):
    """A fused speculation flush (4 inner verify ticks of spec_tokens 3)
    captured at depths 4 and 2: each replay equals the eager fused step at
    that depth bit for bit (token cube, counts, carry, caches)."""
    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=page, device=dev)
    eager_state = _admitted_state(model, params, page)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    step = fused_spec_decode_step(model, 4, 3, -1, 3)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    b, w = 4, 32
    inputs = (((b,), torch.int32), ((b,), torch.bool), ((b,), torch.int32),
              ((b, w), torch.int32), ((b,), torch.int32))
    graphs = {k: DecodeGraphs(functools.partial(step, k_dyn=k), params, graph_state, gens,
                              (256,), inputs=inputs, t=4) for k in (4, 2)}
    tokens, active, cap = _flush_inputs(dev)
    cap = torch.tensor([16, 3, 16, 0], dtype=torch.int32, device=dev)
    hist = torch.zeros((b, w), dtype=torch.int32, device=dev)
    hist[:, -8:] = torch.tensor([5, 6, 7, 8, 5, 6, 7, 8], dtype=torch.int32, device=dev)
    hlen = torch.tensor([8, 8, 8, 0], dtype=torch.int32, device=dev)
    for k in (4, 2):
        (oe, ce, re), eager_state = step(params, eager_state, tokens, active, cap, hist, hlen,
                                         gens, 256, k_dyn=k)
        (og, cg, rg), graph_state = graphs[k](params, graph_state, tokens, active, cap, hist,
                                              hlen, gens, 256)
        torch.cuda.synchronize()
        assert torch.equal(oe, og) and torch.equal(ce, cg) and torch.equal(re, rg)
        assert int(cg[1].sum()) <= 3 and (cg[:, k:] == 0).all()
        for key in eager_state:
            assert torch.equal(graph_state[key], eager_state[key]), key


def _plain_stream(params, cfg, prompt, steps):
    """The port's plain trunk (no kernel) greedy stream with each step's
    top-1/top-2 logit margin."""
    import dataclasses

    from vtpu_torch.models import decode_step, prefill

    plain = dataclasses.replace(cfg, use_kernels=False)
    logits, cache = prefill(params, plain, torch.from_numpy(prompt[None]).to(params["embed"].device))
    row, out, margins = logits[0, -1], [], []
    for _ in range(steps):
        top = torch.topk(row.float(), 2).values
        margins.append(float(top[0] - top[1]))
        out.append(int(torch.argmax(row)))
        logits, cache = decode_step(params, plain, cache, torch.tensor(
            [out[-1]], dtype=torch.int32, device=row.device))
        row = logits[0]
    return out, margins


@pytest.mark.parametrize("loop", ["device_loop", "spec", "fused", "fused_policy"])
def test_engine_loops_replay_their_graphs(dev, loop):
    """The multi-tick loop, unfused and fused speculation (with a LoopPolicy:
    one graph per depth) serve four prompts on graphs captured when the
    engine was built, none while serving: replays equal flushes (or verify
    and plain ticks), paged launches are n_layers x inner ticks, every
    state tensor keeps its address, and the streams equal the plain trunk's
    greedy stream up to a top-1/top-2 margin below 0.05 (bf16)."""
    from vtpu_torch.serving.shed import AdaptiveLoopPolicy

    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, DIMS["vocab"], (n,), generator=gen).numpy()
               for n in (9, 64, 33)] + [np.tile(np.arange(1, 7, dtype=np.int32), 6)]
    kw = {"device_loop": dict(decode_loop_k=4), "spec": dict(spec_tokens=3),
          "fused": dict(decode_loop_k=4, spec_tokens=3),
          "fused_policy": dict(decode_loop_k=4, spec_tokens=3,
                               loop_policy=AdaptiveLoopPolicy())}[loop]
    eng = ServingEngine(params, cfg, ServingConfig(slots=4, prefill_buckets=(64,),
                                                   max_new_tokens=NEW, kv_page=PAGE, **kw))
    captured = eng.stats()["graphs_captured"]
    assert captured == {"device_loop": 2, "spec": 4, "fused": 4, "fused_policy": 10}[loop]
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    reqs = [eng.submit(p) for p in prompts]
    _build.reset_launches()
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert eng.loop_error is None and [r.status for r in reqs] == [Status.OK] * 4
    st = eng.stats()
    assert st["graphs_captured"] == captured
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
    replays = sum(g.replays for g in eng._graph_sets())
    inner = st["decode_ticks"] + st["spec_ticks"]
    assert _build.launches()["paged_decode_attention"] == cfg.n_layers * inner
    if loop == "device_loop":
        assert replays == eng.loop_graphs.replays == st["loop_flushes"] > 0
    elif loop == "spec":
        assert eng.spec_graphs.replays == st["spec_ticks"] > 0
        assert eng.decode_graphs.replays == st["decode_ticks"]
    else:
        assert replays == st["loop_flushes"] and st["fused_flushes"] > 0
    for out, prompt in zip(outs, prompts):
        assert len(out) == NEW
        want, margins = _plain_stream(params, cfg, prompt, NEW)
        for got, ref, m in zip(out, want, margins):
            if m < 0.05:
                break
            assert got == ref


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_replay_after_an_in_place_swap_in_reads_the_restored_blocks(dev, kv):
    """Slot 0's blocks leave through the staging gather into pinned host
    memory and are zeroed in the pool; the staging scatter brings them back
    in place into four other blocks and the slot's table row is remapped in
    place. Replays of a graph captured before all this read the restored
    blocks: the live rows' tokens, the lengths and slot 0's pages equal the
    eager step's on a twin state that never swapped, bit for bit, and no
    state tensor moved. (Idle slot 3's stale row names slot 0's old first
    block, now zeroed: its masked-out token is junk either way.)"""
    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=PAGE, device=dev)
    eager_state = _admitted_state(model, params, PAGE)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    step = sampled_decode_step(model, 0.0, 0, 1.0)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    graphs = DecodeGraphs(step, params, graph_state, gens, (128, 256), paged_attn=None)
    ptrs = {k: x.data_ptr() for k, x in graph_state.items()}
    old = graph_state["table"][0, :4].long()
    new = torch.arange(40, 44, device=dev)
    snap = swap_page_gather(graph_state, old)
    host = {k: torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
            for k, x in snap.items()}
    for key in snap:
        graph_state[key].index_fill_(1, old, 0)
    swap_page_scatter(graph_state, new, {k: x.to(dev, non_blocking=True) for k, x in host.items()})
    graph_state["table"][0, :4].copy_(new.to(torch.int32))
    active = torch.tensor([True, True, True, False], device=dev)
    tok_e = tok_g = torch.tensor([3, 4, 5, 0], dtype=torch.int32, device=dev)
    for bucket in (128, 128, 256):
        tok_e, eager_state = step(params, eager_state, tok_e, active, gens, bucket)
        tok_g, graph_state = graphs(params, graph_state, tok_g, active, gens, bucket)
        torch.cuda.synchronize()
        assert torch.equal(tok_e[:3], tok_g[:3])
        assert torch.equal(graph_state["len"], eager_state["len"])
        for key in snap:
            assert torch.equal(graph_state[key][:, new], eager_state[key][:, old]), key
    assert graphs.replays == 3
    assert {k: x.data_ptr() for k, x in graph_state.items()} == ptrs


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_swap_round_trip_keeps_every_byte(dev, kv):
    """The engine's own swap path on the card, byte for byte. ``_spill``
    evicts four pool blocks to the pinned host tier while the main stream
    is still busy, so the side stream's copies must wait for the gathers
    or read unwritten snapshots. The released blocks are then overwritten
    on the main stream at once, from fresh tensors the size of the
    snapshots, which must not take the snapshots' memory while their
    copies run (``record_stream``). The main stream waits on the
    swap-out's event, as a resume racing its own swap-out does, and
    ``_restore_pages`` brings the pages back into four other blocks
    through the staging buffers, two blocks a group. Every KV plane,
    scale planes included, then equals what was evicted, byte for byte,
    and no state tensor moved."""
    from vtpu_torch.models.transformer import kv_keys

    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=PAGE, kv_pool_blocks=16,
        kv_swap=8, kv_swap_stage_blocks=2))
    assert eng._copy_stream is not None
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    old, new, host = [1, 2, 3, 4], [9, 10, 11, 12], [0, 1, 2, 3]
    idx = torch.tensor(old, device=dev)
    for key in kv_keys(eng.state):
        plane = eng.state[key]
        shape = plane[:, old].shape
        if plane.dtype == torch.int8:
            vals = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        else:
            vals = torch.randn(shape, generator=gen, device=dev).to(plane.dtype)
        plane.index_copy_(1, idx, vals)
    want = {key: eng.state[key][:, old].clone() for key in kv_keys(eng.state)}
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    done = eng._spill(old, host)
    junk = []
    for key in kv_keys(eng.state):
        plane = eng.state[key]
        for _ in range(2):
            junk.append(torch.full((2, plane.shape[0]) + tuple(plane.shape[2:]), 3,
                                   dtype=plane.dtype, device=dev))
        plane.index_fill_(1, idx, 3)
    torch.cuda.current_stream().wait_event(done)
    eng._restore_pages(new, host)
    torch.cuda.synchronize()
    assert done.query()
    for key, val in want.items():
        got = eng.state[key][:, new]
        assert torch.equal(got.view(torch.uint8), val.view(torch.uint8)), key
        assert not torch.equal(eng.state[key][:, old].view(torch.uint8), val.view(torch.uint8))
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs


def test_overcommit_engine_serves_on_its_graphs(dev):
    """kv_swap on the pipelined loop on graphs: the first request parks
    after its 2nd token, the second's admission evicts it to the pinned
    host tier (a pool of one request's 5 pages), and its resume swaps it
    back. Both streams equal, token for token, the streams of a twin engine
    without kv_swap that serves each request alone and never parks (the
    same kernels and graphs; a request is alone in the batch in both);
    they also equal the plain trunk's greedy streams up to a top-1/top-2
    margin below 0.05 (bf16). Replays = decode ticks, paged launches =
    n_layers x decode ticks, no graph captured while serving, every state
    tensor in place."""
    from vtpu_torch.serving import Terminal

    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, DIMS["vocab"], (64,), generator=gen).numpy() for _ in range(2)]
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=PAGE, kv_pool_blocks=5,
        kv_swap=8))
    captured = eng.stats()["graphs_captured"]
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    r1 = eng.submit(prompts[0])
    put, seen = r1.out.put, [0]

    def park_at_second(item):
        put(item)
        if not isinstance(item, Terminal):
            seen[0] += 1
            if seen[0] == 2:
                eng.park(r1)

    r1.out.put = park_at_second
    _build.reset_launches()
    eng.start()
    try:
        t0 = time.monotonic()
        while r1 not in eng._parked:
            assert time.monotonic() - t0 < 120, "the park never settled"
            time.sleep(0.002)
        r2 = eng.submit(prompts[1])
        out2 = list(r2.stream())
        eng.resume(r1)
        out1 = list(r1.stream())
    finally:
        eng.stop()
    assert eng.loop_error is None and r1.status == r2.status == Status.OK
    launches = _build.launches()["paged_decode_attention"]
    twin = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=PAGE, kv_pool_blocks=5))
    twin.start()
    try:
        alone = [list(twin.submit(p).stream()) for p in prompts]
    finally:
        twin.stop()
    assert twin.loop_error is None
    assert out1 == alone[0] and out2 == alone[1]
    for out, prompt in zip((out1, out2), prompts):
        assert len(out) == NEW
        want, margins = _plain_stream(params, cfg, prompt, NEW)
        for got, ref, m in zip(out, want, margins):
            if m < 0.05:
                break
            assert got == ref
    st = eng.stats()
    assert st["parks"] == st["resumes"] == st["swap_faults"] == 1
    assert st["evicted_blocks"] == 5 and st["swap_in_bytes"] == 5 * eng._block_bytes
    assert st["kv_pool_free"] == 5 and st["swap_host_free"] == 8
    assert st["graphs_captured"] == captured and eng.decode_graphs.replays == st["decode_ticks"]
    assert launches == cfg.n_layers * st["decode_ticks"]
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs


def test_lost_restore_rebuilds_in_the_swap_in_without_a_host_wait(dev):
    """swap_h2d_loss on the overcommit engine above: the parked request's
    restore is lost, so its swap-in dispatch rebuilds it through one prefill
    into the 128 bucket that covers its 66 tokens. That dispatch runs under
    ``set_sync_debug_mode("error")``, as every swap dispatch of an engine
    serving live streams must: a host wait in it raises and ends the loop.
    Both streams are held against the plain trunk's greedy streams up to a
    top-1/top-2 margin below 0.05 (bf16); one fault, one rebuild, both
    pools free."""
    from vtpu_torch.serving import FaultPlan, FaultSpec, Terminal

    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, DIMS["vocab"], (64,), generator=gen).numpy() for _ in range(2)]
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=4, prefill_buckets=(64, 128), max_new_tokens=NEW, kv_page=PAGE, kv_pool_blocks=5,
        kv_swap=8, faults=FaultPlan([FaultSpec("swap_h2d_loss")])))
    swap_in, rebuilds = eng._swap_in, []

    def guarded(slot, e):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return swap_in(slot, e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            rebuilds.append(e["dropped"])

    eng._swap_in = guarded
    r1 = eng.submit(prompts[0])
    put, seen = r1.out.put, [0]

    def park_at_second(item):
        put(item)
        if not isinstance(item, Terminal):
            seen[0] += 1
            if seen[0] == 2:
                eng.park(r1)

    r1.out.put = park_at_second
    eng.start()
    try:
        t0 = time.monotonic()
        while r1 not in eng._parked:
            assert time.monotonic() - t0 < 120, "the park never settled"
            time.sleep(0.002)
        r2 = eng.submit(prompts[1])
        out2 = list(r2.stream())
        eng.resume(r1)
        out1 = list(r1.stream())
    finally:
        eng.stop()
    assert eng.loop_error is None and r1.status == r2.status == Status.OK
    assert rebuilds == [True]
    for out, prompt in zip((out1, out2), prompts):
        assert len(out) == NEW
        want, margins = _plain_stream(params, cfg, prompt, NEW)
        for got, ref, m in zip(out, want, margins):
            if m < 0.05:
                break
            assert got == ref
    st = eng.stats()
    assert st["faults_injected"] == st["fault_recomputes"] == st["swap_faults"] == 1
    assert st["evicted_blocks"] == 5 and st["swap_in_bytes"] == 0
    assert st["kv_pool_free"] == 5 and st["swap_host_free"] == 8


def _held_streams(outs, twins, params, cfg, prompts):
    """Each stream equals its twin's and the plain trunk's greedy stream, token
    for token, up to the trunk's first top-1/top-2 margin below 0.05 (bf16:
    the gather and kernel routes round differently only there)."""
    for out, twin, prompt in zip(outs, twins, prompts):
        assert len(out) == len(twin) == NEW
        want, margins = _plain_stream(params, cfg, prompt, NEW)
        for got, tw, ref, m in zip(out, twin, want, margins):
            if m < 0.05:
                break
            assert got == tw == ref


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_watchdog_switches_route_between_captured_graph_sets(dev, kv):
    """The watchdog's second rung on graphs: the engine captures its tick on
    the kernel and the gather route when it is built (the gather set records
    no paged launch); a stalled fetch (delayed_fetch, 0.75 s against a
    500 ms threshold) moves the replays to the gather set and the recovery
    back, with no capture while serving and every state tensor at its
    address. Replays split between the sets as the ticks the stats count on
    each route, paged launches = n_layers x kernel replays, and the streams
    equal a never-degraded engine's."""
    from vtpu_torch.serving import FaultPlan, FaultSpec

    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, DIMS["vocab"], (n,), generator=gen).numpy() for n in (9, 64, 33)]
    base = dict(slots=4, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=PAGE)
    eng = ServingEngine(params, cfg, ServingConfig(
        **base, fetch_watchdog_ms=500.0, fetch_watchdog_recover_ms=1.0,
        faults=FaultPlan([FaultSpec("delayed_fetch", at=2, arg=0.75)])))
    captured = eng.stats()["graphs_captured"]
    assert captured == 4  # the tick on two routes, two kv buckets each
    kern, gath = eng.route_graphs[None]["step"], eng.route_graphs["gather"]["step"]
    assert eng.decode_graphs is kern and eng._step is kern
    paged = "paged_decode_attention_int8kv" if kv == "int8" else "paged_decode_attention"
    for bkt in (64, 256):
        assert kern.launches(bkt) == {paged: cfg.n_layers}
        assert gath.launches(bkt) == {}
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    _build.reset_launches()
    eng.start()
    try:
        outs = [list(eng.submit(p).stream()) for p in prompts]
    finally:
        eng.stop()
    assert eng.loop_error is None
    st = eng.stats()
    assert st["watchdog_degrades"] == st["watchdog_recoveries"] == 1
    assert [e["event"] for e in eng.trace.events()
            if e["event"] in ("degrade", "recover")] == ["degrade", "recover"]
    assert kern.replays > 0 and gath.replays > 0
    assert kern.replays + gath.replays == st["decode_ticks"]
    assert (st["paged_attn_kernel_ticks"], st["paged_attn_gather_ticks"]) == (
        kern.replays, gath.replays)
    assert _build.launches()[paged] == cfg.n_layers * kern.replays
    assert st["graphs_captured"] == captured
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
    assert eng._paged_attn is None and eng._step is kern
    twin = ServingEngine(params, cfg, ServingConfig(**base))
    twin.start()
    try:
        twins = [list(twin.submit(p).stream()) for p in prompts]
    finally:
        twin.stop()
    _held_streams(outs, twins, params, cfg, prompts)


def test_watchdog_rung1_replays_the_one_token_flush(dev):
    """The watchdog's first rung dispatches a one-token flush captured when
    the engine was built (a capped k-token flush would still run its k inner
    ticks on the device). Its replay equals, bit for bit, a 4-tick flush
    capped at one token (token, count, carry, caches and lengths); on the
    engine a stalled fetch moves every later flush to it (one-way here), the
    flushes and inner ticks split between the two graphs as counted, with
    no capture while serving, and the streams equal a never-degraded
    engine's."""
    from vtpu_torch.serving import FaultPlan, FaultSpec

    cfg = _cfg("bf16")
    params = init_params(0, cfg, device=dev)
    model = TransformerSlotModel(params, cfg, kv_page=PAGE, device=dev)
    state = _admitted_state(model, params, PAGE)
    states = [state, {k: x.clone() for k, x in state.items()}]
    b = 4
    inputs = (((b,), torch.int32), ((b,), torch.bool), ((b,), torch.int32))
    gens = [[torch.Generator(device=dev).manual_seed(i) for i in range(b)] for _ in range(2)]
    flushes = [DecodeGraphs(multi_tick_decode_step(model, 0.0, 0, 1.0, False, k, -1), params,
                            st, g, (128, 256), inputs=inputs)
               for k, st, g in zip((4, 1), states, gens)]
    tokens = torch.tensor([3, 4, 5, 0], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    one = torch.ones((b,), dtype=torch.int32, device=dev)
    for bucket in (128, 256):
        (o4, c4, carry4, _), _ = flushes[0](params, states[0], tokens, active, one, gens[0], bucket)
        (o1, c1, carry1, _), _ = flushes[1](params, states[1], tokens, active, one, gens[1], bucket)
        torch.cuda.synchronize()
        assert torch.equal(o4[:, :1], o1) and torch.equal(c4, c1) and torch.equal(carry4, carry1)
        assert c1.tolist() == [1, 1, 1, 0]
        for key in states[0]:
            assert torch.equal(states[0][key], states[1][key]), key
        tokens = carry1
    assert flushes[1].launches(256) == {"paged_decode_attention": cfg.n_layers}

    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(1, DIMS["vocab"], (n,), generator=gen).numpy() for n in (9, 64, 33)]
    base = dict(slots=4, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=PAGE,
                decode_loop_k=4)
    eng = ServingEngine(params, cfg, ServingConfig(
        **base, fetch_watchdog_ms=500.0,
        faults=FaultPlan([FaultSpec("delayed_fetch", at=1, arg=0.75)])))
    captured = eng.stats()["graphs_captured"]
    assert captured == 8  # the 4-tick and 1-tick flushes on two routes, two buckets each
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    reqs = [eng.submit(p) for p in prompts]
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    assert eng.loop_error is None
    st = eng.stats()
    assert st["watchdog_degrades"] == 1 and eng._loop_cap == 1
    assert eng.loop1_graphs.replays > 0
    assert eng.loop_graphs.replays + eng.loop1_graphs.replays == st["loop_flushes"]
    assert 4 * eng.loop_graphs.replays + eng.loop1_graphs.replays == st["decode_ticks"]
    assert st["graphs_captured"] == captured
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
    twin = ServingEngine(params, cfg, ServingConfig(**base))
    twin_reqs = [twin.submit(p) for p in prompts]
    twin.start()
    try:
        twins = [list(r.stream()) for r in twin_reqs]
    finally:
        twin.stop()
    _held_streams(outs, twins, params, cfg, prompts)


# ------------------------------------------------- the MoE and SSM families

MOE_DIMS = dict(vocab=512, d_model=256, n_heads=2, n_layers=2, d_ff=256, n_experts=4,
                top_k=2, max_seq=256, head_dim=128)
SSM_DIMS = dict(vocab=512, d_model=256, n_layers=2, d_state=16)


def _family(dev, family, kv="bf16", page=None):
    """(params, adapter) of a small bf16 MoE or SSM model on the card."""
    if family == "moe":
        cfg = MoEConfig(**MOE_DIMS, dtype=torch.bfloat16, kv_int8=kv == "int8")
        params = init_moe_params(0, cfg, device=dev)
        return params, MoeSlotModel(params, cfg, kv_page=page, device=dev)
    cfg = SSMConfig(**SSM_DIMS, dtype=torch.bfloat16)
    params = init_ssm_params(0, cfg, device=dev)
    return params, SsmSlotModel(params, cfg, device=dev)


@pytest.mark.parametrize("family,kv,page", [("moe", "bf16", PAGE), ("moe", "int8", PAGE),
                                            ("moe", "bf16", None), ("ssm", "bf16", None)])
def test_family_replay_equals_eager_step(dev, family, kv, page):
    """An MoE (paged bf16 and int8, dense) and an SSM decode step, sampled
    on the device: each replay equals the eager step bit for bit (tokens
    and every state tensor), slot 3 inactive (its SSM state unchanged)."""
    params, model = _family(dev, family, kv, page)
    eager_state = _admitted_state(model, params, page)
    graph_state = {k: x.clone() for k, x in eager_state.items()}
    step = sampled_decode_step(model, 0.0, 0, 1.0)
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
    buckets = (128, 256) if family == "moe" else (0,)
    graphs = DecodeGraphs(step, params, graph_state, gens, buckets)
    idle = {k: x[:, 3].clone() for k, x in eager_state.items()} if family == "ssm" else {}
    active = torch.tensor([True, True, True, False], device=dev)
    tok_e = tok_g = torch.tensor([3, 4, 5, 0], dtype=torch.int32, device=dev)
    for bucket in (buckets * 3)[:3]:
        tok_e, eager_state = step(params, eager_state, tok_e, active, gens, bucket)
        tok_g, graph_state = graphs(params, graph_state, tok_g, active, gens, bucket)
        torch.cuda.synchronize()
        assert torch.equal(tok_e, tok_g)
        for key in eager_state:
            assert torch.equal(graph_state[key], eager_state[key]), key
    for key, x in idle.items():
        assert torch.equal(graph_state[key][:, 3], x), key
    assert graphs.replays == 3
    if family == "ssm":
        assert graphs.keys() == [(0, "dense", "ssm")]


def _moe_plain_stream(params, cfg, prompt, steps):
    """The MoE plain trunk's (no kernel, a dense cache) greedy stream with
    each step's top-1/top-2 logit margin."""
    from vtpu_torch.models.moe import moe_decode_ffn, moe_prefill
    from vtpu_torch.serving.engine import batched_decode_step

    plain = dataclasses.replace(cfg, use_kernels=False)
    dev = params["embed"].device
    logits, cache = moe_prefill(params, plain, torch.from_numpy(prompt[None]).to(dev))
    row, out, margins = logits[0, -1], [], []
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    for _ in range(steps):
        top = torch.topk(row.float(), 2).values
        margins.append(float(top[0] - top[1]))
        out.append(int(torch.argmax(row)))
        logits, cache = batched_decode_step(
            params, plain, cache, torch.tensor([out[-1]], dtype=torch.int32, device=dev),
            active, ffn_fn=moe_decode_ffn(plain))
        row = logits[0]
    return out, margins


@pytest.mark.parametrize("family,loop", [("moe", {}), ("moe", {"decode_loop_k": 4}),
                                         ("moe", {"spec_tokens": 3}),
                                         ("moe", {"decode_loop_k": 4, "spec_tokens": 3}),
                                         ("ssm", {}), ("ssm", {"decode_loop_k": 4})])
def test_family_engines_on_graphs_stream_what_the_eager_loop_streams(dev, family, loop):
    """ServingEngine(model=...) of each family on its graphs, captured when
    it is built (one kv bucket for the SSM, every one for MoE, the verify
    and fused sets on the speculating loops), against the same adapter on
    the synchronous eager loop without graphs: the same streams; one replay
    a dispatch, nothing captured while serving, every state tensor in place;
    MoE: paged launches = n_layers x inner ticks and flash at admission,
    the SSM none."""
    params, model = _family(dev, family, page=PAGE if family == "moe" else None)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 512, (n,), generator=gen).numpy() for n in (9, 64, 33, 17)]
    serving = ServingConfig(slots=4, prefill_buckets=(64,), max_new_tokens=NEW)
    eng = ServingEngine(model=model, serving=dataclasses.replace(serving, **loop))
    captured = eng.stats()["graphs_captured"]
    assert captured == (len(eng._kv_buckets) * (2 if "spec_tokens" in loop else 1)
                        if family == "moe" else 1)
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    reqs = [eng.submit(p) for p in prompts]
    _build.reset_launches()
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    launches = _build.launches()
    assert eng.loop_error is None
    st = eng.stats()
    if "spec_tokens" in loop:
        # a verify chunk of T = 4 rounds otherwise than T = 1 ticks: held
        # against the plain trunk under the bf16 margin rule
        for out, prompt in zip(outs, prompts):
            want, margins = _moe_plain_stream(params, model.cfg, prompt, NEW)
            for got, ref, m in zip(out, want, margins):
                if m < 0.05:
                    break
                assert got == ref
    else:
        twin = ServingEngine(model=model, serving=dataclasses.replace(
            serving, pipeline_decode=False))
        assert twin._graph_sets() == []  # the synchronous loop runs eagerly
        twin_reqs = [twin.submit(p) for p in prompts]
        twin.start()
        try:
            assert [list(r.stream()) for r in twin_reqs] == outs
        finally:
            twin.stop()
    assert st["graphs_captured"] == captured
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
    inner = st["decode_ticks"] + st["spec_ticks"]
    dispatches = st["loop_flushes"] if "decode_loop_k" in loop else inner
    assert sum(g.replays for g in eng._graph_sets()) == dispatches
    if family == "moe":
        assert launches["paged_decode_attention"] == model.cfg.n_layers * inner
        assert launches["flash_attention"] > 0
    else:
        assert sum(launches.values()) == 0


# the serving flagship SSM's widths (chip_smoke.py's SSM_FLAGSHIP)
SSM_WIDE = dict(vocab=8192, d_model=1024, n_layers=12, d_state=16)
# chip_smoke.py's FORCED_MARGIN: the logit margin under which its greedy
# check stops holding a token
PAIR_DRIFT = 0.125


def test_ssm_admission_in_a_pair_matches_one_row(dev):
    """Six prompts of 600-1024 tokens at the flagship SSM's widths, each
    admitted into a four-slot state in a [2, 1024] batch beside another
    prompt and in a [1, 1024] batch alone (the engine's two admission
    sizes), then decoded four slots a step as the engine decodes: the first
    token's logits and those of 15 decode steps fed the same greedy tokens
    stay within PAIR_DRIFT of each other. When _selective_mix's skinny
    x_proj product (33 columns over 2048) ran as a bf16 GEMM, cuBLAS split
    it at the pair's shape and reduced the partial sums in bf16: one
    prompt's logits then moved by 2.4 and its greedy tokens flipped at
    margins up to 0.83, so a stream's tokens hung on which prompts the
    engine happened to admit together."""
    cfg = SSMConfig(**SSM_WIDE, dtype=torch.bfloat16)
    params = init_ssm_params(0, cfg, device=dev)
    model = SsmSlotModel(params, cfg, device=dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rs.randint(600, 1025, 6)]

    def admit(rows):
        """rows into slots 0.. of a four-slot state, as the engine admits."""
        padded = np.zeros((len(rows), 1024), np.int32)
        for j, p in enumerate(rows):
            padded[j, :len(p)] = p
        state = model.init_state(4)
        last, state = model.prefill_into_slots(
            params, state, torch.from_numpy(padded).to(dev),
            torch.arange(len(rows), device=dev),
            torch.tensor([len(p) for p in rows], device=dev))
        return last, state

    def step(state, tok, n):
        active = torch.arange(4, device=dev) < n
        logits, state = model.decode_step(params, state, tok.repeat(4), active, 0)
        return logits[0], state

    drift = []
    for i, p in enumerate(prompts):
        last1, alone = admit([p])
        last2, pair = admit([p, prompts[(i + 1) % len(prompts)]])
        row1, row2, worst = last1[0], last2[0], 0.0
        for _ in range(16):
            worst = max(worst, float((row2 - row1).abs().max()))
            tok = torch.argmax(row1).to(torch.int32).reshape(1)
            row1, alone = step(alone, tok, 1)
            row2, pair = step(pair, tok, 2)
        drift.append(worst)
    assert max(drift) <= PAIR_DRIFT, drift


def test_moe_routing_captures_under_sync_debug_error(dev):
    """route and moe_ffn with drops (capacity factor 0.5) and a pad mask,
    captured in one CUDA graph under set_sync_debug_mode("error"): the
    one-hots are comparisons with an arange and read nothing back; the
    replay equals the eager call bit for bit, a dropped choice's row zero."""
    cfg = MoEConfig(**{**MOE_DIMS, "capacity_factor": 0.5}, dtype=torch.bfloat16)
    params = init_moe_params(0, cfg, device=dev)
    lp = {k: v[0] for k, v in params["layers"].items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.arange(64, device=dev)[None, :] < torch.tensor([[64], [40]], device=dev)
    cap = cfg.capacity(128)

    def run():
        d, c, _ = route(lp["router"], x.reshape(128, -1), cfg, cap)
        out, _ = moe_ffn(lp, x, cfg, pad_mask=mask)
        return d, c, out

    want = run()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        run()  # warm-up outside the capture
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.capture_begin()
            got = run()
            graph.capture_end()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[0].sum()) < 128 * cfg.top_k  # the tight capacity dropped choices


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_disagg_worker_stream_beside_replays(dev, kv):
    """A disaggregated engine on graphs: its graphs are captured once, when
    it is built, and none while it serves; its prefill worker chunks on a
    CUDA stream of its own beside the loop's replays, and every stream
    equals the plain trunk's up to a top-1/top-2 margin below 0.05, with
    handoff_copies 0, replays = decode ticks and paged launches = n_layers
    x decode ticks. The pool holds two requests, so each later claim takes
    blocks a retire released; every release on the loop thread is
    followed, on the loop's stream and behind a device sleep, by a poison
    of those blocks (a late tick's write): a worker that wrote a reserved
    block before its stream waited for the loop's would lose its KV to the
    poison, and its stream would part from the plain trunk."""
    from vtpu_torch.models.transformer import kv_keys
    from vtpu_torch.serving import DisaggConfig

    cfg = _cfg(kv)
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(1, DIMS["vocab"], (48,), generator=gen).numpy() for _ in range(5)]
    per = -(-(48 + NEW) // PAGE)
    eng = ServingEngine(params, cfg, ServingConfig(
        slots=2, prefill_buckets=(64,), max_new_tokens=NEW, kv_page=PAGE, prefill_chunk=32,
        kv_pool_blocks=2 * per, disagg=DisaggConfig(min_prefill_tokens=32,
                                                     max_prefill_tokens=64)))
    captured = eng.stats()["graphs_captured"]
    assert captured > 0
    ptrs = {k: x.data_ptr() for k, x in eng.state.items()}
    release, poisoned = eng._alloc.release, []

    def poison_after(blocks):
        release(blocks)
        if blocks and threading.current_thread() is eng._thread:
            torch.cuda._sleep(int(2e6))  # ~1 ms of the loop's stream
            idx = torch.tensor(blocks, device=dev)
            for key in kv_keys(eng.state):
                eng.state[key].index_fill_(1, idx, 7)
            poisoned.append(len(blocks))

    eng._alloc.release = poison_after
    _build.reset_launches()
    reqs = [eng.submit(p) for p in prompts]
    eng.start()
    try:
        outs = [list(r.stream()) for r in reqs]
    finally:
        eng.stop()
    st = eng.stats()
    launches = _build.launches()
    assert eng.loop_error is None and all(r.status == Status.OK for r in reqs)
    # every retire poisoned its blocks, and five requests of `per` blocks
    # in a pool of 2 x per took blocks released before them
    assert poisoned == [per] * 5 and sum(poisoned) > st["kv_pool_blocks"]
    for out, prompt in zip(outs, prompts):
        assert len(out) == NEW
        want, margins = _plain_stream(params, cfg, prompt, NEW)
        for got, ref, m in zip(out, want, margins):
            if m < 0.05:
                break
            assert got == ref
    paged = "paged_decode_attention_int8kv" if kv == "int8" else "paged_decode_attention"
    assert st["handoffs"] == 5 and st["handoff_copies"] == 0
    assert st["graphs_captured"] == captured and eng.decode_graphs.replays == st["decode_ticks"]
    assert launches[paged] == cfg.n_layers * st["decode_ticks"]
    assert launches["flash_attention"] == 0  # the worker's chunks take the plain route
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert {k: x.data_ptr() for k, x in eng.state.items()} == ptrs
