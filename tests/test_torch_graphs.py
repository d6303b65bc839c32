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
ticks."""

import ctypes

import pytest
import torch

from vtpu_torch.models import ModelConfig, init_params
from vtpu_torch.ops import _build
from vtpu_torch.ops.decode_attn import paged_decode_attention, paged_split_plan
from vtpu_torch.serving import ServingConfig, ServingEngine, Status, TransformerSlotModel
from vtpu_torch.serving.adapters import sampled_decode_step
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
