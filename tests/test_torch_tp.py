"""vtpu_torch tensor-parallel serving against vtpu's tensor-parallel engine
on the same weights (CPU, f32, gloo).

The reference serves TP from one controller over a ('tp',) Mesh of
virtual CPU devices; the port runs one spawned process per rank over
torch.distributed (gloo, a ``file://`` store under tmp_path, a join
timeout on every world). The reference's own TP test config
(tests/test_paged_kv_tp.py: vocab 64, d_model 32, 4 heads, 2 layers, f32,
page 8) with weights from ``vtpu.models.init_params`` (key 0).

Held: streams token-equal to the JAX TP engine's and to the port's
single-device engine's at tp 2 and 4 (dense and paged, f32 and int8 KV,
the gather and the kernel route; on the CPU the kernel route runs the
head-local plain version); tp=2 teacher-forced logits within 1e-4 of the
JAX TP adapter's; each head-shard call of both paged wrappers (the
counterpart of the reference's ``_shard_body``) equal to the head slice of
the JAX single-chip kernel in interpret mode at atol 2e-5. The JAX TP
kernel route raises on the installed jax (``check_rep``; ROADMAP Queue 3),
which is why the head-shard calls are held against the single-chip kernel.
"""

import dataclasses
import multiprocessing
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.ops.decode_attn import (
    paged_decode_attention as j_paged_decode_attention,
    paged_decode_attention_int8kv as j_paged_decode_attention_int8kv,
)
from vtpu.parallel.mesh import make_axis_mesh
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import TransformerSlotModel as JTransformerSlotModel
from vtpu_torch.convert import params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.ops import _build, paged_decode_attention, paged_decode_attention_int8kv
from vtpu_torch.parallel import TpMesh, all_reduce_sum, head_shard, make_tp_mesh, shard_params
from vtpu_torch.parallel.launch import Run, forced_decode_logits, launch_tp, serve_requests
from vtpu_torch.serving import ServingConfig, ServingEngine, Status, TransformerSlotModel
from vtpu_torch.serving.engine import choose_kv_int8

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32, head_dim=8)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
NEW = 6
LAYOUTS = {"dense": {}, "paged_gather": {"kv_page": PAGE, "paged_attn": "gather"},
           "paged_kernel": {"kv_page": PAGE, "paged_attn": "kernel"}}
RUNS = [(kv, layout) for kv in ("f32", "int8") for layout in LAYOUTS]
WORLD_TIMEOUT_S = 120


def _serving(layout, cls=ServingConfig):
    return cls(slots=2, prefill_buckets=(8,), max_new_tokens=NEW, **LAYOUTS[layout])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The reference's params (one set serves both KV types: the widths are
    equal) and their float32 numpy tree."""
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    return jp, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, DIMS["vocab"], (n,)).astype(np.int32) for n in (5, 7, 3)]


@pytest.fixture(scope="module")
def port_tp(weights, prompts, tmp_path_factory):
    """The port's TP worlds (tp 2, then 4, every run of RUNS each), run in
    the background so they overlap the reference's compiles; one world at
    a time, so the file never holds more than five busy processes."""
    _, tree = weights
    store = tmp_path_factory.mktemp("tp_store")
    runs = [Run(CFGS[kv], _serving(layout), prompts, NEW) for kv, layout in RUNS]
    out: dict = {}

    def worlds():
        for tp in (2, 4):
            try:
                out[tp] = launch_tp(serve_requests, tp, "gloo", ["cpu"] * tp,
                                    f"file://{store}/serve{tp}",
                                    args=([tree] * len(runs), runs),
                                    timeout=WORLD_TIMEOUT_S)
            except Exception as exc:  # handed to the tests that read this world
                out[tp] = exc

    thread = threading.Thread(target=worlds, daemon=True)
    thread.start()

    def get(tp):
        thread.join(timeout=2 * WORLD_TIMEOUT_S + 60)
        res = out.get(tp)
        if isinstance(res, Exception) or res is None:
            raise AssertionError(f"the tp={tp} world failed: {res!r}")
        return res

    return get


@pytest.fixture(scope="module")
def jax_tp_streams(weights, prompts, port_tp):
    """The reference TP engine's streams, paged on its gather route (its
    kernel route raises on the installed jax), per (tp, KV type)."""
    jp, _ = weights
    out = {}
    for tp in (2, 4):
        for kv in ("f32", "int8"):
            eng = JServingEngine(jp, JCFGS[kv], _serving("paged_gather", JServingConfig),
                                 mesh=make_axis_mesh("tp", tp))
            eng.start()
            try:
                reqs = [eng.submit(p.tolist(), max_new_tokens=NEW) for p in prompts]
                out[tp, kv] = [list(r.stream()) for r in reqs]
            finally:
                eng.stop()
    return out


@pytest.fixture(scope="module")
def port_single(weights, prompts):
    """The port's single-device streams and stats per run of RUNS."""
    _, tree = weights
    out = {}
    for kv, layout in RUNS:
        eng = ServingEngine(params_from_numpy(tree, CFGS[kv], device="cpu"), CFGS[kv],
                            _serving(layout), device="cpu")
        eng.start()
        try:
            reqs = [eng.submit(p) for p in prompts]
            out[kv, layout] = [list(r.stream()) for r in reqs], eng.stats()
        finally:
            eng.stop()
    return out


# ------------------------------------------------------------- streams


@pytest.mark.parametrize("kv,layout", RUNS)
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_streams_match_jax_tp_engine(port_tp, jax_tp_streams, port_single, tp, kv, layout):
    """Three prompts through two slots (slot reuse over reallocated blocks):
    the port's TP streams equal the reference TP engine's and the port's
    single-device streams; every rank holds its n_heads / tp heads of the
    cache or pool; the route ran every tick; the pool drains free; stats
    report tp and per-card KV bytes (the single-device bytes / tp)."""
    ranks = [res[RUNS.index((kv, layout))] for res in port_tp(tp)]
    lead = ranks[0]
    single, single_stats = port_single[kv, layout]
    assert lead["streams"] == jax_tp_streams[tp, kv] == single
    assert lead["statuses"] == [Status.OK] * 3
    st = lead["stats"]
    assert st["tp"] == tp and st["device_gets_per_tick"] == 1.0
    assert st["kv_hbm_bytes_per_chip"] == st["kv_hbm_bytes"]
    for key in ("dense", "paged"):
        want = single_stats["kv_hbm_bytes"][key]
        assert st["kv_hbm_bytes"][key] == (None if want is None else want // tp)
    heads = DIMS["n_heads"] // tp
    assert all(r["kv_shape"][3] == heads for r in ranks)
    if layout == "dense":
        assert st["kv_pool_blocks"] is None
        return
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    route = layout.split("_")[1]
    assert st[f"paged_attn_{route}_ticks"] == st["decode_ticks"] > 0
    # on the CPU the kernel route runs the plain version: no launch counted
    assert all(not any(r["launches"].values()) for r in ranks)


# ------------------------------------------------------- teacher-forced


def _auto_shapes():
    """(slots, max_seq, verdict) of the first shape of each verdict the
    port's router gives on the paged pool, fewest slots and shortest
    window first."""
    first = {}
    for slots in (2, 16, 64):
        for window in (DIMS["max_seq"], 1024, 2048):
            first.setdefault(choose_kv_int8(slots, window, paged=True), (slots, window))
    return [(*shape, verdict) for verdict, shape in sorted(first.items())]


def test_tp_kv_int8_auto_resolves_on_every_rank(weights, prompts, tmp_path):
    """ModelConfig(kv_int8="auto") at tp=2 through launch_tp: rank 0's
    engine and rank 1's follower each build the adapter through the same
    resolution of (slots, max_seq), so both ranks' configs carry
    choose_kv_int8's bool and their KV planes its dtype, for each verdict
    the router gives; the streams equal the JAX TP engine's (gather route)
    built with that same bool."""
    jp, tree = weights
    shapes = _auto_shapes()
    auto = dataclasses.replace(CFGS["f32"], kv_int8="auto")

    def serving(slots, cls=ServingConfig):
        return cls(slots=slots, prefill_buckets=(8,), max_new_tokens=NEW, kv_page=PAGE,
                   kv_pool_blocks=8, paged_attn="gather")

    runs = [Run(dataclasses.replace(auto, max_seq=window), serving(slots), prompts, NEW,
                hook="torch_tp_hooks:kv_dtype") for slots, window, _ in shapes]
    ranks = launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], f"file://{tmp_path}/store",
                      args=([tree] * len(runs), runs), timeout=WORLD_TIMEOUT_S)
    for i, (slots, window, verdict) in enumerate(shapes):
        dtype = str(torch.int8 if verdict else torch.float32)
        assert [(r[i]["kv_int8"], r[i]["kv_dtype"]) for r in ranks] == [(verdict, dtype)] * 2
        eng = JServingEngine(jp, dataclasses.replace(JCFGS["f32"], max_seq=window,
                                                     kv_int8=verdict),
                             serving(slots, JServingConfig), mesh=make_axis_mesh("tp", 2))
        eng.start()
        try:
            reqs = [eng.submit(p.tolist(), max_new_tokens=NEW) for p in prompts]
            want = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
        assert ranks[0][i]["streams"] == want, (slots, window, verdict)


def test_tp_teacher_forced_logits_match_jax(weights, tmp_path):
    """The same token stream forced through the paged tp=2 cache of both
    packages: per-step logits within 1e-4 (catches a divergence greedy
    equality can hide behind an argmax fork). The port's table write for
    slot 0 is made on rank 0 outside any adapter call, as the engine's
    reservation is, and reaches rank 1 with the next call."""
    jp, tree = weights
    prompt = [int(t) for t in np.random.RandomState(7).randint(1, 64, 9)]
    forced = [int(t) for t in np.random.RandomState(8).randint(1, 64, 4)]
    got = launch_tp(forced_decode_logits, 2, "gloo", ["cpu"] * 2, f"file://{tmp_path}/store",
                    args=(tree, CFGS["f32"], PAGE, prompt, forced),
                    timeout=WORLD_TIMEOUT_S)[0]

    model = JTransformerSlotModel(jp, JCFGS["f32"], mesh=make_axis_mesh("tp", 2), kv_page=PAGE)
    state = dict(model.init_state(2))
    state["table"] = state["table"].at[0].set(
        jnp.arange(1, state["table"].shape[1] + 1, dtype=jnp.int32))
    padded = jnp.zeros((1, 16), jnp.int32).at[0, :9].set(jnp.asarray(prompt, jnp.int32))
    _, state = jax.jit(model.prefill_into_slot)(model.params, state, padded, jnp.int32(0),
                                                jnp.int32(9))
    step = jax.jit(model.decode_step, static_argnames=("kv_bucket", "unroll"))
    act = jnp.asarray([True, False])
    for i, tok in enumerate(forced):
        logits, state = step(model.params, state, jnp.asarray([tok, 0], jnp.int32), act, 16,
                             unroll=True)
        np.testing.assert_allclose(got[i], np.asarray(logits[0]), atol=1e-4)


# ------------------------------------------- row 4: the head-shard call


def _pool_case(kv):
    rng = np.random.RandomState(3)
    shape = (2, 9, PAGE, 4, 16)
    if kv == "int8":
        k, v = (rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = ((rng.rand(*shape[:4]) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
        k[:, 0], v[:, 0], ks[:, 0], vs[:, 0] = 127, -127, 1e3, 1e3  # the null block
    else:
        k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        k[:, 0], v[:, 0] = 1e3, -1e3
        ks = vs = None
    q = rng.randn(3, 3, 4, 16).astype(np.float32)
    table = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], np.int32)
    lens = np.asarray([[9, 10, 11], [19, 20, 21], [30, 31, 32]], np.int32)
    return q, k, ks, v, vs, table, lens


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_head_shard_kernel_call_matches_jax_single_chip(kv, tp):
    """``paged_decode_attention[_int8kv](..., mesh=)`` on each rank's head
    shard of q and the pools (scale pools too) equals the head slice of
    the JAX single-chip kernel (interpret mode) at both layer planes; on
    the CPU it runs the plain version and counts no launch."""
    q, k, ks, v, vs, table, lens = _pool_case(kv)
    before = _build.launches()
    for layer in (0, 1):
        if kv == "int8":
            want = np.asarray(j_paged_decode_attention_int8kv(
                *(jnp.asarray(x) for x in (q, k, ks, v, vs, table, lens)), layer=layer,
                interpret=True))
        else:
            want = np.asarray(j_paged_decode_attention(
                *(jnp.asarray(x) for x in (q, k, v, table, lens)), layer=layer,
                interpret=True))
        for rank in range(tp):
            mesh = TpMesh(rank=rank, size=tp, device=torch.device("cpu"))
            qs, kp, vp = (torch.from_numpy(head_shard(x, ax, mesh))
                          for x, ax in ((q, -2), (k, -2), (v, -2)))
            tab, kvl = torch.from_numpy(table), torch.from_numpy(lens)
            if kv == "int8":
                ksp, vsp = (torch.from_numpy(head_shard(x, -1, mesh)) for x in (ks, vs))
                got = paged_decode_attention_int8kv(qs, kp, ksp, vp, vsp, tab, kvl, layer,
                                                    mesh=mesh)
            else:
                got = paged_decode_attention(qs, kp, vp, tab, kvl, layer, mesh=mesh)
            np.testing.assert_allclose(got.numpy(), head_shard(want, -2, mesh), atol=2e-5)
    assert _build.launches() == before
    whole = torch.from_numpy(k if kv == "f32" else k.astype(np.float32))
    mesh = TpMesh(rank=0, size=tp, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="head shard"):
        # the whole pool with a head-local q: not one rank's shard
        paged_decode_attention(torch.from_numpy(head_shard(q, -2, mesh)), whole, whole,
                               torch.from_numpy(table), torch.from_numpy(lens), mesh=mesh)


# ------------------------------------------------- sharding and errors


def test_sharding_rules_and_converted_shards(weights):
    """Column splits on the output axis, row splits on the input axis,
    norms and the embedding whole; params_from_numpy(mesh=) carries exactly
    shard_params' slices; the all-reduce of one rank is the identity, and a
    mesh built by hand, which joined no group, runs no collective."""
    _, tree = weights
    full = params_from_numpy(tree, CFGS["f32"], device="cpu")
    for rank in range(2):
        mesh = TpMesh(rank=rank, size=2, device=torch.device("cpu"))
        part = shard_params(full, mesh)
        lay = part["layers"]
        assert lay["wq"].shape == (2, 32, 16) and lay["wo"].shape == (2, 16, 32)
        assert lay["w_gate"].shape == (2, 32, 32) and lay["w_down"].shape == (2, 32, 32)
        assert lay["attn_norm"].shape == (2, 32) and part["embed"].shape == (64, 32)
        torch.testing.assert_close(lay["wk"], full["layers"]["wk"][..., rank * 16:(rank + 1) * 16])
        torch.testing.assert_close(lay["w_down"], full["layers"]["w_down"][:, rank * 32:(rank + 1) * 32])
        conv = params_from_numpy(tree, CFGS["f32"], device="cpu", mesh=mesh)
        for key, x in lay.items():
            torch.testing.assert_close(conv["layers"][key], x, rtol=0, atol=0)
    x = torch.ones(3)
    assert all_reduce_sum(x, None) is x
    assert all_reduce_sum(x, TpMesh(rank=0, size=1, device=torch.device("cpu"))) is x
    with pytest.raises(RuntimeError, match="joined no process group"):
        all_reduce_sum(x, TpMesh(rank=0, size=2, device=torch.device("cpu")))


def test_tp_must_divide_heads_named_error(weights):
    """tp=8 against n_heads=4 is refused at construction, naming both
    numbers, paged and dense, and by the engine; a rank other than 0
    builds no engine and never drives the adapter; under a mesh the
    adapter takes one rank's shard and refuses the full tree."""
    _, tree = weights
    params = params_from_numpy(tree, CFGS["f32"], device="cpu")
    mesh8 = TpMesh(rank=0, size=8, device=torch.device("cpu"))
    for kw in ({"kv_page": PAGE}, {}):
        with pytest.raises(ValueError, match=r"tp=8 .*n_heads=4"):
            TransformerSlotModel(params, CFGS["f32"], mesh=mesh8, **kw)
    with pytest.raises(ValueError, match=r"tp=8 .*n_heads=4"):
        ServingEngine(params, CFGS["int8"], _serving("dense"), mesh=mesh8)
    for backend, device in (("mpi", "cpu"), ("nccl", "cpu")):  # never guessed or bent
        with pytest.raises(ValueError, match="backend|nccl needs"):
            make_tp_mesh(2, backend, "file:///nonexistent/store", 0, device)
    rank1 = TpMesh(rank=1, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="rank 1 does not build a ServingEngine"):
        ServingEngine(params, CFGS["f32"], _serving("dense"), mesh=rank1)
    with pytest.raises(RuntimeError, match="follows rank 0"):
        TransformerSlotModel(shard_params(params, rank1), CFGS["f32"], mesh=rank1).init_state(2)
    with pytest.raises(ValueError, match="one rank's shard .*32 output columns, expected 16"):
        TransformerSlotModel(params, CFGS["f32"], mesh=rank1)  # the full tree, not a shard


def test_dead_worker_fails_launch_tp(weights, prompts, tmp_path):
    """A worker killed mid-run (SIGKILL: no error report) makes launch_tp
    raise within its timeout, naming the rank, and kill rank 0, which is
    blocked in a collective with it."""
    _, tree = weights
    # far more runs than the test waits for
    runs = [Run(CFGS["f32"], _serving("paged_kernel"), prompts, NEW)] * 50
    box: dict = {}

    def run():
        t0 = time.monotonic()
        try:
            launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], f"file://{tmp_path}/store",
                      args=([tree] * len(runs), runs), timeout=WORLD_TIMEOUT_S)
        except RuntimeError as exc:
            box["err"] = exc
        box["s"] = time.monotonic() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    victim = None
    while victim is None and time.monotonic() < deadline:
        victim = next((p for p in multiprocessing.active_children()
                       if p.name == "tp-rank1"), None)
        time.sleep(0.05)
    assert victim is not None, "rank 1 never started"
    time.sleep(3.0)  # let it join the world and start following rank 0
    victim.kill()
    th.join(timeout=60)
    assert not th.is_alive(), "launch_tp hung after a worker died"
    assert "rank 1: -9" in str(box.get("err")) and box["s"] < WORLD_TIMEOUT_S
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("tp-rank")]


def test_rank_error_fails_launch_tp_with_its_traceback(weights, prompts, tmp_path):
    """Rank 0's engine refuses a ServingConfig its adapter accepts (kv_swap
    on the dense ring) before its first broadcast, while rank 1 has built
    the same adapter and waits to follow it: launch_tp raises at once with
    rank 0's error and leaves no rank running."""
    _, tree = weights
    swap = dataclasses.replace(_serving("dense"), kv_swap=4)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 0 raised:(.|\n)*kv_swap requires the paged"):
        launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], f"file://{tmp_path}/store",
                  args=([tree], [Run(CFGS["f32"], swap, prompts, NEW)]),
                  timeout=WORLD_TIMEOUT_S)
    assert time.monotonic() - t0 < WORLD_TIMEOUT_S / 2
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("tp-rank")]
