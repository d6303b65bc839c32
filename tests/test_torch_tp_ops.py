"""The rank-0 broadcast protocol's chunk, verify, copy, prefix, swap and
route ops: vtpu_torch's tensor-parallel engine against vtpu's on the same
weights (CPU, f32, gloo).

One tp=2 world (``launch_tp(serve_requests, ...)``, a ``file://`` store
under tmp_path, a join timeout) serves every arm in a background thread
that overlaps the JAX engine's runs. Each arm is one of the reference's
tensor-parallel gates, served by the port:

- ``prefix``      tests/test_paged_kv_tp.py::test_prefix_zero_copy_under_tp
- ``moe_*``       tests/test_paged_kv_tp.py::test_moe_paged_tp_streams_match_dense_tp
- ``loop_k``      tests/test_device_loop.py::test_streams_token_equal_across_k_tp2
- ``spec/fused``  tests/test_fused_spec.py::test_fused_token_equal_tp2
- ``overcommit``  tests/test_kv_overcommit.py::test_tp_mesh_eviction_roundtrip
- ``disagg``      tests/test_disagg.py::test_disagg_streams_token_equal_tp2

Held: each arm's streams equal the JAX TP engine's (paged on its gather
route: its kernel route raises on the installed jax, ROADMAP Queue 3) and
the port's single-device engine's, and the gate's own counters; every
rank's swapped-in blocks equal what left its pool, byte for byte, and the
overcommit arm's swap byte counters, whole heads, equal the JAX TP
engine's over the same parks and resumes. A
watchdog arm (no reference gate): ``delayed_fetch`` stalls past a 500 ms
threshold drive both rungs down and back up; its streams equal the same
engine's healthy tp=2 run and its rung counters the single-device port's
under the same plan. A fault armed by the script (``Script.arm``) inside a
delivery is contained to one request. A dense-cache prefix arm (no
reference gate) runs the dense prefix ops: each rank builds its own head
shard's buffers, installs them into both slots and drops them. Two checks
reach a follower's state through rank hooks (tests/torch_tp_hooks.py):
after a paged ``register_prefix`` before ``start()``, rank 1's pool planes
at the prefix's blocks equal the head slice of the single-device pool
there; after the dense prefix's ``unregister_prefix``, rank 1 holds no
prefix buffer.

The dense family is tests/test_torch_tp.py's config (vocab 64, d_model 32,
4 heads, 2 layers, f32, page 8), the MoE the reference gate's; weights from
``vtpu.models.init_params`` / ``init_moe_params`` carried across as f32
numpy. One torch thread a rank; no assertion reads a clock.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_move_kit import move_round
from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.moe import MoEConfig as JMoEConfig, init_moe_params as j_init_moe_params
from vtpu.parallel.mesh import make_axis_mesh
from vtpu.serving import ServingConfig as JServingConfig, ServingEngine as JServingEngine
from vtpu.serving.adapters import MoeSlotModel as JMoeSlotModel
from vtpu_torch.convert import moe_params_from_numpy, params_from_numpy
from vtpu_torch.models import ModelConfig
from vtpu_torch.models.moe import MoEConfig
from vtpu_torch.parallel.launch import Run, Script, launch_tp, serve_requests
from vtpu_torch.serving import (
    DisaggConfig, FaultPlan, FaultSpec, ServingConfig, ServingEngine, Status,
)
from vtpu_torch.serving.adapters import MoeSlotModel

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32, head_dim=8)
MDIMS = dict(vocab=96, d_model=64, n_heads=2, n_layers=2, d_ff=64, n_experts=4, top_k=2,
             max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True)
JMCFG = JMoEConfig(**MDIMS, dtype=jnp.float32)
MCFG = MoEConfig(**MDIMS, dtype=torch.float32)
PAGE = 8
WORLD_TIMEOUT_S = 180
# the watchdog: a threshold far above a healthy fetch here, stalls 1.5x it
WATCHDOG = dict(fetch_watchdog_ms=500.0, fetch_watchdog_recover_ms=1.0)
STALLS = ("delayed_fetch", 1, 2, 0.75)


def _prompt(seed, n, vocab=DIMS["vocab"], lo=1):
    """The reference gates' prompts (jax.random.randint under a key)."""
    return [int(t) for t in jax.random.randint(jax.random.key(seed), (n,), lo, vocab, jnp.int32)]


PREFIX = (5, 6, 7, 8, 9, 5, 6, 7, 8, 9)  # one full page and a boundary page
SUFFIX = [1, 2, 3]
SUFFIX2 = [4, 10, 11, 12]
LOOP_PROMPTS = [_prompt(7, 5), _prompt(8, 6)]
MOE_PROMPTS = [[t % MDIMS["vocab"] for t in _prompt(21, 5, lo=0)],
               [t % MDIMS["vocab"] for t in _prompt(22, 7, lo=0)]]

KV_STATE, SWAP_WATCH = "torch_tp_hooks:kv_state", "torch_tp_hooks:swap_watch"

# arm -> (family, ServingConfig fields, prompts, new tokens, Script fields
# and the rank hook under "hook")
ARMS = {
    "prefix": ("dense", dict(slots=2, prefill_buckets=(8,), max_new_tokens=6, kv_page=PAGE,
                             prefill_chunk=8),
               [SUFFIX, SUFFIX], 6, dict(prefix=PREFIX, hook=KV_STATE)),
    "prefix_dense": ("dense", dict(slots=2, prefill_buckets=(8,), max_new_tokens=6,
                                   prefill_chunk=8),
                     [SUFFIX, SUFFIX2], 6, dict(prefix=PREFIX, drop_prefix=True, hook=KV_STATE)),
    "moe_paged": ("moe", dict(slots=2, prefill_buckets=(8,), max_new_tokens=5, kv_page=PAGE),
                  MOE_PROMPTS, 5, {}),
    "moe_dense": ("moe", dict(slots=2, prefill_buckets=(8,), max_new_tokens=5),
                  MOE_PROMPTS, 5, {}),
    "loop_k": ("dense", dict(slots=2, prefill_buckets=(32,), max_new_tokens=10, decode_loop_k=4,
                             kv_page=PAGE),
               LOOP_PROMPTS, 10, {}),
    "spec": ("dense", dict(slots=2, prefill_buckets=(16,), max_new_tokens=12, spec_tokens=3,
                           kv_page=PAGE),
             LOOP_PROMPTS, 12, {}),
    "fused": ("dense", dict(slots=2, prefill_buckets=(16,), max_new_tokens=12, decode_loop_k=4,
                            spec_tokens=3, kv_page=PAGE),
              LOOP_PROMPTS, 12, {}),
    "overcommit": ("dense", dict(slots=2, prefill_buckets=(8,), max_new_tokens=8, kv_page=PAGE,
                                 prefill_chunk=8, kv_pool_blocks=2, kv_swap=8),
                   [_prompt(80, 5), _prompt(81, 6)], 8, dict(park_after=1, hook=SWAP_WATCH)),
    "disagg": ("dense", dict(slots=2, prefill_buckets=(8,), max_new_tokens=6, prefill_chunk=8,
                             kv_page=PAGE, disagg=DisaggConfig(min_prefill_tokens=8,
                                                               max_prefill_tokens=64,
                                                               backlog_high=2)),
               [_prompt(70 + i, 12) for i in range(3)], 6, {}),
    "healthy": ("dense", dict(slots=2, prefill_buckets=(16,), max_new_tokens=16, kv_page=PAGE,
                              paged_attn="kernel", decode_loop_k=4, **WATCHDOG),
                [_prompt(89, 5), _prompt(90, 5)], 16, {}),
}
ARMS["watchdog"] = ARMS["healthy"][:1] + (dict(ARMS["healthy"][1], faults="stalls"),) \
    + ARMS["healthy"][2:]
# a fault armed by the script inside a delivery: the next delivery raises
ARMS["fault"] = ("dense", dict(slots=2, prefill_buckets=(16,), max_new_tokens=8, kv_page=PAGE,
                               faults="plan"),
                 LOOP_PROMPTS, 8, dict(arm=(0, 2, "dispatch_exc")))
# the JAX TP engine each arm is held against: the arm's own configuration,
# but the co-scheduled loop for disagg, plain greedy (the fused arm's
# triangle) for spec, and never parked for overcommit
JAX_OF = {"prefix": "prefix", "prefix_dense": "prefix_dense", "moe_paged": "moe_paged",
          "moe_dense": "moe_paged",
          "loop_k": "loop_k", "spec": "fused", "fused": "fused", "overcommit": "overcommit",
          "disagg": "disagg"}
GATES = tuple(JAX_OF)


def _serving(arm, cls=ServingConfig, **over):
    fields = dict(ARMS[arm][1], **over)
    if fields.get("faults") in ("stalls", "plan"):
        fields["faults"] = FaultPlan([FaultSpec(*STALLS)] if fields["faults"] == "stalls" else [])
    return cls(**fields)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The reference's dense and MoE params and their float32 numpy trees."""
    jp = j_init_params(jax.random.key(0), JCFG)
    jm = j_init_moe_params(jax.random.key(5), JMCFG)
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return {"dense": (jp, to_np(jp)), "moe": (jm, to_np(jm))}


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """The port's tp=2 world, every arm in one launch_tp call, in the
    background so it overlaps the reference's compiles."""
    store = tmp_path_factory.mktemp("tp_ops_store")
    names = list(ARMS)
    runs, trees = [], []
    for arm in names:
        family, _, prompts, new, script = ARMS[arm]
        script = dict(script)
        hook = script.pop("hook", None)
        runs.append(Run(MCFG if family == "moe" else CFG, _serving(arm),
                        tuple(map(tuple, prompts)), new, script=Script(**script), hook=hook))
        trees.append(weights[family][1])
    out: dict = {}

    def run():
        try:
            ranks = launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], f"file://{store}/w",
                              args=(trees, runs), timeout=WORLD_TIMEOUT_S)
            out["arms"] = {arm: [r[i] for r in ranks] for i, arm in enumerate(names)}
        except Exception as exc:  # handed to the tests that read this world
            out["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def get(arm):
        thread.join(timeout=2 * WORLD_TIMEOUT_S)
        if "arms" not in out:
            raise AssertionError(f"the tp=2 world failed: {out.get('error')!r}")
        return out["arms"][arm]

    return get


@pytest.fixture(scope="module")
def jax_tp(weights, world):
    """The reference TP engine's streams per arm of JAX_OF."""
    mesh = make_axis_mesh("tp", 2)
    out = {}
    for arm in sorted(set(JAX_OF.values())):
        family, _, prompts, new, script = ARMS[arm]
        # the co-scheduled loop, never parked
        serving = _serving(arm, JServingConfig, disagg=None, kv_swap=None, kv_pool_blocks=None)
        if family == "moe":
            eng = JServingEngine(serving=serving, model=JMoeSlotModel(
                weights["moe"][0], JMCFG, mesh=mesh, kv_page=serving.kv_page))
        else:
            eng = JServingEngine(weights["dense"][0], JCFG, serving, mesh=mesh)
        eng.start()
        try:
            kw = {}
            if "prefix" in script:
                kw["prefix"] = eng.register_prefix(list(script["prefix"]))
            reqs = [eng.submit(p, max_new_tokens=new, **kw) for p in prompts]
            out[arm] = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
    return out


_SINGLE: dict = {}


def _single(weights, arm):
    """The port's single-device run of an arm (never parked): streams,
    stats, the prefix's blocks and the pool planes after the run."""
    if arm not in _SINGLE:
        family, _, prompts, new, script = ARMS[arm]
        serving = _serving(arm, kv_swap=None, kv_pool_blocks=None)
        if family == "moe":
            model = MoeSlotModel(moe_params_from_numpy(weights["moe"][1], MCFG, device="cpu"),
                                 MCFG, kv_page=serving.kv_page, device="cpu")
            eng = ServingEngine(serving=serving, model=model)
        else:
            eng = ServingEngine(params_from_numpy(weights["dense"][1], CFG, device="cpu"), CFG,
                                serving, device="cpu")
        kw, blocks = {}, None
        if "prefix" in script:
            kw["prefix"] = eng.register_prefix(list(script["prefix"]))
            blocks = eng._prefixes[kw["prefix"]].get("blocks")  # None: a dense cache
        reqs = [eng.submit(p, max_new_tokens=new, **kw) for p in prompts]
        eng.start()
        try:
            streams = [list(r.stream()) for r in reqs]
        finally:
            eng.stop()
        pool = {k: eng.state[k].clone() for k in ("k", "v")}
        _SINGLE[arm] = (streams, eng.stats(), blocks, pool)
    return _SINGLE[arm]


# ------------------------------------------------------------- the gates


@pytest.mark.parametrize("arm", GATES)
def test_gate_streams_match_jax_tp_and_single_device(world, jax_tp, weights, arm):
    """Each gate's streams: the port's tp=2 world equals the JAX TP
    engine's and the port's single-device engine's; every request ends OK,
    every rank holds its head shard of the pool or cache, and a paged pool
    drains free (but for the registered prefix's blocks)."""
    ranks = world(arm)
    lead = ranks[0]
    single, _, _, _ = _single(weights, arm)
    assert lead["streams"] == jax_tp[JAX_OF[arm]] == single
    assert lead["statuses"] == [Status.OK] * len(single)
    st = lead["stats"]
    assert st["tp"] == 2
    heads = (MDIMS if ARMS[arm][0] == "moe" else DIMS)["n_heads"] // 2
    assert all(r["kv_shape"][-2] == heads for r in ranks)
    if st["paged"]:
        held = -(-len(PREFIX) // PAGE) if arm == "prefix" else 0
        assert st["kv_pool_free"] == st["kv_pool_blocks"] - held
    # on the CPU the kernel route runs the plain version: no launch counted
    assert all(not any(r["launches"].values()) for r in ranks)


def test_prefix_zero_copy_counters(world):
    """The prefix gate's counters: no install copy, the full prefix page
    shared by both admissions, the boundary block copied once each."""
    st = world("prefix")[0]["stats"]
    assert st["prefix_install_copies"] == 0
    assert st["prefix_blocks_shared"] == 2
    assert st["prefix_cow_copies"] == 2


def test_prefix_blocks_on_the_follower_equal_the_single_device_pool(world, weights):
    """The follower's own state: after the paged register_prefix before
    start() (chunk ops with explicit block ids), rank 1's pool planes at
    the prefix's blocks equal the head slice (heads 2..3 of 4) of the
    single-device engine's pool at the same blocks, within 1e-5."""
    ranks = world("prefix")
    _, _, blocks, pool = _single(weights, "prefix")
    assert ranks[0]["prefix_blocks"] == blocks
    half = DIMS["n_heads"] // 2
    for key in ("k", "v"):
        got = ranks[1]["pool"][key][:, blocks]
        want = pool[key][:, blocks, :, half:].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_dense_prefix_buffers_live_on_every_rank(world, weights):
    """A dense-cache prefix under the mesh: every rank builds its own head
    shard's buffers (the prefix op), copies them into a slot at each
    admission (the install op: two copies, as on one device) and drops
    them at ``unregister_prefix`` (the drop op). The streams are held in
    test_gate_streams_match_jax_tp_and_single_device; a follower without
    its buffers could not have installed them, and after the drop no rank
    holds one."""
    ranks = world("prefix_dense")
    st = ranks[0]["stats"]
    _, single, _, _ = _single(weights, "prefix_dense")
    assert st["prefix_install_copies"] == single["prefix_install_copies"] == 2
    assert st["prefix_blocks_shared"] == 0 and st["kv_pool_blocks"] is None
    assert st["registered_prefixes"] == 0
    assert [r["prefix_keys"] for r in ranks] == [[], []]


def test_loops_count_their_inner_ticks(world):
    """The k-tick flush and the fused flush under the mesh run one decode
    or verify op an inner tick: rank 0 counts the ticks as on one device,
    every tick on the paged route, and one fetch a flush."""
    for arm, key in (("loop_k", "decode_ticks"), ("spec", "spec_ticks"),
                     ("fused", "spec_ticks")):
        st = world(arm)[0]["stats"]
        assert st[key] > 0
        assert st["paged_attn_gather_ticks"] == st["decode_ticks"] + st["spec_ticks"]
    assert world("loop_k")[0]["stats"]["loop_flushes"] > 0
    assert world("fused")[0]["stats"]["fused_flushes"] > 0


def test_overcommit_swaps_every_rank_byte_for_byte(world):
    """The eviction round trip under the mesh: both sessions parked, each
    evicted to the host tier and swapped back in; every rank's swapped-in
    blocks equal what left its own pool, and the pool and host tier drain
    free."""
    ranks = world("overcommit")
    st = ranks[0]["stats"]
    assert st["parks"] == 2 and st["resumes"] == 2
    assert st["evicted_blocks"] > 0
    assert st["swap_out_bytes"] > 0 and st["swap_in_bytes"] > 0
    assert st["kv_pool_free"] == st["kv_pool_blocks"]
    assert st["swap_host_free"] == st["swap_host_blocks"]
    for r in ranks:
        assert r["swap_checked"] == st["evicted_blocks"] and r["swap_differ"] == 0


def test_overcommit_swap_bytes_count_whole_heads_as_jax(world, weights):
    """The overcommit arm's swap byte counters under tp=2 count whole
    heads (a block's bytes across every rank), equal to the JAX TP
    engine's over the same round: each session parked inside its first
    token, the second's admission evicting the first, both resumed in
    turn (``move_round``'s steps on the JAX engine). The blocks evicted
    and the streams agree too."""
    _, _, prompts, new, script = ARMS["overcommit"]
    eng = JServingEngine(weights["dense"][0], JCFG, _serving("overcommit", JServingConfig),
                         mesh=make_axis_mesh("tp", 2))
    at = script["park_after"]
    steps = (("start",), ("submit", 0, "e"), ("park_at", 0, at), ("parked", 0),
             ("submit", 1, "e"), ("park_at", 1, at), ("parked", 1),
             ("resume", 0), ("end", 0), ("resume", 1), ("end", 1))
    try:
        ref = move_round({"e": eng}, prompts, new, steps, None)
    finally:
        eng.stop()
    lead, want = world("overcommit")[0], ref["stats"]["e"]
    keys = ("swap_out_bytes", "swap_in_bytes", "evicted_blocks")
    assert {k: lead["stats"][k] for k in keys} == {k: want[k] for k in keys}
    assert want["swap_out_bytes"] > 0 and want["swap_in_bytes"] > 0
    assert lead["streams"] == ref["streams"]


def test_disagg_handoffs_under_the_mesh(world):
    """The disaggregation gate's contract: three handoffs, no KV copy, one
    fetch a tick, the pool free."""
    st = world("disagg")[0]["stats"]
    assert st["disagg"] is True and st["tp"] == 2
    assert st["handoffs"] == 3 and st["handoff_copies"] == 0
    assert st["device_gets_per_tick"] == 1.0
    assert st["kv_pool_free"] == st["kv_pool_blocks"]


def test_moe_splits_the_expert_axis(world):
    """The MoE under tp=2 holds two of four experts a rank (the all-reduce
    path) and serves both layouts to the same streams."""
    paged, dense = world("moe_paged"), world("moe_dense")
    assert paged[0]["streams"] == dense[0]["streams"]
    assert paged[0]["stats"]["kv_pool_free"] == paged[0]["stats"]["kv_pool_blocks"]
    assert dense[0]["stats"]["kv_pool_blocks"] is None


def test_watchdog_ladder_under_the_mesh(world, weights):
    """Two stalled fetches take the ladder down (one-token flushes, then
    the gather route, in every op's header) and healthy fetches lift it
    back, last first: the streams equal the healthy tp=2 run's and the rung
    counters the single-device port's under the same plan; both routes
    served ticks."""
    lead, healthy = world("watchdog")[0], world("healthy")[0]
    assert lead["streams"] == healthy["streams"]
    assert lead["statuses"] == [Status.OK] * 2
    _, single, _, _ = _single(weights, "watchdog")
    keys = ("watchdog_degrades", "watchdog_recoveries", "faults_injected")
    st = lead["stats"]
    assert {k: st[k] for k in keys} == {k: single[k] for k in keys}
    assert st["watchdog_degrades"] == 2 and st["watchdog_recoveries"] == 2
    assert st["paged_attn_kernel_ticks"] > 0 and st["paged_attn_gather_ticks"] > 0
    assert healthy["stats"]["watchdog_degrades"] == 0


def test_scripted_fault_is_contained_under_the_mesh(world, weights):
    """Script.arm arms the plan's dispatch_exc inside the delivery of the
    first stream's second token: the next delivery raises and that one
    request ends FAULTED, the other serves on; every stream is a prefix of
    the single-device engine's healthy stream of its prompt."""
    lead = world("fault")[0]
    single, _, _, _ = _single(weights, "fault")
    assert sorted(lead["statuses"]) == sorted([Status.FAULTED, Status.OK])
    for got, want, status in zip(lead["streams"], single, lead["statuses"]):
        assert got == (want if status == Status.OK else want[:len(got)])
    st = lead["stats"]
    assert st["faulted_requests"] == 1 and st["faults_injected"] == 1
    assert st["kv_pool_free"] == st["kv_pool_blocks"]


def test_every_arm_reports_the_mesh(world):
    """Every arm ran on two ranks with the same KV plane shape each."""
    for arm in ARMS:
        ranks = world(arm)
        assert ranks[0]["stats"]["tp"] == 2
        assert ranks[0]["kv_shape"] == ranks[1]["kv_shape"]


def test_serving_config_fields_all_pass_under_a_mesh():
    """No ServingConfig field is refused under a mesh any more: the list of
    one-device fields is gone from the engine."""
    from vtpu_torch.serving import engine

    assert not hasattr(engine, "_ONE_DEVICE")
    assert {f.name for f in dataclasses.fields(ServingConfig)} >= {
        "disagg", "spec_tokens", "decode_loop_k", "loop_policy", "kv_swap",
        "fetch_watchdog_ms", "prefill_chunk"}


def test_head_local_verify_calls_count_under_their_own_name():
    """On the card a head-local paged call counts under ``_tp`` at T = 1
    and under ``_tp_verify`` at T > 1 (a verify tick), so phase h reads
    the verify launches it reports; one device keeps the kernel's name."""
    from vtpu_torch.ops import _build
    from vtpu_torch.ops.decode_attn import _launch_key
    from vtpu_torch.parallel import TpMesh

    mesh = TpMesh(rank=1, size=2, device=torch.device("cpu"))
    for name in ("paged_decode_attention", "paged_decode_attention_int8kv"):
        keys = [_launch_key(name, m, t) for m, t in ((None, 1), (None, 5), (mesh, 1), (mesh, 5))]
        assert keys == [name, name, f"{name}_tp", f"{name}_tp_verify"]
        assert all(k in _build.LAUNCHES for k in keys)
