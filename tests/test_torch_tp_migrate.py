"""Migration, drain and fleet membership under ``mesh=``: the port's
tensor-parallel engines against vtpu's on the same weights (CPU, f32,
gloo), the analogue of tests/test_migrate.py::test_migrate_tp2_head_shard_roundtrip
and of the one-device cases of tests/test_torch_migrate.py and
tests/test_torch_fleet.py.

One tp=2 world (``launch_tp(serve_requests, ...)``, a ``file://`` store
under tmp_path, a join timeout) serves every case in a background thread
that overlaps the JAX runs: each case is one ``Run`` whose
``Script.moves`` (``vtpu_torch.parallel.launch.Moves``) has rank 0 build
the case's engines, each tensor-parallel one on a process group of its own
followed on rank 1 by a thread of its own, and run the case's steps
(``move_round`` of tests/torch_move_kit.py, loaded there by import path as
the round's runner ``port_round``). The same steps run in this process on vtpu's engines
(``ServingEngine(..., mesh=make_axis_mesh("tp", 2))`` on the virtual
devices tests/conftest.py provides, on the gather route; the one-device
engine without a mesh) through ``move_round`` and ``vtpu.serving``'s
``migrate``. The cases:

- ``resident`` / ``resident_int8``: a live session moved between two tp=2
  engines (the scale planes' head axis is the last, K/V's the one before);
- ``spilled``: two parked sessions evicted to the source's small host tier
  on every rank; a resident session moved while they sit there, then one
  of them moved from every rank's tier, the other resumed in place;
- ``host``: the destination's pool reported dry (``alloc_exhaust``), so
  the install lands in every rank's host tier, then resumes by swap-in;
- ``cross``: tp=2 -> one device -> tp=2;
- ``recompute``: ``migrate_src_death`` and ``migrate_payload_loss``;
- ``drain``: a live, a parked and a waiting session drained off a tp=2
  engine; ``fleet``: the same through a two-member fleet of tp=2 engines.

Held against the JAX run: every stream (the JAX streams up to a step whose
top-1/top-2 margin, the JAX trunk teacher-forced on them, is under 1e-4),
the statuses, each move's path and bytes, the drain reports and every
``migrat*`` and ``swap_*`` counter (whole heads on both). Each rank's
``Run.hook`` (tests/torch_tp_hooks.py ``tier_watch``) reports that its
host tier is free after the round and that no snapshot or upload op wrote
a tier block other than its own. Nothing races a loop thread: parks are
asked, and loops held until a move asks, inside chosen tokens' deliveries;
a wall clock only guards against a hang. One torch thread a rank.
"""

import multiprocessing
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_move_kit import FLEET_MISS_MS, PinRoute, move_round
from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import decode_step as j_decode_step, prefill as j_prefill
from vtpu.parallel.mesh import make_axis_mesh
from vtpu.serving import (
    EngineFleet as JEngineFleet, FaultPlan as JFaultPlan, FaultSpec as JFaultSpec,
    FleetConfig as JFleetConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine, migrate as j_migrate,
)
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel import AxisMesh, own_group
from vtpu_torch.parallel.launch import Moves, Run, Script, launch_tp, serve_requests
from vtpu_torch.serving import FaultPlan, FaultSpec, ServingConfig

# tests/test_torch_tp_ops.py's model: 4 heads, two a rank
DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32, head_dim=8)
JCFGS = {kv: JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False, kv_int8=kv == "int8")
         for kv in ("f32", "int8")}
CFGS = {kv: ModelConfig(**DIMS, dtype=torch.float32, use_kernels=True, kv_int8=kv == "int8")
        for kv in ("f32", "int8")}
PAGE = 8
STEPS = 8
BASE = dict(slots=2, prefill_buckets=(8,), max_new_tokens=STEPS, kv_page=PAGE, prefill_chunk=8,
            kv_swap=8)
MARGIN = 1e-4
WORLD_TIMEOUT_S = 240
TIER_WATCH = "torch_tp_hooks:tier_watch"
RUNNER = "torch_move_kit:port_round"


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, DIMS["vocab"], (n,)).tolist()


PROMPTS = [_prompt(80, 5), _prompt(81, 6), _prompt(82, 5), _prompt(83, 5)]

# case -> (KV type, the engines with their ServingConfig overrides (a fault
# seam by name, armed at its first arrival), the one-device engines, the
# fleet's members, the steps of move_round)
CASES = {
    "resident": ("f32", (("src", {}), ("dst", {})), (), (), (
        ("submit", 0, "src"), ("hold_at", 0, 2), ("start",), ("held", 0),
        ("move", 0, "dst"))),
    "spilled": ("f32", (("src", dict(kv_pool_blocks=2, kv_swap=4)), ("dst", {})), (), (), (
        ("submit", 0, "src"), ("park_at", 0, 1), ("submit", 2, "src"), ("park_at", 2, 1),
        ("start",), ("parked", 0), ("parked", 2),
        # a session holds two blocks from its admission: 2's admission
        # evicts 0 to the tier's top blocks, 1's evicts 2 to blocks 0-1
        ("submit", 1, "src"), ("end", 1), ("evicted", 0), ("evicted", 2),
        # a resident move while both sit in every rank's tier
        ("submit", 3, "src"), ("park_at", 3, 1), ("parked", 3), ("move", 3, "dst"),
        ("move", 0, "dst"), ("resume", 2))),
    "host": ("f32", (("src", {}), ("dst", {"faults": "alloc_exhaust"})), (), (), (
        ("submit", 0, "src"), ("park_at", 0, 2), ("start",), ("parked", 0),
        ("move", 0, "dst"))),
    "cross": ("f32", (("src", {}), ("one", {}), ("dst", {})), ("one",), (), (
        ("submit", 0, "src"), ("park_at", 0, 2), ("park_at", 0, 5), ("start",), ("parked", 0),
        ("move", 0, "one"), ("parked", 0), ("move", 0, "dst"))),
    "recompute": ("f32", (("src", {"faults": "migrate_src_death"}),
                          ("dst", {"faults": "migrate_payload_loss"})), (), (), (
        ("submit", 0, "src"), ("park_at", 0, 2), ("submit", 1, "src"), ("park_at", 1, 2),
        ("start",), ("parked", 0), ("parked", 1), ("move", 0, "dst"), ("move", 1, "dst"))),
    "drain": ("f32", (("src", {}), ("dst", dict(slots=4))), (), (), (
        ("submit", 0, "src"), ("hold_at", 0, 5), ("submit", 1, "src"), ("submit", 2, "src"),
        # 1 parks inside its first token, 2 (still waiting) parks unstarted
        ("park_at", 1, 1, 2), ("start",), ("parked", 1), ("parked", 2), ("held", 0),
        ("drain", "src", "dst"))),
    # a fleet routes only once started: its submits wait at a held tick head
    "fleet": ("f32", (("src", {}), ("dst", dict(slots=4))), (), ("src", "dst"), (
        ("start",), ("gate", "src"), ("submit", 0, "fleet"), ("hold_at", 0, 5),
        ("submit", 1, "fleet"), ("submit", 2, "fleet"), ("park_at", 1, 1, 2), ("ungate", "src"),
        ("parked", 1), ("parked", 2), ("held", 0), ("drain", "src", None))),
}
CASES["resident_int8"] = ("int8",) + CASES["resident"][1:]

# every counter a move or a swap moves, and the mesh
KEYS = ("migrations_out", "migrations_in", "migrate_out_bytes", "migrate_in_bytes",
        "migration_copies", "migrate_recomputes", "migrate_failures", "swap_out_bytes",
        "swap_in_bytes", "evicted_blocks", "faults_injected", "tp")


def _overrides(over: dict, plan, spec) -> dict:
    """A case's ServingConfig overrides with its fault seam as the side's
    FaultPlan (each engine its own, armed at the first arrival)."""
    out = dict(over)
    if "faults" in out:
        out["faults"] = plan([spec(out["faults"], at=0)])
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """The reference's params and their float32 numpy tree."""
    jp = j_init_params(jax.random.key(0), JCFGS["f32"])
    return jp, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """The port's tp=2 world, every case a Run of one launch_tp call, in
    the background so it overlaps the JAX runs."""
    store = tmp_path_factory.mktemp("tp_migrate_store")
    names = list(CASES)
    runs = []
    for case in names:
        kv, engines, one, fleet, steps = CASES[case]
        moves = Moves(runner=RUNNER,
                      engines=tuple((n, _overrides(o, FaultPlan, FaultSpec)) for n, o in engines),
                      steps=steps, one_device=one, fleet=fleet)
        runs.append(Run(CFGS[kv], ServingConfig(**BASE), tuple(map(tuple, PROMPTS)), STEPS,
                        script=Script(moves=moves), hook=TIER_WATCH))
    out: dict = {}

    def run():
        try:
            ranks = launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], f"file://{store}/w",
                              args=([weights[1]] * len(runs), runs), timeout=WORLD_TIMEOUT_S)
            out["cases"] = {case: [r[i] for r in ranks] for i, case in enumerate(names)}
        except Exception as exc:  # handed to the tests that read this world
            out["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def get(case):
        thread.join(timeout=2 * WORLD_TIMEOUT_S)
        if "cases" not in out:
            raise AssertionError(f"the tp=2 world failed: {out.get('error')!r}")
        return out["cases"][case]

    return get


_JAX: dict = {}


def _jax(weights, case):
    """The case's round on vtpu's engines: the tp ones on a ('tp',) mesh of
    two virtual devices, the one-device ones without."""
    if case not in _JAX:
        kv, engines, one, fleet_names, steps = CASES[case]
        mesh = make_axis_mesh("tp", 2)
        built = {}
        for name, over in engines:
            sc = JServingConfig(**{**BASE, **_overrides(over, JFaultPlan, JFaultSpec)})
            built[name] = (JServingEngine(weights[0], JCFGS[kv], sc) if name in one
                           else JServingEngine(weights[0], JCFGS[kv], sc, mesh=mesh))
        fleet = None
        if fleet_names:
            fleet = JEngineFleet({n: built[n] for n in fleet_names},
                                 JFleetConfig(route_policy=PinRoute(fleet_names[0]),
                                              miss_ms=FLEET_MISS_MS))
        try:
            _JAX[case] = move_round(built, PROMPTS, STEPS, steps, j_migrate, fleet)
        finally:
            if fleet is not None:
                fleet.stop()
            for eng in built.values():
                eng.stop()
    return _JAX[case]


_MARGINS: dict = {}


def _margins(weights, kv, prompt, stream):
    """Each step's top-1/top-2 logit margin of the JAX trunk (one device)
    teacher-forced on ``stream``."""
    key = (kv, tuple(prompt), tuple(stream))
    if key not in _MARGINS:
        cfg = JCFGS[kv]
        logits, cache = j_prefill(weights[0], cfg, jnp.asarray([prompt], jnp.int32))
        row = np.asarray(logits)[0, -1]
        out = []
        for tok in stream:
            top2 = np.sort(row)[-2:]
            out.append(float(top2[1] - top2[0]))
            logits, cache = j_decode_step(weights[0], cfg, cache, jnp.asarray([tok], jnp.int32))
            row = np.asarray(logits)[0]
        _MARGINS[key] = out
    return _MARGINS[key]


def _held(world, weights, case) -> tuple:
    """The case's port and JAX rounds, held to each other: streams (up to a
    near-tie), statuses, moves, drain reports, every engine's counters; and
    every rank's host tier free and written only by its own ops. Returns
    (rank 0's round, rank 1's result, the JAX round)."""
    lead, follower = world(case)
    ref = _jax(weights, case)
    kv = CASES[case][0]
    for got, want, prompt in zip(lead["streams"], ref["streams"], PROMPTS):
        assert len(got) == len(want) == STEPS, (got, want)
        for a, b, m in zip(got, want, _margins(weights, kv, prompt, want)):
            if m < MARGIN:
                break
            assert a == b, (case, got, want)
    assert lead["statuses"] == ref["statuses"]
    assert set(lead["statuses"]) == {"OK"}
    assert [m[:5] for m in lead["moves"]] == [m[:5] for m in ref["moves"]]
    assert [d[:3] for d in lead["drains"]] == [d[:3] for d in ref["drains"]]
    for name in lead["stats"]:
        assert ({k: lead["stats"][name][k] for k in KEYS}
                == {k: ref["stats"][name][k] for k in KEYS}), name
        assert lead["stats"][name]["migration_copies"] == 0
    for res in (lead, follower):
        for name, tier in res["hooks"].items():
            assert tier["tier_held"] == [] and tier["tier_foreign"] == 0, (case, name, tier)
    assert set(follower["hooks"]) == set(lead["hooks"]) == {
        n for n, _ in CASES[case][1] if n not in CASES[case][2]}
    return lead, follower, ref


def _block_bytes(kv: str) -> int:
    """Bytes of one pool block, whole heads: K and V (and the f32 scales
    under int8) of every layer's page."""
    per = DIMS["n_layers"] * PAGE * DIMS["n_heads"]
    return 2 * per * (DIMS["head_dim"] * (1 if kv == "int8" else 4) + (4 if kv == "int8" else 0))


# --------------------------------------------------------------- the moves


@pytest.mark.parametrize("case", ["resident", "resident_int8"])
def test_live_move_between_tp_engines_matches_jax(world, weights, case):
    """A live session parked by migrate() and moved between two tp=2
    engines (the reference's head-shard roundtrip): path ``resident``, the
    stream equal to the JAX TP engines', tp 2 on both, no migration copy,
    the bytes whole heads each way (pages x the whole-head block bytes),
    both ranks' tiers untouched, the pools clean."""
    lead, follower, _ = _held(world, weights, case)
    ((i, src, dst, path, nbytes, _),) = lead["moves"]
    assert (i, src, dst, path) == (0, "src", "dst", "resident")
    kv = CASES[case][0]
    st = lead["stats"]
    assert st["src"]["tp"] == st["dst"]["tp"] == 2
    assert nbytes > 0 and nbytes % _block_bytes(kv) == 0
    assert st["src"]["migrate_out_bytes"] == st["dst"]["migrate_in_bytes"] == nbytes
    assert lead["kv_shape"][-2] == follower["kv_shape"][-2] == DIMS["n_heads"] // 2


def test_spilled_move_reads_every_ranks_tier_and_leaves_others(world, weights):
    """Two parked sessions evicted to the source's four-block host tier on
    every rank, the second into tier blocks 0-1; a resident session moved
    while they sit there (its snapshot writes no tier block on any rank:
    the other sessions' blocks byte-equal before and after), then the
    first moved from every rank's tier, the second resumed in place by
    swap-in: every stream equal to JAX's, the source's tier and pool free
    at the end."""
    lead, follower, _ = _held(world, weights, "spilled")
    assert [m[:4] for m in lead["moves"]] == [(3, "src", "dst", "resident"),
                                              (0, "src", "dst", "resident")]
    st = lead["stats"]["src"]
    assert st["evicted_blocks"] == 4
    assert st["swap_out_bytes"] == 2 * st["swap_in_bytes"] == 4 * _block_bytes("f32")
    # two snapshots on each rank, each with the tier compared byte for byte
    assert follower["hooks"]["src"]["tier_ops"] == lead["hooks"]["src"]["tier_ops"] == 2


def test_install_onto_a_dry_pool_lands_in_every_ranks_tier(world, weights):
    """The destination's pool reported dry at the install (alloc_exhaust):
    the payload lands in the destination's host tier on every rank (path
    ``host``), each rank writing only those tier blocks, then resumes by
    swap-in, token-equal."""
    lead, follower, _ = _held(world, weights, "host")
    ((_, _, _, path, nbytes, _),) = lead["moves"]
    assert path == "host"
    st = lead["stats"]["dst"]
    assert st["migrate_in_bytes"] == st["swap_in_bytes"] == nbytes > 0
    assert follower["hooks"]["dst"]["tier_ops"] == 1


def test_cross_geometry_moves_tp_to_one_device_and_back(world, weights):
    """tp=2 -> one device -> tp=2: a tensor-parallel engine and a
    one-device engine of the same model pass the compat check (whole-head
    geometry), both moves resident, the bytes equal each way."""
    lead, _, _ = _held(world, weights, "cross")
    assert [m[:4] for m in lead["moves"]] == [(0, "src", "one", "resident"),
                                              (0, "one", "dst", "resident")]
    st = lead["stats"]
    assert (st["src"]["tp"], st["one"]["tp"], st["dst"]["tp"]) == (2, 1, 2)
    assert st["one"]["migrate_in_bytes"] == st["src"]["migrate_out_bytes"] > 0


def test_recompute_moves_under_the_mesh(world, weights):
    """migrate_src_death (the source dies after the handshake) and
    migrate_payload_loss (the payload lost in transit): both sessions
    rebuild on the tp=2 destination from their token history through the
    prefill ops every rank runs, token-equal, nothing counted as shipped
    into the pool."""
    lead, _, _ = _held(world, weights, "recompute")
    assert [m[3] for m in lead["moves"]] == ["recompute", "recompute"]
    st = lead["stats"]
    assert st["dst"]["migrate_recomputes"] == 2 and st["dst"]["migrate_in_bytes"] == 0
    assert st["src"]["faults_injected"] == st["dst"]["faults_injected"] == 1


@pytest.mark.parametrize("case", ["drain", "fleet"])
def test_drain_of_a_tp_engine(world, weights, case):
    """A live (held until the drain asks for its park), a parked and a
    waiting (parked unstarted) session drained off a tp=2 engine onto
    another, directly or as a two-member fleet's drain: three migrated,
    none faulted, every stream equal to JAX's, the source empty."""
    lead, _, ref = _held(world, weights, case)
    assert [d[:3] for d in lead["drains"]] == [(3, 0, 0)]
    st = lead["stats"]
    assert st["src"]["migrations_out"] == st["dst"]["migrations_in"] == 3
    if case == "fleet":
        assert lead["fleet"]["draining_engines"] == ref["fleet"]["draining_engines"] == 1
        assert lead["fleet"]["failovers"] == ref["fleet"]["failovers"] == 0


def test_a_follower_thread_that_raises_fails_the_world_at_once(weights, tmp_path):
    """A follower thread of a migration round that raises (here its rank
    hook, before it follows) fails its rank with the traceback, and
    launch_tp raises at once, leaving no rank running, though rank 0 waits
    on a broadcast of that engine's group."""
    moves = Moves(runner=RUNNER, steps=(("start",),))
    run = Run(CFGS["f32"], ServingConfig(**BASE), tuple(map(tuple, PROMPTS)), STEPS,
              script=Script(moves=moves), hook="torch_tp_hooks:fail_follower")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 raised:(.|\n)*follower of engine "
                                           r"'(src|dst)' raised(.|\n)*no follower here"):
        launch_tp(serve_requests, 2, "gloo", ["cpu", "cpu"], f"file://{tmp_path}/store",
                  args=([weights[1]], [run]), timeout=WORLD_TIMEOUT_S)
    assert time.monotonic() - t0 < WORLD_TIMEOUT_S / 4
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("tp-rank")]


def test_own_group_refuses_nccl():
    """A further engine's process group is gloo only: its collectives run
    on a thread of its own, concurrently with the other engines' groups in
    no order common to the ranks, which NCCL communicators do not survive.
    The refusal comes before any group is built."""
    mesh = AxisMesh(rank=0, size=2, device=torch.device("cpu"), backend="nccl")
    with pytest.raises(ValueError, match="gloo only"):
        own_group(mesh)
