"""The port's expert parallelism against vtpu's (CPU, f32, gloo):
tests/test_moe.py's ep gates.

One world of four spawned ranks (torch_train_ranks.ep_world) runs an
('ep',) mesh of 4 and a ('dp', 'ep') mesh of 2 x 2 in a background thread
while the JAX side computes on ``jax.devices()[:4]``. The config is the
reference test's: capacity_factor = E / k, so no choice is ever dropped and
the expert-parallel route computes the dense one's function.

- ``ep_moe_forward`` of each rank's rows against the dense ``moe_forward``
  on the global batch (atol 2e-4, test_moe.py:68) and against the
  reference's ``ep_moe_forward`` on an ep mesh of 4;
- ``ep_moe_loss`` on the ep mesh of 4 against ``jax.value_and_grad`` of
  the reference's ``moe_loss`` through its ``make_ep_ffn`` on the same
  geometry (the same per-shard aux estimator): the loss at rtol 1e-5,
  every rank's gradients, its expert shard against its slice, at atol
  2e-5, rtol 1e-3;
- SGD steps on ``ep_moe_loss`` lower it on both meshes (test_moe.py:82).

The expert-count, batch and expert-shard errors are held without spawning.
One torch thread a rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks_mod
from vtpu.models.moe import (
    MoEConfig as JMoEConfig, init_moe_params as j_init_moe_params, moe_forward as j_moe_forward,
    moe_loss as j_moe_loss,
)
from vtpu.parallel.expert import (
    ep_moe_forward as j_ep_moe_forward, make_ep_ffn as j_make_ep_ffn,
    moe_param_shardings as j_moe_param_shardings,
)
from vtpu.parallel.mesh import make_axis_mesh as j_make_axis_mesh
from vtpu_torch.models import MoEConfig
from vtpu_torch.parallel import (
    World, make_axis_mesh, make_dp_ep_mesh, make_ep_ffn, moe_param_shardings, place_batch,
    shard_ep_params,
)

DIMS = dict(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, n_experts=8, top_k=2,
            capacity_factor=4.0, max_seq=16, head_dim=16)
JCFG = JMoEConfig(**DIMS, dtype=jnp.float32)
CFG = MoEConfig(**DIMS, dtype=torch.float32, use_kernels=False)
EP = 4
LR = 5e-2
STEPS = 5
FORWARD_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _tokens(seed, b):
    return np.asarray(jax.random.randint(jax.random.key(seed), (b, 16), 0, DIMS["vocab"],
                                         jnp.int32))


def _flat(tree):
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


@pytest.fixture(scope="module")
def weights():
    jp = j_init_moe_params(jax.random.key(0), JCFG)
    return jp, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    store = tmp_path_factory.mktemp("ep_store")
    return ranks_mod.start_world(ranks_mod.ep_world, EP, store / "w",
                                 (weights[1], CFG, _tokens(1, 8), _tokens(1, 4), LR, STEPS))


@pytest.fixture(scope="module")
def jmesh():
    return j_make_axis_mesh("ep", EP, devices=jax.devices()[:EP])


def _rows(ranks, name, mesh_shape):
    """Every rank's logits rows put back in batch order (the block index
    over the mesh's batch axes, dp outermost)."""
    def block(r):
        c = r[name]["coords"]
        return c.get("dp", 0) * mesh_shape["ep"] + c["ep"]

    return np.concatenate([r[name]["logits"] for r in sorted(ranks, key=block)], axis=0)


@pytest.mark.parametrize("name,shape", [("ep", {"ep": 4}), ("dp_ep", {"dp": 2, "ep": 2})])
def test_ep_forward_matches_dense(world, weights, name, shape):
    want, _ = j_moe_forward(weights[0], JCFG, jnp.asarray(_tokens(1, 8)))
    ranks = world()
    np.testing.assert_allclose(_rows(ranks, name, shape), np.asarray(want), atol=FORWARD_ATOL)
    for r in ranks:
        assert np.isfinite(r[name]["aux"]) and r[name]["aux"] > 0.0
        assert r[name]["expert_shape"][1] == DIMS["n_experts"] // shape["ep"]


def test_ep_forward_matches_reference_ep(world, weights, jmesh):
    tokens = jnp.asarray(_tokens(1, 8))
    want, aux = j_ep_moe_forward(weights[0], JCFG, tokens, jmesh)
    ranks = world()
    np.testing.assert_allclose(_rows(ranks, "ep", {"ep": 4}), np.asarray(want),
                               atol=FORWARD_ATOL)
    for r in ranks:  # the same per-shard estimator, averaged over the ep ranks
        np.testing.assert_allclose(r["ep"]["aux"], float(aux), rtol=1e-5)


def test_ep_loss_gradients_match_jax(world, weights, jmesh):
    tokens = jnp.asarray(_tokens(1, 4))
    ffn = j_make_ep_ffn(jmesh)
    jloss, jgrads = jax.value_and_grad(lambda p: j_moe_loss(p, JCFG, tokens, ffn=ffn))(weights[0])
    part = DIMS["n_experts"] // EP
    for r in world():
        np.testing.assert_allclose(r["ep"]["loss0"], float(jloss), rtol=LOSS_RTOL)
        e = r["ep"]["coords"]["ep"]
        for path, want in _flat(jgrads).items():
            want = np.asarray(want)
            if path.split(".")[-1] in EXPERT_KEYS:
                want = want[:, e * part:(e + 1) * part]
            np.testing.assert_allclose(r["ep"]["grads"][path], want, **GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("name", ["ep", "dp_ep"])
def test_moe_train_step_ep_sharded(world, name):
    for r in world():
        assert np.isfinite(r[name]["losses"]).all()
        assert r[name]["losses"][-1] < r[name]["loss0"]


def test_ep_dense_route_on_each_ranks_rows(world, weights):
    """With nothing dropped, a rank's rows through the dense MoE on its
    full weights equal its rows through the expert-parallel route."""
    for r in world():
        np.testing.assert_allclose(r["ep"]["logits"], r["dense_rows"], atol=FORWARD_ATOL)


def test_expert_shardings_match_reference(jmesh):
    mesh = make_axis_mesh(World(rank=0, size=EP, device="cpu"), "ep")
    rules, jrules = moe_param_shardings(mesh), j_moe_param_shardings(jmesh)
    for key, spec in jrules["layers"].items():
        want = list(spec.spec).index("ep") if "ep" in spec.spec else None
        assert rules["layers"][key] == want, key
    assert rules["embed"] is None and rules["final_norm"] is None


def test_ep_errors():
    mesh = make_axis_mesh(World(rank=0, size=EP, device="cpu"), "ep")
    odd = MoEConfig(**{**DIMS, "n_experts": 6}, dtype=torch.float32)
    lp = {"router": torch.zeros(DIMS["d_model"], 6)}
    with pytest.raises(ValueError, match="n_experts % mesh"):
        make_ep_ffn(mesh)(lp, torch.zeros(1, 4, DIMS["d_model"]), odd)
    with pytest.raises(ValueError, match="n_experts % mesh"):
        shard_ep_params({"embed": None, "layers": {"router": torch.zeros(2, 4, 6)},
                         "final_norm": None}, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        place_batch(np.zeros((6, 16)), make_dp_ep_mesh(World(rank=0, size=EP, device="cpu"),
                                                       ep=2))
    with pytest.raises(ValueError, match="has no axis"):
        moe_param_shardings(mesh, "tp")
