"""The port's dp x tp and multislice training against vtpu's (CPU, f32,
gloo): tests/test_parallel.py's gates.

One world of four spawned ranks (torch_train_ranks.parallel_world, a
``file://`` store under tmp_path, a join timeout) runs every arm in a
background thread while the JAX side computes on ``jax.devices()[:4]``:

- the dp2 x tp2 sharded prefill of each rank's rows against the
  single-device JAX prefill (atol 2e-3, test_parallel.py:76);
- the dp2 x tp2 AdamW step: its loss against the JAX mesh step's (rtol
  1e-5) and its gradients, each rank's shard put back together, against
  ``jax.value_and_grad`` of the reference's loss on the global batch
  (atol 2e-5, rtol 1e-3); the replicated leaves bit-equal across the tp
  ranks after the step, the split ones across the dp ranks; five more
  steps lower the loss;
- the multislice 2 x 1 x 2 step: finite, and the second loss below the
  first.

The meshes' factorization and every ValueError are held against the
reference's without spawning. One torch thread a rank; no assertion reads a
clock.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks_mod
from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import prefill as j_prefill
from vtpu.parallel.mesh import (
    make_dp_ep_mesh as j_make_dp_ep_mesh, make_mesh as j_make_mesh,
    make_multislice_mesh as j_make_multislice_mesh, mesh_shape_for as j_mesh_shape_for,
)
from vtpu.parallel.train import (
    init_train_state as j_init_train_state, make_train_step as j_make_train_step,
    next_token_loss as j_next_token_loss, place_batch as j_place_batch,
)
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel import (
    World, batch_sharding, make_axis_mesh, make_dp_ep_mesh, make_mesh, make_multislice_mesh,
    mesh_shape_for, param_split_axes, place_batch,
)

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=False)
MULTI_DIMS = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=16,
                  head_dim=32)
JMULTI = JModelConfig(**MULTI_DIMS, dtype=jnp.float32, use_pallas=False)
MULTI = ModelConfig(**MULTI_DIMS, dtype=torch.float32, use_kernels=False)
LR = 5e-3
STEPS = 5
PREFILL_ATOL = 2e-3
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _tokens(seed, shape, vocab=128):
    return np.asarray(jax.random.randint(jax.random.key(seed), shape, 0, vocab, jnp.int32))


def _flat(tree):
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    jm = j_init_params(jax.random.key(0), JMULTI)
    return {"dense": (jp, _np_tree(jp)), "multi": (jm, _np_tree(jm))}


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    store = tmp_path_factory.mktemp("parallel_store")
    return ranks_mod.start_world(
        ranks_mod.parallel_world, 4, store / "w",
        (weights["dense"][1], CFG, weights["multi"][1], MULTI, _tokens(1, (4, 16)),
         _tokens(1, (8, 16)), LR, STEPS))


@pytest.fixture(scope="module")
def jax_step(weights, world):
    """The reference's dp2 x tp2 step's first loss, and its gradients."""
    mesh = j_make_mesh(4, tp=2, devices=jax.devices()[:4])
    state, opt = j_init_train_state(jax.random.key(0), JCFG, mesh, lr=LR)
    step = j_make_train_step(JCFG, opt)
    tokens = _tokens(1, (4, 16))
    _, loss = step(state, j_place_batch(jnp.asarray(tokens), mesh))
    grads = jax.grad(j_next_token_loss)(weights["dense"][0], JCFG, jnp.asarray(tokens))
    return float(loss), _np_tree(_flat(grads))


# ------------------------------------------------ meshes, without spawning


def _world(n):
    return World(rank=0, size=n, device=torch.device("cpu"))


def test_mesh_shape_factorization_matches_reference():
    for n, tp in ((8, None), (4, None), (8, 2), (2, None), (1, None), (6, None)):
        assert mesh_shape_for(n, tp) == j_mesh_shape_for(n, tp)
    assert mesh_shape_for(8) == (2, 4) and mesh_shape_for(4) == (1, 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_shape_for(8, tp=3)
    with pytest.raises(ValueError, match="does not divide"):
        j_mesh_shape_for(8, tp=3)


def test_meshes_have_the_reference_shapes():
    devs = jax.devices()[:8]
    assert make_mesh(_world(8)).shape == dict(j_make_mesh(8, devices=devs).shape)
    assert make_mesh(_world(4), tp=2).shape == dict(j_make_mesh(4, tp=2, devices=devs).shape)
    assert (make_multislice_mesh(_world(8), 2, per_slice=4, tp=2).shape
            == dict(j_make_multislice_mesh(2, per_slice=4, tp=2, devices=devs).shape)
            == {"slice": 2, "dp": 2, "tp": 2})
    assert make_dp_ep_mesh(_world(8)).shape == dict(j_make_dp_ep_mesh(8, devices=devs).shape)
    assert make_axis_mesh(_world(4), "sp").shape == {"sp": 4}


def test_mesh_errors_match_reference():
    devs = jax.devices()[:8]
    n = len(devs)
    with pytest.raises(ValueError, match="do not split"):
        j_make_multislice_mesh(3, devices=devs)
    with pytest.raises(ValueError, match="do not split"):
        make_multislice_mesh(_world(n), 3)
    with pytest.raises(ValueError, match="have"):
        j_make_multislice_mesh(2, per_slice=n, devices=devs)
    with pytest.raises(ValueError, match="have"):
        make_multislice_mesh(_world(n), 2, per_slice=n)
    with pytest.raises(ValueError, match="have"):
        j_make_mesh(2 * n, devices=devs)
    with pytest.raises(ValueError, match="have"):
        make_mesh(_world(n), 2 * n)
    with pytest.raises(ValueError, match="does not divide"):
        j_make_dp_ep_mesh(8, ep=3, devices=devs)
    with pytest.raises(ValueError, match="does not divide"):
        make_dp_ep_mesh(_world(8), ep=3)
    # a runtime's slice grouping that splits unevenly: the reference reads
    # each device's slice_index, the port each rank's slice id
    ids = [0, 0, 0, 1]
    fake = [types.SimpleNamespace(slice_index=i) for i in ids]
    with pytest.raises(ValueError, match="slices are uneven"):
        j_make_multislice_mesh(2, per_slice=2, devices=fake)
    with pytest.raises(ValueError, match="slices are uneven"):
        make_multislice_mesh(_world(4), 2, per_slice=2, slice_ids=ids)


def test_multislice_slices_follow_the_grouping():
    """Ranks grouped by slice id (a node each), contiguous without one."""
    ms = make_multislice_mesh(_world(4), 2, per_slice=2, tp=2, slice_ids=[1, 0, 1, 0])
    assert ms.grid.tolist() == [[[1, 3]], [[0, 2]]]
    assert make_multislice_mesh(_world(4), 2, tp=2).grid.tolist() == [[[0, 1]], [[2, 3]]]


def test_batch_rule_matches_reference():
    devs = jax.devices()[:8]
    tokens = np.arange(8 * 3).reshape(8, 3)
    ms = j_make_multislice_mesh(2, per_slice=4, tp=2, devices=devs)
    jrows = j_place_batch(jnp.asarray(tokens), ms)
    for r in range(8):
        mesh = make_multislice_mesh(World(rank=r, size=8, device=torch.device("cpu")), 2,
                                    per_slice=4, tp=2)
        assert batch_sharding(mesh) == ("slice", "dp")
        rows = place_batch(tokens, mesh)
        dev = jax.devices()[r]
        want = [s.data for s in jrows.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(rows, np.asarray(want))
    with pytest.raises(ValueError, match="not divisible"):
        place_batch(np.zeros((3, 4)), make_mesh(_world(8), tp=4))


# ------------------------------------------------------- the 4-rank world


def test_world_meshes(world):
    ranks = world()
    assert [r["shape"] for r in ranks] == [{"dp": 2, "tp": 2}] * 4
    assert sorted((r["coords"]["dp"], r["coords"]["tp"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert ranks[0]["multi_shape"] == {"slice": 2, "dp": 1, "tp": 2}


def test_sharded_prefill_matches_single_device(world, weights):
    tokens = _tokens(1, (4, 16))
    want, _ = j_prefill(weights["dense"][0], JCFG, jnp.asarray(tokens))
    want = np.asarray(want)
    for r in world():
        dp = r["coords"]["dp"]
        np.testing.assert_allclose(r["prefill"], want[2 * dp:2 * dp + 2], atol=PREFILL_ATOL)


def test_train_step_loss_matches_jax_step(world, jax_step):
    for r in world():
        np.testing.assert_allclose(r["loss0"], jax_step[0], rtol=LOSS_RTOL)


def test_train_step_gradients_match_jax(world, jax_step):
    ranks = world()
    axes = param_split_axes()
    for path, want in jax_step[1].items():
        got = ranks_mod.gather(ranks, "grads", path, axes[path], "tp")
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=path)


def test_replicated_leaves_equal_across_ranks_after_a_step(world):
    """The embedding and the norms, replicated over 'tp', get the same
    gradient and the same update on every rank; a split leaf is equal on
    the two dp ranks holding it."""
    ranks = world()
    for path, axis in param_split_axes().items():
        for r in ranks[1:]:
            same = (r["coords"]["tp"] == ranks[0]["coords"]["tp"]) if axis is not None else True
            if same:
                np.testing.assert_array_equal(r["params1"][path], ranks[0]["params1"][path],
                                              err_msg=path)
                np.testing.assert_array_equal(r["grads"][path], ranks[0]["grads"][path],
                                              err_msg=path)


def test_train_step_reduces_loss_on_mesh(world):
    for r in world():
        assert np.isfinite(r["losses"]).all()
        assert r["losses"][-1] < r["loss0"]


def test_multislice_train_step(world):
    """2 slices x (1 dp x 2 tp): the batch split over ('slice', 'dp'), both
    losses finite, the second below the first."""
    ranks = world()
    tokens = _tokens(1, (8, 16))
    for r in ranks:
        assert np.isfinite(r["multi_losses"]).all()
        assert r["multi_losses"][1] < r["multi_losses"][0]
        s = r["multi_coords"]["slice"]
        np.testing.assert_array_equal(r["multi_rows"], tokens[4 * s:4 * s + 4])
    losses = {tuple(r["multi_losses"]) for r in ranks}
    assert len(losses) == 1  # the loss is the global batch's, whole on every rank
