"""The port's sharded checkpoint and resume (CPU, f32, gloo):
tests/test_checkpoint.py's gates.

One world of four spawned ranks (torch_train_ranks.checkpoint_world) trains
a dp2 x tp2 state one AdamW step and saves it through
``TrainCheckpointer`` (DCP: each rank's shard a DTensor on the mesh), then:

- restores it on the same mesh: every rank's shard byte-equal, the
  optimizer's moments and step count equal, and one more step from the
  saved state and from the restored one gives equal losses and equal
  parameters;
- saves again and restores on a dp1 x tp4 mesh: the parameters' and the
  AdamW moments' shards put back together byte-equal to the saved ones,
  every leaf's step count the saved one, and a step on the new mesh runs;
- keep=2 retention over three saves, and a restore with no step raises
  FileNotFoundError.

The config is the reference test's with four heads of 16 (a tp=4 rank
holds whole heads; the reference's two heads of 32 split below a head).
The first step's loss is held against the JAX step's (rtol 1e-5). One
torch thread a rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks_mod
from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.parallel.train import next_token_loss as j_next_token_loss
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel import TrainCheckpointer, adamw, param_split_axes

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=False)


def _tokens(seed, batch):
    return np.asarray(jax.random.randint(jax.random.key(seed), (batch, 16), 0, DIMS["vocab"],
                                         jnp.int32))


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    return jp, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("checkpoint")
    return ranks_mod.start_world(ranks_mod.checkpoint_world, 4, root / "store",
                                 (weights[1], CFG, _tokens(1, 8), _tokens(2, 8), str(root)))


def test_save_restore_roundtrip_same_mesh(world):
    for r in world():
        assert r["latest"] == 1 and r["restored_step"] == 1
        assert r["saved"].keys() == r["restored"].keys()
        for path, x in r["saved"].items():
            np.testing.assert_array_equal(r["restored"][path], x, err_msg=path)
        assert r["moments_equal"]


def test_training_continues_identically_from_the_restore(world):
    for r in world():
        l1, l2 = r["continue"]
        assert l1 == l2 and np.isfinite(l1)
        assert r["continued_equal"]


def test_restore_onto_different_mesh_geometry(world):
    """dp2 x tp2 -> dp1 x tp4: each rank reads its quarter of every split
    leaf; put back together, every leaf and both of its AdamW moments equal
    what was saved, byte for byte, every step count is the saved one, and a
    step on the new mesh runs."""
    ranks = world()
    assert {r["reshard_step"] for r in ranks} == {5}
    assert ranks[0]["reshard_shape"] == {"dp": 1, "tp": 4}
    for r in ranks:
        for key in ("exp_avg", "exp_avg_sq"):
            r[f"saved5_{key}"] = r["saved5_opt"][key]
            r[f"reshard_{key}"] = r["reshard_opt"][key]
    for path, axis in param_split_axes().items():
        for saved_key, got_key in (("saved5", "resharded"),
                                   ("saved5_exp_avg", "reshard_exp_avg"),
                                   ("saved5_exp_avg_sq", "reshard_exp_avg_sq")):
            saved = ranks_mod.gather(ranks, saved_key, path, axis, "tp")
            got = ranks_mod.gather(ranks, got_key, path, axis, "tp", coords="reshard_coords")
            np.testing.assert_array_equal(got, saved, err_msg=f"{got_key} {path}")
        if axis is not None:
            shard = [r for r in ranks if r["reshard_coords"]["tp"] == 1][0]["resharded"][path]
            assert shard.shape[axis] * 4 == saved.shape[axis]
    counts = {c for r in ranks for c in r["saved5_opt"]["step"].values()}
    assert len(counts) == 1 and counts.pop() >= 1
    for r in ranks:
        assert r["reshard_opt"]["step"] == r["saved5_opt"]["step"]
        assert np.isfinite(r["reshard_loss"])


def test_keep_n_retention_and_missing_step(world):
    for r in world():
        assert r["keep_steps"] == [2, 3] and r["keep_latest"] == 3
        assert r["missing"] == "no checkpoint step found"


def test_missing_step_without_a_world(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "none"))
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(CFG, None, adamw(), device="cpu")
    ckpt.close()


def test_first_step_loss_matches_jax(world, weights):
    """The state the checkpoint saves was trained from the reference's
    weights: the world's first step saw the JAX loss."""
    want = float(j_next_token_loss(weights[0], JCFG, jnp.asarray(_tokens(1, 8))))
    for r in world():
        np.testing.assert_allclose(r["loss0"], want, rtol=1e-5)
