"""The port's pipeline parallelism against vtpu's (CPU, f32, gloo):
tests/test_pp.py's gates.

One world of four spawned ranks, a ('pp',) mesh of 4
(torch_train_ranks.pp_world), runs every arm in a background thread while
the JAX side computes on a pp mesh of ``jax.devices()[:4]``:

- ``pipeline_apply`` over eight stacked tanh(x @ w) layers and six
  microbatches against the sequential scan and the reference's
  ``pipeline_apply`` (atol 1e-5, test_pp.py's);
- ``pp_transformer_forward`` against the dense ``prefill`` (atol 2e-4);
- ``pp_loss`` against ``jax.value_and_grad(pp_loss)`` on every stage: the
  loss at rtol 1e-5, each stage's layer gradients against its slice of the
  reference's and the embedding's and final norm's whole (atol 2e-5,
  rtol 1e-3);
- SGD steps on ``pp_loss`` lower it (test_pp.py:74).

``microbatch`` and the geometry errors are held without spawning. One
torch thread a rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks_mod
from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import prefill as j_prefill
from vtpu.parallel.mesh import make_axis_mesh as j_make_axis_mesh
from vtpu.parallel.pipeline import (
    microbatch as j_microbatch, pipeline_apply as j_pipeline_apply, pp_loss as j_pp_loss,
)
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel import (
    World, make_axis_mesh, microbatch, pipeline_apply, pp_transformer_forward, shard_stages,
)

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_layers=8, d_ff=128, max_seq=16, head_dim=16)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=False)
PP = 4
LR = 5e-2
STEPS = 4
APPLY_ATOL = 1e-5
FORWARD_ATOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)

W = np.asarray(jax.random.normal(jax.random.key(0), (8, 16, 16))) * np.float32(0.3)
XS = np.asarray(jax.random.normal(jax.random.key(1), (6, 2, 16)))  # 6 microbatches


def _tokens():
    return np.asarray(jax.random.randint(jax.random.key(1), (8, 16), 0, DIMS["vocab"],
                                         jnp.int32))


def _flat(tree):
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(jax.random.key(0), JCFG)
    return jp, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    store = tmp_path_factory.mktemp("pp_store")
    return ranks_mod.start_world(ranks_mod.pp_world, PP, store / "w",
                                 (W, XS, weights[1], CFG, _tokens(), LR, STEPS))


@pytest.fixture(scope="module")
def jmesh():
    return j_make_axis_mesh("pp", PP, devices=jax.devices()[:PP])


def _hand_mesh(n):
    return make_axis_mesh(World(rank=0, size=n, device="cpu"), "pp")


def test_microbatch_shapes():
    x = torch.zeros((8, 16, 4))
    assert microbatch(x, 4).shape == j_microbatch(jnp.zeros((8, 16, 4)), 4).shape == (4, 2, 16, 4)
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(x, 3)


def test_pipeline_apply_matches_sequential(world, jmesh):
    stage = lambda lp, x: jnp.tanh(x @ lp)  # noqa: E731
    want, _ = jax.lax.scan(lambda h, lp: (stage(lp, h), None), jnp.asarray(XS), jnp.asarray(W))
    ref = j_pipeline_apply(jnp.asarray(W), jnp.asarray(XS), stage, jmesh)
    for r in world():
        np.testing.assert_allclose(r["apply"], np.asarray(want), atol=APPLY_ATOL)
        np.testing.assert_allclose(r["apply"], np.asarray(ref), atol=APPLY_ATOL)


def test_pp_transformer_matches_dense_prefill(world, weights):
    want, _ = j_prefill(weights[0], JCFG, jnp.asarray(_tokens()))
    for r in world():
        np.testing.assert_allclose(r["forward"], np.asarray(want), atol=FORWARD_ATOL)


def test_pp_loss_gradients_match_jax_on_every_stage(world, weights, jmesh):
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_pp_loss(p, JCFG, jnp.asarray(_tokens()), jmesh))(weights[0])
    part = DIMS["n_layers"] // PP
    for r in world():
        np.testing.assert_allclose(r["loss0"], float(jloss), rtol=LOSS_RTOL)
        idx = r["coords"]["pp"]
        for path, want in _flat(jgrads).items():
            want = np.asarray(want)
            if path.startswith("layers."):
                want = want[idx * part:(idx + 1) * part]
            np.testing.assert_allclose(r["grads"][path], want, **GRAD_TOL, err_msg=path)


def test_pipeline_rejects_bad_geometry(weights):
    mesh = _hand_mesh(8)
    bad = dataclasses.replace(CFG, n_layers=6)
    with pytest.raises(ValueError, match="not divisible"):
        pp_transformer_forward({}, bad, torch.zeros((8, 16), dtype=torch.int32), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_stages({"w": torch.zeros((6, 2))}, mesh)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply({"w": torch.zeros((1, 4, 4))},
                       torch.zeros((2, 1, 16, DIMS["d_model"])),  # 2 microbatches < 8 stages
                       lambda lp, x: x, mesh)


def test_shard_stages_gives_each_stage_its_layers():
    w = torch.arange(8.0)[:, None]
    for r in range(PP):
        mesh = make_axis_mesh(World(rank=r, size=PP, device="cpu"), "pp")
        got = shard_stages({"embed": torch.ones(2), "layers": {"w": w}, "final_norm": w}, mesh)
        assert got["layers"]["w"][:, 0].tolist() == [2.0 * r, 2.0 * r + 1]
        assert got["final_norm"] is w  # whole on every stage


def test_pp_train_step_reduces_loss(world):
    for r in world():
        assert np.isfinite(r["losses"]).all()
        assert r["losses"][-1] < r["loss0"]
