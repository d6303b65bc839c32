"""The port's sequence parallelism against vtpu's (CPU, f32, gloo):
tests/test_parallel.py's ring and Ulysses gates and tests/test_longctx.py's.

One world of four spawned ranks, an ('sp',) mesh of 4
(torch_train_ranks.seqpar_world), runs every arm in a background thread
while the JAX side computes on an sp mesh of ``jax.devices()[:4]``:

- ring and Ulysses attention on each rank's sequence chunk against the
  reference's ``ring_attention`` / ``ulysses_attention`` (atol 2e-5, the
  reference's own gate against ``causal_attention``), and the gradients of
  sum(out * w) with respect to q, k and v against ``jax.grad`` through the
  reference's (atol 2e-5);
- ``sp_prefill``'s logits chunks against the dense ``prefill`` (rtol and
  atol 2e-4, test_longctx.py's);
- ``sp_loss`` against ``jax.value_and_grad(sp_loss)`` (loss rtol 1e-5,
  gradients atol 2e-5, rtol 1e-3), which holds the cross-chunk targets
  and the global mean.

The Ulysses heads error and the indivisible-sequence error are held
without spawning. One torch thread a rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks_mod
from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.transformer import prefill as j_prefill
from vtpu.ops import causal_attention as j_causal_attention
from vtpu.parallel import ring_attention as j_ring_attention
from vtpu.parallel.longctx import (
    place_sp_tokens as j_place_sp_tokens, sp_loss as j_sp_loss, sp_prefill as j_sp_prefill,
)
from vtpu.parallel.mesh import make_sp_mesh as j_make_sp_mesh
from vtpu.parallel.ulysses import ulysses_attention as j_ulysses_attention
from vtpu_torch.models import ModelConfig
from vtpu_torch.parallel import (
    World, make_sp_mesh, place_sp_tokens, ring_attention, ulysses_attention,
)

DIMS = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_seq=64, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=False)
SP = 4
ATTN_ATOL = 2e-5
PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)


def _qkvw(seed, shape):
    keys = jax.random.split(jax.random.key(seed), 4)
    return [np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in keys]


RING = _qkvw(0, (2, 64, 2, 16))  # S = 64: four chunks of 16
ULYSSES = _qkvw(1, (2, 64, 8, 16))  # H = 8 divides the 4-way mesh


def _tokens(seed, s=32):
    return np.asarray(jax.random.randint(jax.random.key(seed), (2, s), 0, DIMS["vocab"],
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
    store = tmp_path_factory.mktemp("seqpar_store")
    return ranks_mod.start_world(ranks_mod.seqpar_world, SP, store / "w",
                                 (weights[1], CFG, RING, ULYSSES, _tokens(1), _tokens(2)))


@pytest.fixture(scope="module")
def jmesh():
    return j_make_sp_mesh(SP, devices=jax.devices()[:SP])


def _chunks(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _attn_grads(fn, arrays, mesh):
    q, k, v, w = (jnp.asarray(a) for a in arrays)
    return [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(fn(q, k, v, mesh) * w), argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sp_attention_matches_reference(world, jmesh, name):
    fn, arrays = ((j_ring_attention, RING) if name == "ring"
                  else (j_ulysses_attention, ULYSSES))
    q, k, v, _ = (jnp.asarray(a) for a in arrays)
    got = _chunks(world(), name)
    np.testing.assert_allclose(got, np.asarray(fn(q, k, v, jmesh)), atol=ATTN_ATOL)
    np.testing.assert_allclose(got, np.asarray(j_causal_attention(q, k, v)), atol=ATTN_ATOL)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sp_attention_gradients_match_jax(world, jmesh, name):
    fn, arrays = ((j_ring_attention, RING) if name == "ring"
                  else (j_ulysses_attention, ULYSSES))
    want = _attn_grads(fn, arrays, jmesh)
    ranks = world()
    for i, which in enumerate("qkv"):
        got = np.concatenate([r[f"{name}_grads"][i] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[i], atol=ATTN_ATOL, err_msg=which)


def test_ulysses_rejects_indivisible_heads(jmesh):
    q = torch.zeros((1, 16, 6, 8))  # 6 heads over 4 ranks
    with pytest.raises(ValueError, match="ring_attention instead"):
        ulysses_attention(q, q, q, make_sp_mesh(World(rank=0, size=SP, device="cpu")))
    jq = jnp.zeros((1, 16, 6, 8))
    with pytest.raises(ValueError, match="ring_attention instead"):
        j_ulysses_attention(jq, jq, jq, jmesh)


def test_ring_attention_on_one_rank_is_causal_attention():
    """A ring of one never rotates: plain causal attention on the chunk."""
    from vtpu_torch.ops import causal_attention

    q, k, v, _ = (torch.from_numpy(a) for a in RING)
    got = ring_attention(q, k, v, make_sp_mesh(World(rank=0, size=1, device="cpu")))
    torch.testing.assert_close(got, causal_attention(q, k, v), atol=ATTN_ATOL, rtol=0)


def test_sp_prefill_matches_dense(world, weights):
    want, _ = j_prefill(weights[0], JCFG, jnp.asarray(_tokens(1)))
    np.testing.assert_allclose(_chunks(world(), "sp_prefill"), np.asarray(want), **PREFILL_TOL)


def test_sp_prefill_rejects_indivisible_seq(weights, jmesh):
    mesh = make_sp_mesh(World(rank=0, size=SP, device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        place_sp_tokens(_tokens(1, s=30), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        j_sp_prefill(weights[0], JCFG, jnp.asarray(_tokens(1, s=30)), jmesh)


def test_place_sp_tokens_gives_each_rank_its_chunk(jmesh):
    tokens = _tokens(3)
    placed = j_place_sp_tokens(jnp.asarray(tokens), jmesh)
    for r in range(SP):
        mesh = make_sp_mesh(World(rank=r, size=SP, device="cpu"))
        want = [s.data for s in placed.addressable_shards if s.device == jax.devices()[r]][0]
        np.testing.assert_array_equal(place_sp_tokens(tokens, mesh), np.asarray(want))


def test_sp_loss_and_grads_match_jax(world, weights, jmesh):
    """Gradients through the ring's ppermutes and the cross-chunk targets:
    the port's equal jax.grad of the reference's sp_loss on every rank."""
    tokens = jnp.asarray(_tokens(2))
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_sp_loss(p, JCFG, j_place_sp_tokens(tokens, jmesh), jmesh))(weights[0])
    for r in world():
        np.testing.assert_allclose(r["sp_loss"], float(jloss), rtol=LOSS_RTOL)
        for path, want in _flat(jgrads).items():
            np.testing.assert_allclose(r["sp_grads"][path], np.asarray(want), **GRAD_TOL,
                                       err_msg=path)
