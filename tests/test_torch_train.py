"""The port's losses, gradients and optimizer on one device against vtpu's
(CPU, f32).

Held: ``next_token_ce`` against the reference's at rtol 1e-6; the dense
trunk's ``next_token_loss``, ``moe_loss`` and ``ssm_loss`` with their
gradients against ``jax.value_and_grad`` on the same weights and tokens
(loss rtol 1e-5, every gradient leaf at atol 2e-5, rtol 1e-3); one AdamW
step of ``init_train_state``'s optimizer, applied to the same numpy
gradients, against ``optax.adamw``'s update (atol 1e-6: the optimizer is
held apart from the gradients, since Adam's first step is about
lr * sign(g) and a 1e-7 difference in a near-zero gradient would flip
it); a few train steps lower the loss, as the reference's
``test_train_step_reduces_loss_on_mesh`` asserts. The configs are the
reference tests' own (tests/test_parallel.py, test_moe.py, test_ssm.py).
One torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vtpu.models import ModelConfig as JModelConfig, init_params as j_init_params
from vtpu.models.moe import (
    MoEConfig as JMoEConfig, init_moe_params as j_init_moe_params, moe_loss as j_moe_loss,
)
from vtpu.models.ssm import (
    SSMConfig as JSSMConfig, init_ssm_params as j_init_ssm_params, ssm_loss as j_ssm_loss,
)
from vtpu.models.transformer import prefill as j_prefill
from vtpu.ops.loss import next_token_ce as j_next_token_ce
from vtpu.parallel.train import next_token_loss as j_next_token_loss
from vtpu_torch.convert import moe_params_from_numpy, params_from_numpy, ssm_params_from_numpy
from vtpu_torch.models import (
    ModelConfig, MoEConfig, SSMConfig, moe_loss, prefill, ssm_loss, transformer_forward,
)
from vtpu_torch.ops.loss import next_token_ce
from vtpu_torch.parallel import adamw, init_train_state, make_train_step, next_token_loss
from vtpu_torch.parallel.train import named_leaves

DIMS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32, head_dim=32)
JCFG = JModelConfig(**DIMS, dtype=jnp.float32, use_pallas=False)
CFG = ModelConfig(**DIMS, dtype=torch.float32, use_kernels=False)
MOE_DIMS = dict(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, n_experts=8, top_k=2,
                capacity_factor=4.0, max_seq=16, head_dim=16)
JMCFG = JMoEConfig(**MOE_DIMS, dtype=jnp.float32)
MCFG = MoEConfig(**MOE_DIMS, dtype=torch.float32, use_kernels=False)
SSM_DIMS = dict(vocab=64, d_model=32, n_layers=2, d_state=4, d_conv=3, expand=2)
JSCFG = JSSMConfig(**SSM_DIMS, dtype=jnp.float32)
SCFG = SSMConfig(**SSM_DIMS, dtype=torch.float32)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)
ADAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier runs files in parallel workers: one intra-op thread per worker
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _trainable(params):
    def leaf(x):
        return x.detach().clone().requires_grad_()

    return {"embed": leaf(params["embed"]),
            "layers": {k: leaf(w) for k, w in params["layers"].items()},
            "final_norm": leaf(params["final_norm"])}


def _check_grads(params, jgrads):
    """Every leaf's .grad of the port's tree against the JAX gradient tree."""
    flat = {"embed": jgrads["embed"], "final_norm": jgrads["final_norm"],
            **{f"layers.{k}": g for k, g in jgrads["layers"].items()}}
    assert set(flat) == {path for path, _ in named_leaves(params)}
    for path, p in named_leaves(params):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(flat[path]), **GRAD_TOL,
                                   err_msg=path)


@pytest.fixture(scope="module")
def dense():
    jp = j_init_params(jax.random.key(0), JCFG)
    return jp, _np_tree(jp)


def test_next_token_ce_matches_reference():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 40).astype(np.float32) * 3
    tokens = rng.randint(0, 40, (2, 9)).astype(np.int32)
    want = float(j_next_token_ce(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(next_token_ce(torch.from_numpy(logits), torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_transformer_forward_is_prefills_logits(dense):
    """The training forward computes prefill's logits, with no KV cache."""
    params = params_from_numpy(dense[1], CFG, device="cpu")
    tokens = torch.from_numpy(_tokens(1, (4, 16), DIMS["vocab"]))
    want, _ = prefill(params, CFG, tokens)
    torch.testing.assert_close(transformer_forward(params, CFG, tokens), want, rtol=0, atol=0)
    jwant, _ = j_prefill(dense[0], JCFG, jnp.asarray(tokens.numpy()))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=2e-4)


def test_next_token_loss_and_grads_match_jax(dense):
    tokens = _tokens(1, (4, 16), DIMS["vocab"])
    jloss, jgrads = jax.value_and_grad(j_next_token_loss)(dense[0], JCFG, jnp.asarray(tokens))
    params = _trainable(params_from_numpy(dense[1], CFG, device="cpu"))
    loss = next_token_loss(params, CFG, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _check_grads(params, jgrads)


def test_moe_loss_and_grads_match_jax():
    jp = j_init_moe_params(jax.random.key(0), JMCFG)
    tokens = _tokens(2, (2, 16), MOE_DIMS["vocab"])
    jloss, jgrads = jax.value_and_grad(lambda p: j_moe_loss(p, JMCFG, jnp.asarray(tokens)))(jp)
    params = _trainable(moe_params_from_numpy(_np_tree(jp), MCFG, device="cpu"))
    loss = moe_loss(params, MCFG, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _check_grads(params, jgrads)


def test_ssm_loss_and_grads_match_jax():
    jp = j_init_ssm_params(jax.random.key(0), JSCFG)
    tokens = _tokens(4, (2, 12), SSM_DIMS["vocab"])
    jloss, jgrads = jax.value_and_grad(lambda p: j_ssm_loss(p, JSCFG, jnp.asarray(tokens)))(jp)
    params = _trainable(ssm_params_from_numpy(_np_tree(jp), SCFG, device="cpu"))
    loss = ssm_loss(params, SCFG, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _check_grads(params, jgrads)
    assert any(float(p.grad.abs().max()) > 0 for _, p in named_leaves(params))


@pytest.mark.parametrize("lr", [1e-3, 5e-3])
def test_adamw_step_matches_optax(dense, lr):
    """One step of the port's optimizer against optax.adamw on the same
    parameters and the same numpy gradients, then a second step."""
    rng = np.random.RandomState(7)
    tree = dense[1]
    grads = [jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 1e-2,
                                    tree) for _ in range(2)]
    opt = optax.adamw(lr)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    state, _ = init_train_state(params_from_numpy(tree, CFG, device="cpu"), CFG, None, lr=lr)
    params, optim = state["params"], state["opt_state"]
    for g in grads:
        updates, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat = {"embed": g["embed"], "final_norm": g["final_norm"],
                **{f"layers.{k}": x for k, x in g["layers"].items()}}
        for path, p in named_leaves(params):
            p.grad = torch.from_numpy(flat[path].copy())
        optim.step()
        jflat = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
                 **{f"layers.{k}": x for k, x in jparams["layers"].items()}}
        for path, p in named_leaves(params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jflat[path]),
                                       atol=ADAM_ATOL, rtol=0, err_msg=path)


def test_adamw_has_optax_defaults():
    opt = adamw(1e-3)
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay) == (0.9, 0.999, 1e-8, 1e-4)
    state, _ = init_train_state(
        {"embed": torch.zeros(4, 2), "layers": {"w": torch.zeros(1, 2)},
         "final_norm": torch.ones(2)}, CFG, None)
    group = state["opt_state"].param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert len(group["params"]) == 3  # one group decays every leaf


def test_train_step_reduces_loss_one_device(dense):
    state, opt = init_train_state(params_from_numpy(dense[1], CFG, device="cpu"), CFG, lr=5e-3)
    step = make_train_step(dataclasses.replace(CFG, use_kernels=True), opt)
    tokens = torch.from_numpy(_tokens(1, (4, 16), DIMS["vocab"]))
    state, loss0 = step(state, tokens)
    for _ in range(5):
        state, loss = step(state, tokens)
    assert torch.isfinite(loss) and loss.item() < loss0.item()


def test_moe_and_ssm_train_steps_reduce_loss():
    """SGD on moe_loss and ssm_loss, the reference's train tests' configs."""
    for params, fn, vocab in (
            (moe_params_from_numpy(_np_tree(j_init_moe_params(jax.random.key(0), JMCFG)), MCFG,
                                   device="cpu"),
             lambda p, t: moe_loss(p, MCFG, t), MOE_DIMS["vocab"]),
            (ssm_params_from_numpy(_np_tree(j_init_ssm_params(jax.random.key(0), JSCFG)), SCFG,
                                   device="cpu"),
             lambda p, t: ssm_loss(p, SCFG, t), SSM_DIMS["vocab"])):
        params = _trainable(params)
        tokens = torch.from_numpy(_tokens(1, (4, 16), vocab))
        losses = []
        for _ in range(6):
            loss = fn(params, tokens)
            loss.backward()
            with torch.no_grad():
                for _, p in named_leaves(params):
                    p -= 5e-2 * p.grad
                    p.grad = None
            losses.append(loss.item())
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
