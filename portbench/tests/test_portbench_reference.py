"""The plain reference against the port's own plain CPU path (f32, no
kernels) at a tiny dense and a tiny MoE size: the same weights, the same
tokens, the same logits; for the MoE an admission batch of two rows with
right padding and a capacity that drops choices, as the engine admits."""

import dataclasses

import pytest
import torch

from portbench import system
from portbench.reference import model as ref
from tiny import tiny_cfg
from vtpu_torch.models.moe import moe_prefill
from vtpu_torch.models.transformer import transformer_forward


def _f32(params):
    return {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
            "layers": {k: v.float() for k, v in params["layers"].items()}}


def _port_cfg(cfg):
    return dataclasses.replace(system.model_config(cfg), dtype=torch.float32,
                               use_kernels=False)


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_dense_reference_matches_the_port(seed):
    cfg = tiny_cfg("dense")
    params = _f32(system.make_params(cfg, seed, "cpu"))
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg["vocab_size"], (1, 50), generator=gen)
    port = transformer_forward(params, _port_cfg(cfg), tok)[0]
    mine, dropped = ref.logits(cfg, params, [tok[0]], [50], 64, 0, 0, 50)
    assert dropped == 0
    assert torch.allclose(mine, port, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [1.0, 2.0])
def test_moe_reference_matches_the_port_admission(capacity_factor):
    cfg = dict(tiny_cfg("moe"), capacity_factor=capacity_factor)
    params = _f32(system.make_params(cfg, 5, "cpu"))
    bucket, lens = 64, [60, 33]
    gen = torch.Generator().manual_seed(1)
    rows = [torch.randint(0, cfg["vocab_size"], (n,), generator=gen) for n in lens]
    padded = torch.zeros((2, bucket), dtype=torch.long)
    for i, r in enumerate(rows):
        padded[i, :lens[i]] = r
    port, _ = moe_prefill(params, _port_cfg(cfg), padded, true_len=torch.tensor(lens))
    drops = []
    for i, n in enumerate(lens):
        mine, dropped = ref.logits(cfg, params, rows, lens, bucket, i, 0, n)
        drops.append(dropped)
        assert torch.allclose(mine, port[i, :n], atol=2e-5, rtol=1e-5)
    if capacity_factor == 1.0:
        assert drops[0] > 0  # the comparison covered choices past capacity


def test_moe_reference_routes_decoded_tokens_without_capacity():
    cfg = dict(tiny_cfg("moe"), capacity_factor=0.25)
    params = _f32(system.make_params(cfg, 9, "cpu"))
    tok = torch.randint(0, cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(2))
    # 30 prompt tokens claim capacity, the 10 after them do not: with no
    # claiming token the whole sequence routes freely
    free, d0 = ref.logits(cfg, params, [tok], [0], 32, 0, 30, 40)
    port = moe_prefill(params, _port_cfg(cfg), tok[None])[0][0]
    assert d0 == 0 and torch.allclose(free, port[30:40], atol=2e-5, rtol=1e-5)


def test_fp8_control_departs_from_the_reference():
    cfg = tiny_cfg("dense")
    params = system.make_params(cfg, 3, "cpu")
    tok = torch.randint(0, cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(4))
    exact, _ = ref.logits(cfg, params, [tok], [40], 64, 0, 0, 40)
    fp8, _ = ref.logits(cfg, params, [tok], [40], 64, 0, 0, 40, fp8=True)
    err = (fp8 - exact).abs().max()
    assert 1e-3 < err < 1.0
