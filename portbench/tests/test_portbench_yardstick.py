"""The yardstick against hand counts: percentiles over every sample, the
union of device intervals, each kernel's bytes and FLOPs for one call,
and the model step's FLOPs."""

import numpy as np
import pytest

from portbench import yardstick as ys


def test_percentile_takes_every_sample():
    vals = list(np.random.default_rng(0).exponential(size=5000))
    for q in (50, 95, 99):
        assert ys.percentile(vals, q) == pytest.approx(float(np.percentile(vals, q)))
    # no window of recent samples: the first ones count as much as the last
    assert ys.percentile([100.0] * 100 + [1.0] * 3000, 99) == 100.0


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert ys.union_ns(iv) == 15 + 10 + 1
    assert ys.union_ns(ys.clip(iv, 8, 28)) == 7 + 8
    assert ys.idle_gaps(iv, 0, 50) == [(10, 30), (9, 41), (5, 15)]


def test_idle_share_of_a_hand_made_trace():
    ops = [(0, 2_000), (1_000, 3_000), (6_000, 7_000), (9_500, 12_000)]
    busy = ys.union_ns(ys.clip(ops, 0, 10_000))
    assert busy == 3_000 + 1_000 + 500
    assert 1 - busy / 10_000 == pytest.approx(0.55)


def test_flash_call_by_hand():
    n, s, h, dh = 2, 4, 3, 8
    nbytes, flops = ys.flash_call(n, s, h, dh)
    assert nbytes == 4 * (n * s * h * dh) * 2  # q, k, v in and o out, bf16
    pairs = 1 + 2 + 3 + 4  # causal query-key pairs of one head
    assert flops == n * h * pairs * (2 * dh + 2 * dh)  # QK^T and PV


def test_paged_row_by_hand():
    nbytes, flops = ys.paged_row(300, h=2, dh=4, page=128)
    keys = 300 * 2 * 4 * 2 * 2  # keys and values, bf16
    assert nbytes == keys + 2 * 2 * 4 * 2 + 3 * 4 + 4  # q and o, 3 table entries, the length
    assert flops == 300 * 2 * (2 * 4 + 2 * 4)


def test_bound_takes_the_slower_roof():
    assert ys.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 989e12) == pytest.approx(1.0)
    assert ys.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


CFG = {"family": "dense", "hidden_size": 8, "num_attention_heads": 2, "head_dim": 4,
       "intermediate_size": 16, "num_hidden_layers": 3, "vocab_size": 100}


def test_model_flops_by_hand():
    per_layer = 4 * 8 * 8 + 3 * 8 * 16
    assert ys.matmul_params_per_token(CFG) == 3 * per_layer
    assert ys.decode_flops(CFG, 10) == 2 * 3 * per_layer + 4 * 3 * 8 * 10 + 2 * 8 * 100
    assert ys.prompt_flops(CFG, 4) == (2 * 3 * per_layer * 4 + 4 * 3 * 8 * (1 + 2 + 3 + 4)
                                       + 2 * 8 * 100)


def test_moe_counts_only_the_chosen_experts():
    moe = dict(CFG, family="moe", num_experts=8, num_experts_per_tok=2)
    assert ys.matmul_params_per_token(moe) == 3 * (4 * 8 * 8 + 2 * 3 * 8 * 16 + 8 * 8)
