"""The hand-written CUDA kernels of vtpu_torch against their plain PyTorch
versions, on a card. Every case needs a CUDA device and skips without one.

This file imports neither jax nor vtpu, so it runs on a machine that has
only PyTorch: ``pytest --noconftest -m cuda tests/test_torch_kernels.py``.
Tolerances: f32 atol 2e-5 (summation order only); bf16 atol 2e-2 (both
versions round P and the output to bf16, so a value near a rounding
boundary may land one bf16 ulp apart)."""

import numpy as np
import pytest
import torch

from vtpu_torch.ops import _build
from vtpu_torch.ops.attention import flash_attention, flash_attention_ref
from vtpu_torch.ops.decode_attn import paged_decode_attention, paged_decode_attention_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("shape", [(2, 1024, 8, 128), (1, 200, 4, 64), (2, 77, 2, 32)])
def test_flash_kernel_matches_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = _build.launches()["flash_attention"]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.launches()["flash_attention"] == before + 1
    assert _err(got, flash_attention_ref(q, k, v)) <= 2e-2


def test_flash_kernel_reads_strided_views(dev):
    """q, k, v as views into one packed [B, S, 3, H, Dh] projection."""
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 300, 3, 4, 128), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    assert _err(got, want) <= 2e-2
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["flat_t1", "ragged_t3", "poisoned_null"])
def test_paged_kernel_matches_plain(dev, dtype, case):
    rng = np.random.RandomState(2)
    kp = torch.from_numpy(rng.randn(3, 9, 16, 4, 128).astype(np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.randn(3, 9, 16, 4, 128).astype(np.float32)).to(dev, dtype)
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 1]], dtype=torch.int32,
                         device=dev)
    if case == "flat_t1":
        t, lens = 1, [[5], [33], [64]]
    elif case == "ragged_t3":
        t, lens = 3, [[17, 18, 19], [38, 39, 40], [62, 63, 64]]
    else:
        kp[:, 0], vp[:, 0] = 1e3, -1e3
        t, lens = 1, [[3], [20], [50]]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.randn(3, t, 4, 128).astype(np.float32)).to(dev, dtype)
    for layer in (0, 2):
        got = paged_decode_attention(q, kp, vp, table, kv_len, layer)
        torch.cuda.synchronize()
        want = paged_decode_attention_ref(q, kp, vp, table, kv_len, layer)
        assert _err(got, want) <= (2e-2 if dtype == torch.bfloat16 else 2e-5)
