"""Primitive ops of the PyTorch/CUDA port (counterpart of vtpu/ops).

Plain PyTorch for everything XLA fused on the TPU, and a hand-written Hopper
kernel for each single-device Pallas kernel: ``flash_attention`` (prefill),
``paged_decode_attention`` and ``paged_decode_attention_int8kv`` (decode over
the paged pool, bf16 and int8) and ``decode_attention`` (the dense-cache
study, bf16 and int8), each with its plain version beside it."""

from vtpu_torch.ops.init import scaled_normal
from vtpu_torch.ops.norms import rms_norm
from vtpu_torch.ops.rope import apply_rope, rope_angles
from vtpu_torch.ops.attention import (
    causal_attention,
    causal_attention_int8kv,
    flash_attention,
    flash_attention_ref,
    gather_kv_pages,
    paged_causal_attention,
    paged_causal_attention_int8kv,
)
from vtpu_torch.ops.decode_attn import (
    PAGED_ATTN_ROUTES,
    decode_attention,
    decode_attention_ref,
    paged_attn_route,
    paged_decode_attention,
    paged_decode_attention_int8kv,
    paged_decode_attention_int8kv_ref,
    paged_decode_attention_ref,
)

__all__ = [
    "scaled_normal",
    "rms_norm",
    "apply_rope",
    "rope_angles",
    "causal_attention",
    "causal_attention_int8kv",
    "flash_attention",
    "flash_attention_ref",
    "gather_kv_pages",
    "paged_causal_attention",
    "paged_causal_attention_int8kv",
    "PAGED_ATTN_ROUTES",
    "decode_attention",
    "decode_attention_ref",
    "paged_attn_route",
    "paged_decode_attention",
    "paged_decode_attention_int8kv",
    "paged_decode_attention_int8kv_ref",
    "paged_decode_attention_ref",
]
