"""Primitive ops of the PyTorch/CUDA port (counterpart of vtpu/ops).

Plain PyTorch for everything XLA fused on the TPU, and a hand-written Hopper
kernel for each Pallas kernel on the serving path: ``flash_attention``
(prefill) and ``paged_decode_attention`` (decode over the paged pool), each
with its plain version beside it."""

from vtpu_torch.ops.init import scaled_normal
from vtpu_torch.ops.norms import rms_norm
from vtpu_torch.ops.rope import apply_rope, rope_angles
from vtpu_torch.ops.attention import (
    causal_attention,
    flash_attention,
    flash_attention_ref,
    gather_kv_pages,
    paged_causal_attention,
)
from vtpu_torch.ops.decode_attn import (
    PAGED_ATTN_ROUTES,
    paged_attn_route,
    paged_decode_attention,
    paged_decode_attention_ref,
)

__all__ = [
    "scaled_normal",
    "rms_norm",
    "apply_rope",
    "rope_angles",
    "causal_attention",
    "flash_attention",
    "flash_attention_ref",
    "gather_kv_pages",
    "paged_causal_attention",
    "PAGED_ATTN_ROUTES",
    "paged_attn_route",
    "paged_decode_attention",
    "paged_decode_attention_ref",
]
