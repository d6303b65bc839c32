"""Model families of the port (counterpart of vtpu/models): the dense
transformer. MoE and SSM are later slices."""

from vtpu_torch.models.transformer import (
    ModelConfig,
    Params,
    decode_layer_loop,
    decode_step,
    filter_logits,
    greedy_generate,
    init_kv_cache,
    init_paged_kv_cache,
    init_params,
    kv_bytes_per_token,
    kv_keys,
    kv_quantized,
    prefill,
    quantize_kv,
    sample_tokens,
    spec_verify_loop,
    store_kv,
    transformer_layer,
)

__all__ = [
    "ModelConfig",
    "Params",
    "decode_layer_loop",
    "decode_step",
    "filter_logits",
    "greedy_generate",
    "init_kv_cache",
    "init_paged_kv_cache",
    "init_params",
    "kv_bytes_per_token",
    "kv_keys",
    "kv_quantized",
    "prefill",
    "quantize_kv",
    "sample_tokens",
    "spec_verify_loop",
    "store_kv",
    "transformer_layer",
]
