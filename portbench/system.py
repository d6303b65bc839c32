"""The system under test, built from a configuration file: the weights the
benchmark makes from the seed, and ``vtpu_torch``'s serving engine over
them. This is the one module of the benchmark that imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vtpu_torch.models import ModelConfig, MoEConfig
from vtpu_torch.serving import ServingConfig, ServingEngine
from vtpu_torch.serving.adapters import MoeSlotModel

# what the port's trunk computes and cannot be told otherwise: a
# configuration asking for anything else cannot run on it
PORT_FIXED = {"rms_norm_eps": 1e-6, "rope_theta": 10000.0, "tie_word_embeddings": True,
              "hidden_act": "silu"}


def check_runnable(cfg: dict) -> None:
    """Refuse a configuration the port cannot serve as stated."""
    for key, want in PORT_FIXED.items():
        if cfg[key] != want:
            raise ValueError(f"the port runs {key}={want!r}; the configuration says {cfg[key]!r}")
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("the port's attention is multi-head: num_key_value_heads must equal "
                         "num_attention_heads")
    if cfg["hidden_size"] != cfg["num_attention_heads"] * cfg["head_dim"]:
        raise ValueError("hidden_size must be num_attention_heads x head_dim")
    if cfg["family"] == "moe" and not cfg["norm_topk_prob"]:
        raise ValueError("the port renormalises the top-k gates: norm_topk_prob must be true")
    if cfg["serving"].get("kv_int8", False):
        raise ValueError("the benchmark's configurations serve bf16 KV")


def model_config(cfg: dict):
    """The port's model config for a configuration file."""
    common = dict(vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
                  n_heads=cfg["num_attention_heads"], n_layers=cfg["num_hidden_layers"],
                  d_ff=cfg["intermediate_size"], max_seq=cfg["serving"]["max_seq"],
                  head_dim=cfg["head_dim"], dtype=torch.bfloat16, kv_int8=False,
                  use_kernels=True)
    if cfg["family"] == "moe":
        return MoEConfig(n_experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
                         capacity_factor=cfg["capacity_factor"], **common)
    return ModelConfig(**common)


def serving_config(cfg: dict, trace_events: int | None = None) -> ServingConfig:
    fields = {f.name for f in dataclasses.fields(ServingConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["serving"].items() if k in fields}
    if trace_events is not None:
        kw["trace_events"] = trace_events
    return ServingConfig(**kw)


def make_params(cfg: dict, seed: int, device) -> dict:
    """Weights in bf16 (the router in f32, as the port keeps it), drawn on
    ``device`` from one generator seeded with ``seed``, one call a stacked
    tensor: N(0, 1 / fan_in) for the matrices, 1 + N(0, 0.1^2) for the
    norms' gains (so a path that skips a gain shows).

    At this init every head averages most of its context, so within a few
    layers the positions of a sequence share most of their hidden state
    and the MoE router sends most tokens to a few experts: past capacity
    at admission lie ~40-50% of the choices. Wider query and key weights
    (sharper heads) keep the positions apart, but make the network
    chaotic: bf16 rounding then moves most greedy tokens, so no reference
    could judge the served ones."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    d, l = cfg["hidden_size"], cfg["num_hidden_layers"]
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    f = cfg["intermediate_size"]

    def w(shape, fan_in, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def gain(shape):
        return torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                           device=device).mul_(0.1).add_(1.0)

    layers = {"wq": w((l, d, qd), d), "wk": w((l, d, qd), d), "wv": w((l, d, qd), d),
              "wo": w((l, qd, d), qd), "attn_norm": gain((l, d)), "mlp_norm": gain((l, d))}
    if cfg["family"] == "moe":
        e = cfg["num_experts"]
        layers.update(router=w((l, d, e), d, torch.float32), w_gate=w((l, e, d, f), d),
                      w_up=w((l, e, d, f), d), w_down=w((l, e, f, d), f))
    else:
        layers.update(w_gate=w((l, d, f), d), w_up=w((l, d, f), d), w_down=w((l, f, d), f))
    return {"embed": w((cfg["vocab_size"], d), d), "layers": layers,
            "final_norm": gain((d,))}


def build_engine(cfg: dict, params: dict, device, trace_events: int | None = None):
    """The engine as the configuration states it (on a card it builds the
    kernels and captures its graphs here)."""
    check_runnable(cfg)
    mcfg = model_config(cfg)
    serving = serving_config(cfg, trace_events)
    if cfg["family"] == "moe":
        model = MoeSlotModel(params, mcfg, kv_page=serving.kv_page,
                             kv_pool_blocks=serving.kv_pool_blocks, device=device)
        return ServingEngine(model=model, serving=serving)
    return ServingEngine(params, mcfg, serving=serving, device=device)


def bucket_of(n: int, buckets) -> int:
    """The admission bucket of an n-token prompt: the smallest that holds it."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"no bucket holds {n} tokens")
