"""Tiny cells for the CPU: the benchmark's configurations at toy widths,
the chat and closed-loop mixes at toy lengths."""

import copy

from portbench import catalog


def tiny_cfg(family: str) -> dict:
    cfg = copy.deepcopy(catalog.config("olmoe-1b-7b" if family == "moe" else "deepseek-llm-7b"))
    cfg.update(hidden_size=64, intermediate_size=96, num_attention_heads=2,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=257, head_dim=32)
    if family == "moe":
        cfg.update(num_experts=8, num_experts_per_tok=2)
    cfg["serving"].update(max_seq=256, slots=4, kv_page=16, kv_pool_blocks=64,
                          prefill_buckets=[32, 64, 128], prefill_batch_sizes=[1, 2])
    return cfg


def tiny_cell(family: str, loop: str, limits=None) -> dict:
    mix = {"loop": loop, "clients": 3, "warmup_s": 0.5, "drain_s": 60,
           "prompt_tokens": {"dist": "lognormal", "median": 40, "sigma": 0.8, "min": 8,
                             "max": 128},
           "output_tokens": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4,
                             "max": 24}}
    name = f"tiny-{family}.{loop}"
    e2e = [{"name": n, "unit": "ms"} for n in ("ttft_p50_ms", "itl_p95_ms")]
    e2e += [{"name": "tokens_per_s", "unit": "tokens/s"}, {"name": "setup_s", "unit": "s"}]
    per_layer = [{"name": n, "unit": "x", "moves": "setup_s"}
                 for n in ("queue_wait_p95_ms.chat", "prefill_exec_p95_ms.chat",
                           "host_ms_per_tick.chat", "decode_step_ms.decode", "mfu.chat")]
    bench = {"workloads": [{"name": name}], "end_to_end": e2e, "per_layer": per_layer}
    return {"name": name, "chips": 1, "cfg": tiny_cfg(family), "mix": mix, "bench": bench,
            "params": {"rate_per_s": 4.0, "sample_requests": 3, "min_tokens": 8,
                       "limits": limits or {"max_logit_gap": 0.25}}}
