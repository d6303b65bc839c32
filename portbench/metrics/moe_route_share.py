"""Percent of the MoE block's time on the loop's stream at admission spent
outside the experts' GEMMs: the route, the dispatch einsum and the
combine einsum, over those and the experts (the engine's
``moe_stage_device_ms``, each stage between CUDA events, summed over the
layers of every admission). Spans of the stream: a stage of many small
kernels that the host enqueues more slowly than the card runs them (the
route's) holds the card's waits for the host.
In a traced run: the part of the window before the profiler starts."""


def read(run):
    s0, s1 = run.stats0.get("moe_stage_device_ms"), run.stats1.get("moe_stage_device_ms")
    if not s0 or not s1:
        return None
    d = {k: s1[k] - s0[k] for k in s1}
    total = sum(d.values())
    return 100.0 * (d["route"] + d["dispatch"] + d["combine"]) / total if total > 0 else None
