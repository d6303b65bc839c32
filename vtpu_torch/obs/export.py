"""The unified ``vtpu_serving_*`` Prometheus exporter of the port
(counterpart of the engine half of vtpu/obs/export.py).

Every ``ServingEngine.stats()`` counter and gauge maps to a
``vtpu_serving_*`` family labelled by engine name, beside the span and
phase histograms of the trace substrate (TTFT, ITL, queue wait, prefill
exec, tick phases). ``ServingCollector`` registers directly or hands its
families to a monitor's collector, so one scrape serves the device's and
the engine's telemetry.

The mapping tables are EXHAUSTIVE and statically checkable: the coverage
test walks a live engine's stats() keys and fails on any key that is
neither mapped nor allowlisted. They carry the reference's entries
unchanged, the keys of features the port has not reached included (a key
an engine does not report skips its sample, the family is still
emitted), plus the port's own: the kernel wrappers' launch counters and
``graphs_captured``. The fleet's families come with the fleet.

The tables import without ``prometheus_client``; building families needs
it, and imports it at first use.
"""

from __future__ import annotations

import threading
from typing import Iterable

try:
    from prometheus_client.registry import Collector
except ImportError:  # pragma: no cover - the tables serve without the client
    Collector = object  # type: ignore[assignment,misc]

PREFIX = "vtpu_serving_"

# stats() key -> (family suffix, help). Monotonic counters.
COUNTERS = {
    "generated_tokens": ("tokens_generated", "Tokens delivered to clients"),
    "decode_ticks": ("decode_ticks", "Plain decode dispatches"),
    "spec_ticks": ("spec_ticks", "Speculative verify dispatches"),
    "spec_slot_ticks": ("spec_slot_ticks",
                        "Slot participations in spec ticks"),
    "spec_emitted": ("spec_emitted_tokens",
                     "Tokens delivered by speculative ticks"),
    "prefill_chunks": ("prefill_chunks", "Chunked-prefill dispatches"),
    "admissions": ("admissions", "Requests that began service"),
    "device_gets": ("device_gets", "Batched device->host fetches"),
    "bytes_fetched": ("fetched_bytes", "Device->host payload bytes"),
    "tick_fetches": ("tick_fetches", "Tick-delivery fetches"),
    "admission_fetches": ("admission_fetches",
                          "Standalone idle-engine admission fetches"),
    "admission_syncs": ("admission_syncs",
                        "Blocking per-admission host syncs (legacy path)"),
    "pipelined_ticks": ("pipelined_ticks",
                        "Ticks dispatched with one tick in flight"),
    "loop_flushes": ("loop_flushes",
                     "k-tick device-loop flush dispatches"),
    "loop_early_exits": ("loop_early_exits",
                         "Slots frozen inside a device-loop flush "
                         "(budget wall or eos before tick k)"),
    "fused_flushes": ("fused_spec_flushes",
                      "Device-loop flushes that ran the fused "
                      "draft+verify speculation body"),
    "pool_blocked_admissions": ("pool_blocked_admissions",
                                "Admissions deferred by pool exhaustion"),
    "prefix_install_copies": ("prefix_install_copies",
                              "Dense full-prefix device copies"),
    "prefix_blocks_shared": ("prefix_blocks_shared",
                             "Pool blocks mapped read-only at admission"),
    "prefix_cow_copies": ("prefix_cow_copies",
                          "Prefix boundary-block copy-on-writes"),
    "prefix_hits": ("prefix_hits",
                    "Admissions that attached a registered prefix"),
    "prefix_misses": ("prefix_misses",
                      "Prefix submits whose registration was gone"),
    "prefix_exports": ("prefix_exports",
                       "Prefix KV exports through the staged D2H gather"),
    "prefix_tier_installs": ("prefix_tier_installs",
                             "Prefixes installed from a serialized payload "
                             "(host tier or cross-engine copy)"),
    "failover_prefix_reuses": ("failover_prefix_reuses",
                               "Failover recomputes that shared resident "
                               "prefix blocks and replayed only the "
                               "private tail"),
    "read_pages_live": ("read_pages_live",
                        "Live pages gathered by decode reads"),
    "read_pages_window": ("read_pages_window",
                          "Window pages spanned by decode reads"),
    "paged_attn_kernel_ticks": ("paged_attn_kernel_ticks",
                                "Ticks routed to the fused paged-attention "
                                "kernel (table walked in place)"),
    "paged_attn_gather_ticks": ("paged_attn_gather_ticks",
                                "Ticks routed to the gather-then-dense "
                                "paged-attention chain"),
    "parks": ("parks", "Sessions taken out of the decode batch"),
    "resumes": ("resumes", "Parked sessions brought back"),
    "evicted_blocks": ("evicted_blocks",
                       "Pool blocks reclaimed from parked sessions"),
    "swap_out_bytes": ("swap_out_bytes", "KV bytes spilled to the host tier"),
    "swap_in_bytes": ("swap_in_bytes", "KV bytes restored from the host tier"),
    "swap_faults": ("swap_faults",
                    "Resumes whose pages were not pool-resident"),
    "fault_recomputes": ("fault_recomputes",
                         "Faulted resumes rebuilt through prefill"),
    "pool_blocked_resumes": ("pool_blocked_resumes",
                             "Resume retries the pool could not yet cover"),
    "trace_events_recorded": ("trace_events_recorded",
                              "Lifecycle events recorded into the trace ring"),
    "trace_events_dropped": ("trace_events_dropped",
                             "Lifecycle events the bounded ring overwrote"),
    "handoffs": ("handoffs",
                 "Prefill-worker sessions handed to the decode loop"),
    "handoff_copies": ("handoff_copies",
                       "Device copies performed by handoffs (contract: 0)"),
    "repartitions": ("repartitions",
                     "Disagg controller prefill-share level changes"),
    "shed_deadline": ("shed_deadline",
                      "Requests shed past their submit deadline"),
    "shed_overload": ("shed_overload",
                      "Requests shed by the overload policy"),
    "faulted_requests": ("faulted_requests",
                         "Requests a contained failure terminated"),
    "worker_restarts": ("worker_restarts",
                        "Dead prefill workers the supervisor replaced"),
    "watchdog_degrades": ("watchdog_degrades",
                          "Fetch-watchdog degradation-ladder steps"),
    "watchdog_recoveries": ("watchdog_recoveries",
                            "Watchdog ladder rungs restored after the "
                            "recovery grace window"),
    "faults_injected": ("faults_injected",
                        "Deterministic FaultPlan injections fired"),
    "migrations_out": ("migrations_out",
                       "Sessions extracted by live cross-engine migration"),
    "migrations_in": ("migrations_in",
                      "Sessions installed by live cross-engine migration"),
    "migrate_out_bytes": ("migrate_out_bytes",
                          "KV payload bytes shipped by outbound migrations"),
    "migrate_in_bytes": ("migrate_in_bytes",
                         "KV payload bytes landed by inbound migrations"),
    "migration_copies": ("migration_copies",
                         "Device copies by the migration path beyond the "
                         "staging D2H/H2D pair (contract: 0)"),
    "migrate_recomputes": ("migrate_recomputes",
                           "Migrations installed payload-less, rebuilt "
                           "via the recompute-on-fault prefill path"),
    "migrate_failures": ("migrate_failures",
                         "Migrations that could neither transfer nor "
                         "rebuild (typed FAULTED terminals)"),
    # the port's own: each kernel wrapper's process-wide launch count (a
    # CUDA graph replay adds the launches its capture recorded)
    "flash_launches": ("flash_launches",
                       "Flash-attention prefill kernel launches"),
    "paged_attn_launches": ("paged_attn_launches",
                            "Paged decode-attention kernel launches "
                            "(bf16 pool, one device)"),
    "paged_attn_int8kv_launches": ("paged_attn_int8kv_launches",
                                   "Paged decode-attention kernel launches "
                                   "(int8 pool, one device)"),
    "paged_attn_tp_launches": ("paged_attn_tp_launches",
                               "Head-local paged decode-attention kernel "
                               "launches at T = 1 (bf16 pool, mesh=)"),
    "paged_attn_int8kv_tp_launches": ("paged_attn_int8kv_tp_launches",
                                      "Head-local paged decode-attention "
                                      "kernel launches at T = 1 (int8 pool, "
                                      "mesh=)"),
    "paged_attn_tp_verify_launches": ("paged_attn_tp_verify_launches",
                                      "Head-local paged decode-attention "
                                      "kernel launches at T > 1 (bf16 pool, "
                                      "mesh=)"),
    "paged_attn_int8kv_tp_verify_launches": (
        "paged_attn_int8kv_tp_verify_launches",
        "Head-local paged decode-attention kernel launches at T > 1 (int8 "
        "pool, mesh=)"),
    "decode_attn_launches": ("decode_attn_launches",
                             "Dense decode-attention kernel launches (bf16 "
                             "cache)"),
    "decode_attn_int8kv_launches": ("decode_attn_int8kv_launches",
                                    "Dense decode-attention kernel launches "
                                    "(int8 cache)"),
}

# stats() key -> (family suffix, help, scale). Point-in-time gauges; a
# None value skips the sample (family still emitted). Booleans export 0/1.
GAUGES = {
    "active_slots": ("active_slots", "Slots with a live request", 1),
    "admitting_slots": ("admitting_slots", "Slots mid-chunked-admission", 1),
    "queued": ("queued_requests", "Requests waiting for a slot", 1),
    "registered_prefixes": ("registered_prefixes",
                            "Live shared-prefix registrations", 1),
    "prefix_shared_blocks": ("prefix_shared_blocks",
                             "Pool blocks currently mapped read-only from "
                             "prefix registrations (live slots + parked)",
                             1),
    "parked_sessions": ("parked_sessions", "Sessions in the parked set", 1),
    "device_gets_per_tick": ("device_gets_per_tick",
                             "Tick fetches / ticks (contract: 1.0)", 1),
    "bytes_fetched_per_tick": ("bytes_fetched_per_tick",
                               "Fetched bytes / ticks", 1),
    "host_ms_per_tick": ("host_seconds_per_tick",
                         "EMA host bookkeeping per delivered tick", 1e-3),
    "decode_loop_k": ("decode_loop_k",
                      "Inner decode ticks per compiled flush (1 = classic "
                      "loop)", 1),
    "device_gets_per_token": ("device_gets_per_token",
                              "Tick fetches / inner decode ticks "
                              "(contract: 1/decode_loop_k)", 1),
    "host_ms_per_token": ("host_seconds_per_token",
                          "EMA host bookkeeping amortized per token-step "
                          "(host_ms_per_tick / decode_loop_k)", 1e-3),
    "admission_stall_ms": ("admission_stall_seconds",
                           "EMA host seconds per _tick_head pass", 1e-3),
    "itl_p50_ms": ("itl_p50_seconds",
                   "Inter-token latency p50 (trace reservoir)", 1e-3),
    "itl_p99_ms": ("itl_p99_seconds",
                   "Inter-token latency p99 (trace reservoir)", 1e-3),
    "ttft_p50_ms": ("ttft_p50_seconds",
                    "Time to first token p50 (trace reservoir)", 1e-3),
    "ttft_p95_ms": ("ttft_p95_seconds",
                    "Time to first token p95 (trace reservoir)", 1e-3),
    "ttft_p99_ms": ("ttft_p99_seconds",
                    "Time to first token p99 (trace reservoir)", 1e-3),
    "queue_wait_p50_ms": ("queue_wait_p50_seconds",
                          "Submit->admit wait p50 (trace reservoir)", 1e-3),
    "queue_wait_p99_ms": ("queue_wait_p99_seconds",
                          "Submit->admit wait p99 (trace reservoir)", 1e-3),
    "prefill_exec_p50_ms": ("prefill_exec_p50_seconds",
                            "Queue-depart->first-token p50 (TTFT split)",
                            1e-3),
    "prefill_exec_p99_ms": ("prefill_exec_p99_seconds",
                            "Queue-depart->first-token p99 (TTFT split)",
                            1e-3),
    "mean_emitted_per_spec_tick": ("spec_mean_emitted_per_slot_tick",
                                   "Delivered tokens per spec slot-tick", 1),
    "spec_ema": ("spec_ema", "Adaptive-speculation acceptance EMA", 1),
    "spec_cooling_off": ("spec_cooling_off",
                         "1 while adaptive speculation is paused", 1),
    "fused_spec": ("fused_spec",
                   "1 when draft+verify run fused inside the device loop",
                   1),
    "device_sampling": ("device_sampling", "1 when sampling runs on device", 1),
    "pipelined": ("pipelined", "1 when the decode loop is pipelined", 1),
    "batched_admission": ("batched_admission",
                          "1 when admission is batched/async", 1),
    "paged": ("paged", "1 when the KV cache is a paged pool", 1),
    "disagg": ("disagg",
               "1 when prefill/decode are disaggregated roles", 1),
    "draining": ("draining",
                 "1 while admission is closed for a drain/redeploy", 1),
    "prefill_backlog": ("prefill_backlog",
                        "Requests queued or mid-prefill on the worker side",
                        1),
    "prefill_share_tokens": ("prefill_share_tokens",
                             "Current prefill partition (tokens per tick)",
                             1),
    "trace_enabled": ("trace_enabled",
                      "1 while the lifecycle event ring records", 1),
    "trace_ring_capacity": ("trace_ring_capacity",
                            "Bounded event-ring capacity (0 = disabled)", 1),
    "trace_ring_utilization": ("trace_ring_utilization",
                               "Live events / ring capacity — at 1.0 the "
                               "ring wraps and stitched journeys/spans may "
                               "silently truncate", 1),
    "kv_page": ("kv_page_tokens", "Tokens per KV block (None = dense)", 1),
    "tp": ("tp_degree", "Tensor-parallel degree", 1),
    "kv_pool_blocks": ("kv_pool_blocks", "Usable pool blocks", 1),
    "kv_pool_free": ("kv_pool_free_blocks", "Free pool blocks", 1),
    "kv_pool_used": ("kv_pool_used_blocks", "Allocated pool blocks", 1),
    "kv_pool_used_hwm": ("kv_pool_used_blocks_hwm",
                         "Lifetime allocated-blocks high water", 1),
    "kv_pool_occupancy": ("kv_pool_occupancy_ratio",
                          "Allocated / usable pool blocks", 1),
    "read_pages_ratio": ("read_pages_live_ratio",
                         "Live / window pages per decode read", 1),
    "kv_swap": ("kv_swap_blocks", "Configured host swap tier (blocks)", 1),
    "swap_host_blocks": ("swap_host_blocks", "Host swap tier capacity", 1),
    "swap_host_free": ("swap_host_free_blocks", "Free host swap blocks", 1),
    # the port's own: CUDA graphs the engine captured when it was built
    # (none on the CPU or under a mesh)
    "graphs_captured": ("graphs_captured",
                        "CUDA graphs captured at engine construction", 1),
}

# stats() key -> (family suffix, help, label). Bounded index->count maps
# (python list: label = index; dict: label = key), exported as labelled
# counters.
HIST_COUNTERS = {
    "spec_emitted_hist": ("spec_emitted_per_slot_tick",
                          "Spec slot-ticks by delivered-token count",
                          "emitted"),
    "fused_k_hist": ("fused_spec_flush_depth",
                     "Fused-speculation flushes by the LoopPolicy-picked "
                     "window k", "k"),
    "prefill_batch_hist": ("prefill_dispatches",
                           "Bucketed prefill dispatches by batch size",
                           "batch_size"),
    "kv_bucket_hist": ("kv_read_window_ticks",
                       "Dispatched ticks by KV read-window bucket",
                       "window_tokens"),
    "read_pages_hist": ("read_pages_ticks",
                        "Dispatched ticks by gathered live-page count",
                        "live_pages"),
}

# Keys the exporter handles specially (labelled gauges / histogram
# families built from the trace substrate) or deliberately does not export
# (free-form composites a flat family cannot carry). The coverage test
# accepts a key if it appears in any table above or here.
SPECIAL = {
    "kv_hbm_bytes",            # -> vtpu_serving_kv_hbm_bytes{layout=...}
    "kv_hbm_bytes_per_chip",   # -> ..._per_chip{layout=...}
    "tick_phase_ms",           # -> vtpu_serving_tick_phase_seconds{phase=...}
}
# Escape hatch for the coverage check: stats() keys that are DELIBERATELY
# not exported go here, with a reason.
ALLOWLIST: set = {
    "spec_disabled_reason",  # free-form string: diagnosable from stats()/
                             # trace ("spec_disabled" event), not a metric
    "loop_policy",           # policy class name (string) — config echo
}


def _hist_family(name: str, help_: str, label: str, per_engine: dict):
    """ONE family carrying every engine's samples: a family per engine
    would repeat the family name once a second engine registers (an
    invalid exposition)."""
    from prometheus_client.core import CounterMetricFamily

    fam = CounterMetricFamily(PREFIX + name, help_, labels=("engine", label))
    for engine, data in per_engine.items():
        items = (enumerate(data) if isinstance(data, list)
                 else sorted(data.items()))
        for key, count in items:
            if count:
                fam.add_metric((engine, str(key)), float(count))
    return fam


def serving_families(sources: dict[str, object]) -> Iterable:
    """Yield the full ``vtpu_serving_*`` family set for *sources*
    ({engine_name: ServingEngine-like}). Each family carries one sample
    per engine under the ``engine`` label; engines expose ``stats()`` and
    (optionally) ``trace`` / ``tick_profile``."""
    from prometheus_client.core import (
        CounterMetricFamily,
        GaugeMetricFamily,
        HistogramMetricFamily,
    )

    snaps = {name: eng.stats() for name, eng in sources.items()}
    for key, (suffix, help_) in COUNTERS.items():
        fam = CounterMetricFamily(PREFIX + suffix, help_, labels=("engine",))
        for name, s in snaps.items():
            v = s.get(key)
            if v is not None:
                fam.add_metric((name,), float(v))
        yield fam
    for key, (suffix, help_, scale) in GAUGES.items():
        fam = GaugeMetricFamily(PREFIX + suffix, help_, labels=("engine",))
        for name, s in snaps.items():
            v = s.get(key)
            if v is not None:
                fam.add_metric((name,), float(v) * scale)
        yield fam
    for key, (suffix, help_, label) in HIST_COUNTERS.items():
        yield _hist_family(
            suffix, help_, label,
            {name: s[key] for name, s in snaps.items()
             if s.get(key) is not None})
    for key in ("kv_hbm_bytes", "kv_hbm_bytes_per_chip"):
        fam = GaugeMetricFamily(
            PREFIX + key,
            "Estimated KV HBM bytes by cache layout"
            + (" (per chip under a tp mesh)" if "chip" in key else ""),
            labels=("engine", "layout"))
        for name, s in snaps.items():
            for layout, v in (s.get(key) or {}).items():
                if v is not None:
                    fam.add_metric((name, layout), float(v))
        yield fam
    # span/phase histograms straight off the trace substrate (monotonic
    # bucket counters, not the bounded percentile reservoirs)
    span_hists = (
        ("ttft_seconds", "Time to first token", "ttft_hist"),
        ("itl_seconds", "Inter-token latency", "itl_hist"),
        ("queue_wait_seconds", "Submit->admit queue wait", "queue_wait_hist"),
        ("prefill_exec_seconds", "Queue-depart to first token",
         "prefill_exec_hist"),
    )
    for suffix, help_, attr in span_hists:
        fam = HistogramMetricFamily(PREFIX + suffix, help_, labels=("engine",))
        for name, eng in sources.items():
            hist = getattr(getattr(eng, "trace", None), attr, None)
            if hist is not None:
                buckets, total = hist.prom_buckets()
                fam.add_metric((name,), buckets, total)
        yield fam
    fam = HistogramMetricFamily(
        PREFIX + "tick_phase_seconds",
        "Per-tick decode-loop host time by phase",
        labels=("engine", "phase"))
    for name, eng in sources.items():
        prof = getattr(eng, "tick_profile", None)
        if prof is not None:
            for phase, hist in prof.phases.items():
                buckets, total = hist.prom_buckets()
                fam.add_metric((name, phase), buckets, total)
    yield fam


class ServingCollector(Collector):
    """A prometheus Collector over a registry of live engines. Register it
    directly, or hand it to a monitor's collector (``serving=``) so one
    scrape endpoint serves the device's and the engines' telemetry."""

    def __init__(self, engines: dict[str, object] | None = None):
        self._lock = threading.Lock()
        self._engines: dict[str, object] = dict(engines or {})

    def register_engine(self, name: str, engine) -> None:
        with self._lock:
            self._engines[name] = engine

    def unregister_engine(self, name: str) -> None:
        with self._lock:
            self._engines.pop(name, None)

    def collect(self):
        with self._lock:
            sources = dict(self._engines)
        yield from serving_families(sources)
