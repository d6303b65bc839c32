"""Serving-engine observability of the port (counterpart of vtpu/obs): the
request-lifecycle trace, the tick-phase profiler and the ``vtpu_serving_*``
exporter, all host-side (nothing here touches the device, so tracing adds
no device sync).

- trace.py:    a lock-light bounded ring of lifecycle events (submit ..
               retire) with derived per-request spans, JSONL export, a
               Chrome ``trace_event`` dump, and the ITL/TTFT/queue-wait
               reservoirs the engine's ``stats()`` percentiles read.
- fleettrace.py: the fleet half: stitched cross-engine request journeys
               (the token-conservation contract), the fleet control-event
               ring, the dead engine's flight recorder and the merged
               multi-engine Chrome dump.
- tickprof.py: per-tick decode-loop phase attribution (admission, dispatch,
               fetch, deliver, swap drain, idle, hook) into bounded
               histograms: where ``host_ms_per_tick`` goes; with the ring
               on, the same phases as spans on its engine-loop track.
- devtime.py:  device time of the loop's dispatches (an admission, a decode
               tick, an MoE admission's stages), read at fetches the loop
               makes anyway (imports torch; not imported here).
- export.py:   the ``vtpu_serving_*`` Prometheus family set over
               ``ServingEngine.stats()`` and the span/phase histograms, and
               the ``vtpu_serving_fleet_*`` set over ``EngineFleet.stats()``;
               its mapping tables import without ``prometheus_client``.
"""

from vtpu_torch.obs.fleettrace import FleetTrace
from vtpu_torch.obs.tickprof import BoundedHistogram, TickProfiler
from vtpu_torch.obs.trace import RequestTrace, pct

try:  # the exporter needs prometheus_client; tracing and profiling do not:
    # the serving engine stays importable without the monitor's packages
    from vtpu_torch.obs.export import ServingCollector, serving_families
except ImportError:  # pragma: no cover
    ServingCollector = None  # type: ignore[assignment,misc]
    serving_families = None  # type: ignore[assignment]

__all__ = [
    "BoundedHistogram",
    "FleetTrace",
    "RequestTrace",
    "ServingCollector",
    "TickProfiler",
    "pct",
    "serving_families",
]
