"""Serving-engine observability of the port (counterpart of vtpu/obs): the
request-lifecycle trace, the tick-phase profiler and the ``vtpu_serving_*``
exporter, all host-side (nothing here touches the device, so tracing adds
no device sync).

- trace.py:    a lock-light bounded ring of lifecycle events (submit ..
               retire) with derived per-request spans, JSONL export, a
               Chrome ``trace_event`` dump, and the ITL/TTFT/queue-wait
               reservoirs the engine's ``stats()`` percentiles read.
- tickprof.py: per-tick decode-loop phase attribution (admission, dispatch,
               fetch, deliver, swap drain) into bounded histograms: where
               ``host_ms_per_tick`` goes.
- export.py:   the ``vtpu_serving_*`` Prometheus family set over
               ``ServingEngine.stats()`` and the span/phase histograms; its
               mapping tables import without ``prometheus_client``.
- summary.py:  the one-line stdout summary a benchmark ends with.
"""

from vtpu_torch.obs.summary import print_summary, summary_line
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
    "RequestTrace",
    "ServingCollector",
    "TickProfiler",
    "pct",
    "print_summary",
    "serving_families",
    "summary_line",
]
