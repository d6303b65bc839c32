"""Serving-engine observability of the port (counterpart of vtpu/obs): the
request-lifecycle trace and the tick-phase profiler, both host-side (nothing
here touches the device, so tracing adds no device sync).

- trace.py:    a lock-light bounded ring of lifecycle events (submit ..
               retire) with derived per-request spans, JSONL export, a
               Chrome ``trace_event`` dump, and the ITL/TTFT/queue-wait
               reservoirs the engine's ``stats()`` percentiles read.
- tickprof.py: per-tick decode-loop phase attribution (admission, dispatch,
               fetch, deliver, swap drain) into bounded histograms: where
               ``host_ms_per_tick`` goes.
"""

from vtpu_torch.obs.tickprof import BoundedHistogram, TickProfiler
from vtpu_torch.obs.trace import RequestTrace, pct

__all__ = ["BoundedHistogram", "RequestTrace", "TickProfiler", "pct"]
