"""95th percentile of an admission's time on the loop's stream over every
request due in the window: the milliseconds between the engine's CUDA
events around the admission dispatch that took the request (its whole
batch's, read at the fetch of its first token; the trace ring's
``prefill_device_ms``). A span of the stream, not the card's busy time:
where the host enqueues the admission's kernels more slowly than the card
runs them, the card's waits for the host are inside it
(``idle_admission_share`` sees them in a traced run).
In a traced run: the part of the window before the profiler starts."""

from portbench.yardstick import percentile


def read(run):
    if run.spans is None:
        return None
    took = [run.spans[r.rid]["prefill_device_ms"] for r in run.quiet_sample()
            if "prefill_device_ms" in run.spans.get(r.rid, {})]
    return percentile(took, 95) if took else None
