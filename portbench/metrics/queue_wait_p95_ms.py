"""95th percentile of the wait in the engine's line (the trace ring's
submit -> queue_depart) over every request due in the window.
In a traced run: the part of the window before the profiler starts."""

from portbench.yardstick import percentile


def read(run):
    if run.spans is None:
        return None
    waits = []
    for r in run.quiet_sample():
        s = run.spans.get(r.rid)
        if s and s["submit_ns"] is not None and s["queue_depart_ns"] is not None:
            waits.append((s["queue_depart_ns"] - s["submit_ns"]) / 1e6)
    return percentile(waits, 95) if waits else None
