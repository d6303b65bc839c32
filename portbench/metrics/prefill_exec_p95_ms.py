"""95th percentile of an admission's execution on the host's clock (the
trace ring's queue_depart -> admit) over every request due in the window:
what the first token waits for once out of the line, and, in a cell whose
admissions stall every stream, what the gap between tokens waits for.
In a traced run: the part of the window before the profiler starts."""

from portbench.yardstick import percentile


def read(run):
    if run.spans is None:
        return None
    took = []
    for r in run.quiet_sample():
        s = run.spans.get(r.rid)
        if s and s["queue_depart_ns"] is not None and s["admit_ns"] is not None:
            took.append((s["admit_ns"] - s["queue_depart_ns"]) / 1e6)
    return percentile(took, 95) if took else None
