"""Median time to first token over every request due in the window, from
its due time to its first token on the client's stream."""

from portbench.yardstick import percentile


def read(run):
    ttft = run.ttft_ms()
    return percentile(ttft, 50) if ttft else None
