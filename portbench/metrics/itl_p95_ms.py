"""95th percentile over every gap between successive tokens of every
request due in the window, from the client's own stamps."""

from portbench.yardstick import percentile


def read(run):
    gaps = run.itl_ms()
    return percentile(gaps, 95) if gaps else None
