"""Host milliseconds a decode tick over the window: the tick profiler's
admission, dispatch and deliver totals (not the fetch, which waits for the
card) over the decode ticks the window ran.
In a traced run: the part of the window before the profiler starts."""


def read(run):
    ticks = run.delta("decode_ticks")
    if ticks <= 0:
        return None
    return run.phase_ms(("admission", "dispatch", "deliver")) / ticks
