"""The window's milliseconds over the decode ticks it ran (admissions
included: what a tick costs the streams).
In a traced run: the part of the window before the profiler starts."""


def read(run):
    ticks = run.delta("decode_ticks")
    return run.quiet_s * 1e3 / ticks if ticks > 0 else None
