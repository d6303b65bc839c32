"""Milliseconds of the loop's stream a decode tick over the window: the
engine's ``decode_device_ms`` (each decode dispatch between its CUDA
events, read at the fetch of its tokens; a replayed graph, so the card
waits for the host inside it only at its launch) over the decode ticks it
ran.
In a traced run: the part of the window before the profiler starts."""


def read(run):
    if "decode_device_ms" not in run.stats1:
        return None
    ticks = run.delta("decode_ticks")
    return run.delta("decode_device_ms") / ticks if ticks > 0 else None
