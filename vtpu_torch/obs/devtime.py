"""Device time of the work the serving loop enqueues, read where the loop
already waits.

A ``DeviceTimer`` brackets one dispatch (an admission, a decode tick, a
flush) with a pair of CUDA events on the loop's stream; a ``StageTimer``
brackets the stages of the model's work inside one dispatch (the MoE
block's route, dispatch, experts and combine), laps of one event each.
Recording an event enqueues a timestamp and never waits. The engine reads
a pair only after the fetch of a copy that the stream runs after both
events (the tick's own staged copy, or the copy that brings an admission's
first tokens), so ``elapsed_time`` finds both complete and the loop adds no
sync.

A pair times the stream between its two events, not the card's busy
time: where the host enqueues a dispatch op by op (an eager admission)
and the card runs each op faster than the host issues the next, the
span holds the card's idle waits for the host too. A device trace split
by the loop's phases tells the two apart.

On the CPU the ops run synchronously as they are called, so the same
timers take ``time.perf_counter`` stamps instead: the plumbing is the
same, and the numbers are the host's time in those ops.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _stamp(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


class DeviceTimer:
    """One dispatch on the current stream: the first stamp at construction,
    the second at ``stop()``; ``ms()`` once the stream has run past both."""

    __slots__ = ("_cuda", "_a", "_b")

    def __init__(self, cuda: bool):
        self._cuda = cuda
        self._a = _stamp(cuda)
        self._b = None

    def stop(self) -> "DeviceTimer":
        self._b = _stamp(self._cuda)
        return self

    def ms(self) -> float:
        return _ms(self._a, self._b)


class StageTimer:
    """Named stages of the model's work inside one dispatch, summed over
    the layers. The engine makes one for an admission dispatch and hands it
    to the model's call (``timer=``); the model asks for ``lap()`` where the
    stages begin, which is None while a CUDA graph is being captured (a
    captured step is timed whole by its ``DeviceTimer``). ``ms()`` sums the
    laps by stage once the stream has run past them."""

    __slots__ = ("stages", "_cuda", "_laps")

    def __init__(self, stages: tuple, cuda: bool):
        self.stages = tuple(stages)
        self._cuda = cuda
        self._laps: list = []

    def lap(self) -> Optional[Callable[[str], None]]:
        """A function that closes the stage it is called with at the
        current point of the stream and opens the next there."""
        if self._cuda and torch.cuda.is_current_stream_capturing():
            return None
        cuda, laps = self._cuda, self._laps
        last = [_stamp(cuda)]

        def lap(stage: str) -> None:
            now = _stamp(cuda)
            laps.append((stage, last[0], now))
            last[0] = now

        return lap

    def ms(self) -> dict:
        out = dict.fromkeys(self.stages, 0.0)
        for stage, a, b in self._laps:
            out[stage] += _ms(a, b)
        return out
