"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUDA
activity) over a stretch of the measured window, reduced to the
operations that ran on the card as (name, start ns, end ns).

The profiler is started and stopped on the engine's own loop thread, at
its tick head (``on_loop``), so that no other thread launches work on the
card while CUPTI attaches and detaches. Started and stopped from a second
thread while the loop replayed its CUDA graphs, the profiler once
recorded none of the kernels, and runs traced so hung (H100, torch 2.11,
CUDA 12.8).

The stretch is marked on the card itself: a one-microsecond spin kernel
on a stream of its own, high priority, launched as the stretch opens and
as it closes, so the window is read in the device's clock. The profiler
synchronises the card before it stops, so a kernel's time is never cut
off; kernels of work launched before the open that run inside it are in
the trace too. A trace without both markers has no window and is an
error.
"""

from __future__ import annotations

import threading
import time

import torch

MARKER = "spin_kernel"
# how long the loop may take to reach its tick head and run a step there
# before the run gives up on it: the profiler's stop holds the loop while
# it reads the stretch back (19-38 s for ~470,000 operations on an H100's
# host), and the run's own watchdog ends a hang before this does
ON_LOOP_TIMEOUT_S = 240.0


def _spin(stream) -> None:
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1000)


def on_loop(eng, fn, timeout_s: float = ON_LOOP_TIMEOUT_S):
    """Run ``fn()`` on ``eng``'s loop thread at its next tick head, through
    the per-tick hook a fleet uses for its session ledger (any hook already
    there still runs first), and return what it returns or raise what it
    raises. Raises if the loop has ended, or has not run it within
    ``timeout_s``."""
    done = threading.Event()
    box: dict = {}
    prev = eng._ledger_hook

    def hook(e) -> None:
        if prev is not None:
            prev(e)
        if done.is_set():
            return
        eng._ledger_hook = prev
        try:
            box["value"] = fn()
        except BaseException as exc:  # handed to the waiting thread
            box["error"] = exc
        finally:
            done.set()

    eng._ledger_hook = hook
    give_up = time.monotonic() + timeout_s
    while not done.wait(0.1):
        if eng._thread is None or not eng._thread.is_alive():
            raise RuntimeError("the engine's loop is not running")
        if time.monotonic() > give_up:
            raise RuntimeError(f"the engine's loop did not run a step at its tick head "
                               f"within {timeout_s} s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


class DeviceTrace:
    def __init__(self, eng):
        self.eng = eng
        self.ops: list[tuple[str, int, int]] = []
        self.window: tuple[int, int] | None = None  # device clock, ns
        self.host: tuple[int, int] | None = None  # monotonic ns
        self.start_s = self.stop_s = 0.0  # the loop's seconds in the profiler's start, stop
        self._prof = None
        self._stream = None

    def start(self) -> None:
        self._stream = torch.cuda.Stream(priority=-1)
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

        def begin() -> int:
            t = time.monotonic_ns()
            self._prof.start()
            opened = time.monotonic_ns()
            self.start_s = (opened - t) / 1e9
            _spin(self._stream)
            return opened

        self.host = (on_loop(self.eng, begin), 0)

    def stop(self) -> None:
        def end() -> int:
            _spin(self._stream)
            t = time.monotonic_ns()
            self._prof.stop()
            self.stop_s = (time.monotonic_ns() - t) / 1e9
            return t

        self.host = (self.host[0], on_loop(self.eng, end))
        self.ops = _device_ops(self._prof)
        self._prof = None
        marks = sorted(s for name, s, _ in self.ops if MARKER in name)
        self.ops = [op for op in self.ops if MARKER not in op[0]]
        if len(marks) < 2:
            raise RuntimeError(f"the device trace holds {len(marks)} of its two window markers")
        self.window = (marks[0], marks[-1])


def _device_ops(prof) -> list[tuple[str, int, int]]:
    """Every kernel, copy and fill the profiler saw on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), int(e.start_ns()), int(e.end_ns()))
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
