"""The clients: they submit the mix's requests to the engine and stamp every
token as it is put on their stream.

A request's stream is the engine's ``Request.out`` queue; the benchmark
gives every request a queue that notes ``time.monotonic_ns()`` at each
put (on the engine's delivery thread, the moment a token reaches the
client), so no client thread has to wake to read it. The stamping queue
comes in through a subclass of the engine's ``Request`` with that queue as
its default, set in the engine module for the run.

The open loop submits each request at its due time from one thread and
notes how late it ran; the closed loop's callers each submit their next
request when the last one ends. Each admission batch the engine forms is
noted too (its time, bucket and rows), around the engine's own call.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from vtpu_torch.serving import engine as engine_mod

OK = "OK"


class StampQueue(queue.Queue):
    """A request's stream that stamps each token and its end."""

    def __init__(self):
        super().__init__()
        self.stamps: list[int] = []
        self.tokens: list[int] = []
        self.end_ns: Optional[int] = None
        self.status: Optional[str] = None
        self.on_end: Optional[Callable[[], None]] = None

    def put(self, item, block=True, timeout=None):
        now = time.monotonic_ns()
        if isinstance(item, (int, np.integer)):
            self.stamps.append(now)
            self.tokens.append(int(item))
        elif item is not None:
            self.end_ns = now
            self.status = getattr(item, "status", None)
            if self.on_end is not None:
                self.on_end()
        super().put(item, block, timeout)


@dataclasses.dataclass(eq=False)
class StampedRequest(engine_mod.Request):
    out: queue.Queue = dataclasses.field(default_factory=StampQueue)


@dataclasses.dataclass(eq=False)
class Record:
    """One request as its client saw it."""

    prompt: np.ndarray
    max_new: int
    due_ns: int
    submit_ns: int
    req: object
    in_window: bool = False
    # "mix", or "warm": the shape warm-up's requests and a closed loop's
    # first ones (their budgets staggered), never sampled
    kind: str = "mix"

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def q(self) -> StampQueue:
        return self.req.out

    @property
    def ok(self) -> bool:
        return self.q.status == OK and len(self.q.tokens) == self.max_new


def _once(fn: Callable[[], None]) -> Callable[[], None]:
    lock, done = threading.Lock(), []

    def call():
        with lock:
            if done:
                return
            done.append(True)
        fn()

    return call


class Clients:
    """Submits to one engine and keeps every record and admission batch."""

    def __init__(self, eng):
        self._request_cls = engine_mod.Request
        engine_mod.Request = StampedRequest
        self.eng = eng
        self.records: list[Record] = []
        self.by_rid: dict[int, Record] = {}
        self.admissions: list[tuple[int, int, list, list]] = []
        self.lateness_ns: list[int] = []
        self._lock = threading.Lock()
        inner = eng._admit_batch

        def noted(slots, reqs, bucket):
            self.admissions.append((time.monotonic_ns(), int(bucket), [r.rid for r in reqs],
                                    [int(r.tokens.shape[0]) for r in reqs]))
            return inner(slots, reqs, bucket)

        eng._admit_batch = noted

    def close(self) -> None:
        engine_mod.Request = self._request_cls

    def submit(self, prompt, max_new: int, due_ns: Optional[int] = None,
               in_window: bool = False, kind: str = "mix",
               on_end: Optional[Callable[[], None]] = None) -> Record:
        req = self.eng.submit(prompt, max_new_tokens=max_new)
        if on_end is not None:
            once = _once(on_end)
            req.out.on_end = once
            if req.out.status is not None:  # ended before the hook was set
                once()
        rec = Record(prompt, max_new, req.t_submit_ns if due_ns is None else due_ns,
                     req.t_submit_ns, req, in_window, kind)
        with self._lock:
            self.records.append(rec)
            self.by_rid[req.rid] = rec
        return rec

    def warm_shapes(self, planned) -> None:
        """Submit ``planned`` together (the loop not yet started), so the
        first tick head admits them in the batches they form."""
        for p in planned:
            self.submit(p.prompt, p.max_new, kind="warm")

    def wait(self, recs, deadline_ns: int) -> bool:
        """Wait until every record in ``recs`` has ended, or the deadline."""
        while time.monotonic_ns() < deadline_ns:
            if all(r.q.status is not None for r in recs):
                return True
            time.sleep(0.01)
        return all(r.q.status is not None for r in recs)

    def open_loop(self, planned, start_ns: int, stop: threading.Event) -> threading.Thread:
        """Submit each planned request at start_ns + its due time, from a
        thread of its own."""

        def feed():
            for p in planned:
                due = start_ns + int(p.due_s * 1e9)
                wait = (due - time.monotonic_ns()) / 1e9
                if wait > 0:
                    time.sleep(wait)
                if stop.is_set():
                    return
                rec = self.submit(p.prompt, p.max_new, due_ns=due, in_window=p.in_window)
                self.lateness_ns.append(rec.submit_ns - due)

        th = threading.Thread(target=feed, name="open-loop", daemon=True)
        th.start()
        return th

    def closed_loop(self, planned, clients: int, window: tuple[int, int],
                    stop: threading.Event) -> threading.Thread:
        """``clients`` callers: each submits its next planned request when
        its last one ends, until ``stop``. A request counts to the window
        when it is submitted inside it."""
        ended: "queue.Queue[int]" = queue.Queue()
        it = iter(planned)
        lock = threading.Lock()

        def send(c, kind="mix"):
            with lock:
                p = next(it)
            now = time.monotonic_ns()
            self.submit(p.prompt, p.max_new, in_window=window[0] <= now < window[1],
                        kind=kind, on_end=lambda: ended.put(c))

        def run():
            for c in range(clients):
                send(c, "warm")  # the staggered first budgets: warm-up only
            while not stop.is_set():
                try:
                    c = ended.get(timeout=0.05)
                except queue.Empty:
                    continue
                if not stop.is_set():
                    send(c)

        th = threading.Thread(target=run, name="closed-loop", daemon=True)
        th.start()
        return th
