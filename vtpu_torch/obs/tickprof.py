"""Tick-phase profiler: where a serving tick's host time goes.

The port's own copy of vtpu/obs/tickprof.py (pure Python, kept here so the
port imports nothing of the reference). Each loop pass notes the seconds it
spent in each phase into a bounded histogram, so a TTFT p99 outlier can be
blamed on admission work, the dispatch, the device fetch or delivery.

Phases (one histogram each; the first five are the reference's):

- admission:  ``_tick_head`` — queue drain, batched admission dispatch,
              cancel sweep (without the hook and the swap drain).
- dispatch:   building and issuing the decode step (host-side tensor builds,
              the enqueue of every kernel or one graph replay, the staging
              of the tick's device->host copy).
- fetch:      the tick's one wait for its device->host copy. On the
              pipelined loop this includes waiting for the device to finish
              the in-flight tick: the device-bound share of the tick.
- deliver:    pure-Python bookkeeping after the fetch (stream puts,
              budget/eos/retire).
- swap_drain: the tick head's retirement of finished swap-outs to the
              host tier (overcommit: event queries, never a wait; empty
              without ``kv_swap``).
- idle:       ``_idle_wait`` — nothing to decode or deliver: the loop
              waits for a submission.
- hook:       a fleet's ledger hook at the tick head (the benchmark's
              profiler control rides the same hook); empty outside a fleet.

Given a ``RequestTrace`` with its ring enabled, every note also records the
phase as a span on the engine-loop track (-1) of its loop ring: one
``loop_phase`` event stamped with the phase's end (``time.monotonic_ns``),
its slot the phase's index in ``PHASES`` and its val the phase's
nanoseconds. Together the spans cover the loop thread's time; only its own
bookkeeping falls between them.

Everything is plain host arithmetic: a ``note()`` is one bisect over a
static bucket table plus four scalar updates, and one ring write with the
ring on. Writers are the serving-loop thread; ``snapshot()`` readers from
other threads see monotonic counters.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Optional

# Bucket upper edges in MILLISECONDS. Tick phases live in the 10 us .. 100
# ms range; span latencies (TTFT/ITL/queue wait, see trace.py) reuse the
# same class with the wider LATENCY edges.
PHASE_BUCKETS_MS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 1000.0,
)
LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

PHASES = ("admission", "dispatch", "fetch", "deliver", "swap_drain", "idle", "hook")


class BoundedHistogram:
    """Fixed-bucket monotonic histogram (count / sum / max + per-bucket
    counts). Monotonic on purpose: an exporter publishes it as a histogram,
    so counts must only ever grow."""

    __slots__ = ("edges_ms", "counts", "count", "total_ms", "max_ms", "ticks")

    def __init__(self, edges_ms: tuple = PHASE_BUCKETS_MS):
        self.edges_ms = tuple(edges_ms)
        self.counts = [0] * (len(self.edges_ms) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        # decode ticks the samples covered (== count while every note covers
        # one tick; a multi-tick loop would note k per pass)
        self.ticks = 0

    def note_ms(self, ms: float, ticks: int = 1) -> None:
        self.counts[bisect_left(self.edges_ms, ms)] += 1
        self.count += 1
        self.total_ms += ms
        self.ticks += ticks
        if ms > self.max_ms:
            self.max_ms = ms

    def note(self, seconds: float, ticks: int = 1) -> None:
        self.note_ms(seconds * 1e3, ticks=ticks)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    @property
    def mean_ms_per_tick(self) -> float:
        """Phase milliseconds amortized over the ticks the samples covered."""
        return self.total_ms / self.ticks if self.ticks else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "total_ms": round(self.total_ms, 4),
            "mean_ms": round(self.mean_ms, 4),
            "max_ms": round(self.max_ms, 4),
            "ticks": self.ticks,
            "mean_ms_per_tick": round(self.mean_ms_per_tick, 4),
        }

    def prom_buckets(self) -> tuple[list[tuple[str, float]], float]:
        """(cumulative (le, count) pairs with le in SECONDS, sum in seconds):
        the shape a Prometheus histogram family takes."""
        acc, out = 0, []
        for edge_ms, c in zip(self.edges_ms, self.counts):
            acc += c
            out.append((repr(edge_ms / 1e3), float(acc)))
        out.append(("+Inf", float(self.count)))
        return out, self.total_ms / 1e3


class TickProfiler:
    """One BoundedHistogram per decode-loop phase, and with ``trace`` (a
    RequestTrace) the phases as spans on its ring."""

    __slots__ = ("phases", "_index", "_trace")

    def __init__(self, phases: tuple = PHASES, edges_ms: tuple = PHASE_BUCKETS_MS,
                 trace=None):
        self.phases = {p: BoundedHistogram(edges_ms) for p in phases}
        self._index = {p: i for i, p in enumerate(phases)}
        self._trace = trace if trace is not None and trace.enabled else None

    def note(self, phase: str, seconds: float, ticks: int = 1,
             span_s: Optional[float] = None) -> None:
        """Record one phase sample that ends now; ``ticks`` is how many
        decode ticks it amortizes over. ``span_s``: the ring's span is only
        the last piece of the phase, this long (the others were marked)."""
        self.phases[phase].note(seconds, ticks=ticks)
        if self._trace is not None:
            self.mark(phase, seconds if span_s is None else span_s)

    def mark(self, phase: str, seconds: float) -> None:
        """The ring's span of a phase that ends now, without a histogram
        sample: one piece of a phase that another phase interrupts."""
        if self._trace is not None:
            self._trace.record_loop("loop_phase", self._index[phase], int(seconds * 1e9))

    def snapshot(self) -> dict:
        """{phase: {count, total_ms, mean_ms, max_ms, ticks,
        mean_ms_per_tick}}: the ``stats()["tick_phase_ms"]`` view."""
        return {p: h.snapshot() for p, h in self.phases.items()}
