"""Deterministic fault injection for the serving engine's failure domains
(counterpart of vtpu/serving/faults.py, the port's own copy).

Every recovery path the engine promises (shed, contain, degrade, rebuild)
is unreachable from a clean run: the allocator never runs dry on cue, and
a device fetch stalls only when real hardware misbehaves. A ``FaultPlan``
makes each seam fire on schedule, so tests and the card's smoke run drive
the recovery machinery reproducibly.

A plan is a set of ``FaultSpec``\\s, each naming a SEAM and the arrival
indices at which it fires. The engine calls ``plan.fire(seam)`` at every
pass through an instrumented seam; the plan counts the arrival and answers
whether to inject. The schedule is a pure function of the specs (or of
the seed, for ``FaultPlan.seeded``) and the per-seam arrival order: no
wall clock, no global RNG, so the same plan over the same traffic injects
at the same points every run.

Seams the port's engine consults:

- ``alloc_exhaust``   the block-pool reservation (``_alloc_reclaim``)
                      reports a dry free list -> backpressure runs
- ``swap_d2h_loss``   an eviction's host spill is lost -> the pages drop
                      and resume rebuilds them through prefill
- ``swap_h2d_loss``   a resume's host restore is lost -> the entry drops
                      its host pages and rebuilds through prefill
- ``dispatch_exc``    an exception escapes one request's delivery ->
                      containment retires only that slot (FAULTED)
- ``delayed_fetch``   the device fetch stalls for ``arg`` seconds -> the
                      fetch watchdog trips and degrades the engine
- ``engine_death``    the serving loop thread dies at a flush boundary
                      without any cleanup (no terminals, no releases: the
                      in-process stand-in for a killed engine process)
- ``worker_death``    a disaggregated prefill worker dies as it starts a
                      claimed request, without cleanup -> the loop's
                      supervisor releases its blocks, re-queues the
                      request with backoff (FAULTED past
                      worker_retry_limit) and restarts the worker
- ``migrate_src_death``    a live migration's source dies after the
                      metadata handshake (at its extract) -> the payload
                      never ships and the destination rebuilds the
                      session from its token history
- ``migrate_payload_loss`` a migration's payload is lost in transit (at
                      the destination's install) -> the same rebuild, or
                      a typed FAULTED where none is possible

The rest of the vocabulary names seams of features the port has not
reached (the fleet's health probes and fabric transport). A plan naming
them is accepted and never fires on the port's engine, as on a reference
engine without those features.

Thread-safe: each ``fire`` takes the plan's lock (a seam costs one
attribute check when no plan is configured). Timing-coupled seams
(``engine_death``: its arrival index is the engine's flush-boundary
count, which idle passes inflate) can be armed mid-run with
``FaultPlan.arm(seam)``, "fire at the NEXT arrival".
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Iterable, Optional

# the instrumented seams, one vocabulary for the engine and the tests
SEAMS = (
    "alloc_exhaust",
    "swap_d2h_loss",
    "swap_h2d_loss",
    "worker_death",
    "dispatch_exc",
    "delayed_fetch",
    "migrate_src_death",
    "migrate_payload_loss",
    "engine_death",
    "probe_loss",
    "fabric_msg_loss",
    "fabric_delay",
    "fabric_payload_corrupt",
)


class FaultInjected(RuntimeError):
    """What an injected ``dispatch_exc`` raises: a stand-in for any
    exception escaping one request's delivery. Containment treats it as it
    would an organic bug: the one slot retires FAULTED, every other stream
    goes on."""


class WorkerDeath(BaseException):
    """Kills a prefill worker thread without unwinding its cleanup (the
    ``worker_death`` seam). A BaseException, so an ordinary ``except
    Exception`` containment cannot swallow it."""


class EngineDeath(BaseException):
    """Kills the serving loop thread without its shutdown sweep: no typed
    terminals, no block releases. Every client is left hanging as a killed
    process would leave it. A BaseException, so no ``except Exception``
    inside the loop survives its own death."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fire at arrivals [at, at + count) of ``seam``. ``arg`` is the
    seam's payload (``delayed_fetch``: stall seconds)."""

    seam: str
    at: int = 0
    count: int = 1
    arg: float = 0.0

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r}; known: {SEAMS}")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"need at >= 0 and count >= 1, got at={self.at} count={self.count}")


class FaultPlan:
    """A deterministic injection schedule over the named seams.

    ``fire(seam)`` counts one arrival at the seam and returns the matching
    FaultSpec when the schedule says inject (truthy), else None. The
    arrivals and injections per seam are in ``snapshot()``; the engine
    reports ``injected_total`` as ``stats()["faults_injected"]``. A plan
    pickles with its schedule and counts (a spawned rank of a
    tensor-parallel world receives it that way)."""

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._arrivals: Dict[str, int] = {s: 0 for s in SEAMS}
        self._injected: Dict[str, int] = {s: 0 for s in SEAMS}
        # seam -> {arrival index -> spec}; overlapping specs resolve to the
        # one declared first
        self._sched: Dict[str, Dict[int, FaultSpec]] = {s: {} for s in SEAMS}
        for spec in self.specs:
            tbl = self._sched[spec.seam]
            for i in range(spec.at, spec.at + spec.count):
                tbl.setdefault(i, spec)

    def __getstate__(self) -> dict:
        with self._lock:
            return {k: v for k, v in self.__dict__.items() if k != "_lock"}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    @classmethod
    def seeded(cls, seed: int, rates: Dict[str, float], horizon: int = 256,
               args: Optional[Dict[str, float]] = None) -> "FaultPlan":
        """A reproducible pseudo-random schedule: for each seam in
        ``rates``, each of the first ``horizon`` arrivals fires with the
        given rate, drawn from ``random.Random`` seeded by (seed, seam), in
        sorted-seam order. ``args`` carries per-seam payloads."""
        args = args or {}
        specs = []
        for seam in sorted(rates):
            if seam not in SEAMS:
                raise ValueError(f"unknown fault seam {seam!r}")
            rng = random.Random((seed, seam).__repr__())
            for i in range(horizon):
                if rng.random() < rates[seam]:
                    specs.append(FaultSpec(seam, at=i, count=1, arg=args.get(seam, 0.0)))
        return cls(specs)

    def arm(self, seam: str, count: int = 1, arg: float = 0.0) -> FaultSpec:
        """Schedule ``seam`` to fire at its NEXT ``count`` arrivals: the
        handle for seams whose arrival index follows the loop's timing. A
        caller streams the tokens it wants first, then arms the seam.
        Returns the spec it scheduled."""
        with self._lock:
            if seam not in SEAMS:
                raise ValueError(f"unknown fault seam {seam!r}; known: {SEAMS}")
            spec = FaultSpec(seam, at=self._arrivals[seam], count=count, arg=arg)
            self.specs = self.specs + (spec,)
            tbl = self._sched[seam]
            for i in range(spec.at, spec.at + spec.count):
                tbl.setdefault(i, spec)
            return spec

    def fire(self, seam: str) -> Optional[FaultSpec]:
        """One arrival at ``seam``: the FaultSpec to inject, or None."""
        with self._lock:
            i = self._arrivals[seam]
            self._arrivals[seam] = i + 1
            spec = self._sched[seam].get(i)
            if spec is not None:
                self._injected[seam] += 1
            return spec

    @property
    def injected_total(self) -> int:
        with self._lock:
            return sum(self._injected.values())

    def snapshot(self) -> dict:
        """Per-seam arrival and injection counts."""
        with self._lock:
            return {"arrivals": dict(self._arrivals), "injected": dict(self._injected)}
