"""Engine pressure signals, the overload-shedding policies and the
flush-window policy of the fused loop (counterpart of vtpu/serving/shed.py,
the port's own copy).

``EngineSignals`` is the plain-data pressure snapshot
``ServingEngine.signals()`` returns. A ``ShedPolicy`` picks which waiters
leave the line when it overflows ``ServingConfig.shed_queue_depth``; a
``LoopPolicy`` reads the snapshot at every flush head of the fused
speculation loop (``decode_loop_k`` > 1 with active ``spec_tokens``) and
picks how many inner ticks the next flush runs. Deployments load their own
policy programs without forking the engine: ``shed_policy`` and
``loop_policy`` take an instance, a class or a ``"module:attr"`` string
(``load_shed_policy``, ``load_loop_policy``).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class EngineSignals:
    """The pressure snapshot a policy decides against: small and plain
    data, so a policy program can be tested without an engine. Pool fields
    are None on dense (non-paged) engines; fields of features the port has
    not reached keep their defaults (never draining, no fabric link)."""

    queue_depth: int = 0           # live waiting-line length
    active_slots: int = 0          # slots with a live request
    pool_free: Optional[int] = None      # BlockAllocator free blocks
    pool_used_hwm: Optional[int] = None  # lifetime allocated-blocks high-water mark
    parked_sessions: int = 0       # overcommit parked set size
    prefill_backlog: int = 0       # mid-chunk admissions
    now_ns: int = 0                # monotonic_ns the snapshot was taken
    # usable pool capacity in blocks (None on dense engines): with
    # pool_free it gives an occupancy fraction
    pool_blocks: Optional[int] = None
    # admission closed for a drain
    draining: bool = False
    # attested device duty in [0, 1] from a duty supplier; None without one
    duty: Optional[float] = None
    # fabric link quality to a remote engine (None for a local one)
    fabric_rtt_ms: Optional[float] = None
    fabric_gbps: Optional[float] = None
    # the engine's EMA of tokens emitted per (slot, verify tick), the number
    # the speculation cooloff gates on; None without speculation. The
    # adaptive loop policy halves the flush window while it is low
    spec_mean_accepted: Optional[float] = None
    # tokens of a request's prefix resident on this engine (0 in the
    # engine's own snapshot)
    prefix_resident_tokens: int = 0

    def to_dict(self) -> dict:
        """JSON-safe form."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineSignals":
        """Inverse of ``to_dict``: unknown keys are dropped, missing ones
        take their defaults."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class ShedPolicy:
    """Which waiters leave the line when it overflows. A pure decision over
    the snapshot: the engine owns the shed itself (an atomic
    ``WaitQueue.take`` per victim, the typed terminal, counters, trace)."""

    def select(self, waiters: List, need: int,
               signals: Optional[EngineSignals] = None) -> Iterable:
        """Up to ``need`` requests to shed, most shed-worthy first, from a
        FIFO snapshot of the live waiting Requests (priority, deadline_ns,
        t_submit_ns, tokens, ...); ``signals`` is the engine's pressure
        snapshot (None only when a caller drives the policy directly)."""
        raise NotImplementedError


class PriorityDeadlineShedPolicy(ShedPolicy):
    """The default: the lowest ``priority`` first (the axis overcommit
    evicts on); within a tier the nearest deadline (the likeliest to miss
    anyway; no deadline sheds last); among equals the youngest (the
    longest waiter keeps its FIFO place). Takes the signals like every
    policy and ignores them."""

    def select(self, waiters: List, need: int,
               signals: Optional[EngineSignals] = None) -> Iterable:
        order = sorted(waiters, key=lambda r: (
            r.priority, r.deadline_ns if r.deadline_ns is not None else float("inf"),
            -r.t_submit_ns))
        return order[:need]


def accepts_signals(policy) -> bool:
    """Does this policy's ``select`` take the EngineSignals third argument:
    a third positional parameter, a ``signals`` keyword or ``*args``.
    Resolved once, at engine construction; a two-argument policy is called
    without the snapshot."""
    try:
        sig = inspect.signature(policy.select)
    except (TypeError, ValueError):  # builtins and C callables
        return False
    params = list(sig.parameters.values())
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    if "signals" in sig.parameters:
        return True
    positional = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    # a bound method: (waiters, need, signals)
    return len(positional) >= 3


def load_shed_policy(spec) -> ShedPolicy:
    """Resolve ``ServingConfig.shed_policy``: None -> the default; a
    ``"module:attr"`` string -> imported (a class or an instance); a class
    -> instantiated; anything else is used as it is and must have
    ``select``."""
    if spec is None:
        return PriorityDeadlineShedPolicy()
    if isinstance(spec, str):
        mod, sep, attr = spec.partition(":")
        if not sep or not attr:
            raise ValueError(f"shed_policy string must be 'module:attr', got {spec!r}")
        spec = getattr(importlib.import_module(mod), attr)
    if isinstance(spec, type):
        spec = spec()
    if not callable(getattr(spec, "select", None)):
        raise ValueError(f"shed_policy {spec!r} does not implement select(waiters, need)")
    return spec


class LoopPolicy:
    """How deep the fused decode loop's next flush runs. The engine asks
    at every flush head: ``pick_k(k_max, signals)`` sees the ceiling for
    this flush and the EngineSignals snapshot and returns the flush window
    (the engine clamps it to [1, k_max]). A pure decision over the
    snapshot: the engine owns dispatch, accounting and the clamp."""

    def pick_k(self, k_max: int, signals: Optional[EngineSignals] = None) -> int:
        raise NotImplementedError


class FixedLoopPolicy(LoopPolicy):
    """The static ``decode_loop_k``: always the ceiling."""

    def pick_k(self, k_max: int, signals: Optional[EngineSignals] = None) -> int:
        return k_max


class AdaptiveLoopPolicy(LoopPolicy):
    """Deep flushes only when the engine is saturated and speculation pays.
    A deep flush amortizes the host's cost per flush but lengthens the time
    between flush boundaries, where admission and cancellation happen. So:
    a waiting line or mid-chunk admissions -> full depth; spare capacity
    and no queue -> half depth; acceptance below ``accept_floor`` halves
    the window again (rejected drafts make deep flushes pure cost)."""

    def __init__(self, accept_floor: float = 1.5):
        self.accept_floor = accept_floor

    def pick_k(self, k_max: int, signals: Optional[EngineSignals] = None) -> int:
        if signals is None:
            return k_max
        k = k_max
        saturated = signals.queue_depth > 0 or signals.prefill_backlog > 0
        if not saturated:
            k = max(1, k_max // 2)
        acc = signals.spec_mean_accepted
        if acc is not None and acc < self.accept_floor:
            k = max(1, k // 2)
        return k


def load_loop_policy(spec) -> LoopPolicy:
    """Resolve ``ServingConfig.loop_policy``: None -> FixedLoopPolicy; a
    ``"module:attr"`` string -> imported (a class or an instance); a class
    -> instantiated; anything else is used as it is and must have
    ``pick_k``."""
    if spec is None:
        return FixedLoopPolicy()
    if isinstance(spec, str):
        mod, sep, attr = spec.partition(":")
        if not sep or not attr:
            raise ValueError(f"loop_policy string must be 'module:attr', got {spec!r}")
        spec = getattr(importlib.import_module(mod), attr)
    if isinstance(spec, type):
        spec = spec()
    if not callable(getattr(spec, "pick_k", None)):
        raise ValueError(f"loop_policy {spec!r} does not implement pick_k(k_max, signals)")
    return spec
