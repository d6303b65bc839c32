"""Request-lifecycle tracing: a lock-light bounded event ring + derived spans.

The port's own copy of vtpu/obs/trace.py (pure Python, kept here so the port
imports nothing of the reference); the ring, the spans, the exports and the
latency reservoirs are the reference's, field for field. The engine records
a request's lifecycle as structured events in a preallocated ring and the
spans are derived offline:

    submit -> queue_depart -> [prefill_chunk*] -> admit -> first_token
        -> token* -> retire

The vocabulary is the reference's whole vocabulary. Kinds of features the
port has not reached (the disaggregation and migration events) are kept so
a trace reads the same in both packages; the port never records them. It
records prefill_chunk for each chunk of a chunked or prefixed admission,
fault for a request a contained failure ended, and the overcommit
lifecycle (park, evict, swap_out, swap_in, fault_recompute, resume). Its
own kinds ride the engine-loop track (rid -1) in a ring of their own,
as large as the request ring: the loop's phases (loop_phase), the clock's
offset to the wall clock (clock), admission batches (admit_batch) and an
admission's device time (prefill_device). The loop writes several of them
every pass, busy or idle, so in the request ring they would push the
request lifecycles out; there a request's lifecycle, ``snapshot()``,
``events_recorded`` and the flight recorder read as the reference's.

Recording cost is the contract: one ``itertools.count`` bump (atomic under
the GIL), one ``time.monotonic_ns`` stamp, one tuple, one list-slot store.
No locks on the hot path and nothing device-side: tracing never adds a
device sync.

The ring is bounded: when it wraps, the oldest events fall off and
``events_dropped`` says how many. Span derivation, JSONL export and the
Chrome ``trace_event`` dump (loads in Perfetto / chrome://tracing) run off a
snapshot, never the live ring.

Alongside the ring, the trace owns the latency substrate the engine's
``stats()`` percentiles are a view over: inter-token-gap, TTFT, queue-wait
and prefill-execution reservoirs plus monotonic histograms. These stay live
with the ring disabled (``capacity=0``).
"""

from __future__ import annotations

import bisect
import collections
import itertools
import json
import threading
import time
from typing import IO, Optional, Union

from vtpu_torch.obs.tickprof import LATENCY_BUCKETS_MS, PHASES, BoundedHistogram

# The event vocabulary. ``val`` is one int whose meaning is per-kind
# (prompt/installed tokens, chunk tokens, blocks, bytes, sequence length).
EVENT_KINDS = (
    "submit",          # request entered the engine (val: prompt tokens)
    "queue_depart",    # left the waiting line for a slot or worker
    "admit",           # slot bookkeeping complete (val: installed length)
    "prefill_start",   # a disagg prefill worker claimed it (val: prompt)
    "prefill_chunk",   # one [1, C] chunk advanced (val: C)
    "handoff",         # worker finished: blocks + first token ready for
                       # the decode loop (val: blocks) — zero-copy by
                       # contract (stats()["handoff_copies"] == 0)
    "pool_install",    # decode loop mapped the handoff's blocks into a
                       # slot's table row (val: pages) — the one fused
                       # install write, still zero KV copies
    "first_token",     # first token delivered to the client
    "token",           # one decode/spec token delivered. Device-loop
                       # flushes (decode_loop_k > 1) record their k
                       # per-token events with INTERPOLATED timestamps
                       # (they share one host observation) and flag them
                       # with val=1 — derived ITL spans stay well-defined,
                       # consumers that need observed-only stamps filter
                       # on the flag
    "loop_flush",      # one k-tick device-loop delivery (val: k) — the
                       # host-boundary marker the interpolated token
                       # events between two flushes hang off
    "park",            # taken out of the decode batch (val: owned pages)
    "evict",           # private pages reclaimed from the pool (val: blocks)
    "swap_out",        # pages spilled to the host tier (val: bytes)
    "swap_in",         # pages restored from the host tier (val: bytes)
    "fault_recompute", # KV rebuilt through prefill (val: sequence length)
    "resume",          # resume command accepted for a parked request
    "retire",          # stream ended; val carries the typed terminal
                       # status code (TERMINAL_CODES) so a post-mortem
                       # JSONL says WHY — OK / CANCELLED / SHED_* / FAULTED
    "shed",            # request shed by deadline or overload policy
                       # (val: TERMINAL_CODES of the shed kind)
    "fault",           # an exception was contained to this one request
                       # (crash containment / worker-death exhaustion)
    "worker_restart",  # a dead disagg prefill worker was restarted by the
                       # loop-thread supervisor (slot field: worker id)
    "degrade",         # the fetch watchdog stepped the degradation ladder
                       # (val: ladder level after the step)
    "recover",         # the watchdog ladder re-escalated one rung after
                       # the recovery grace window (val: level after)
    "migrate_out",     # request extracted from this engine for a live
                       # cross-engine migration (val: pages shipped)
    "migrate_in",      # request installed into this engine's parked set
                       # by a migration (val: pages; resume continues it)
    # the port's own, on the engine-loop track (rid -1) unless noted
    "loop_phase",      # one phase of the serving loop, stamped at its end
                       # (slot: the phase's index in tickprof.PHASES, val:
                       # its ns)
    "clock",           # the wall clock's offset (val: time.time_ns() -
                       # time.monotonic_ns()), the clock torch.profiler
                       # stamps in: at the engine's start, then at most
                       # once a second at a tick head
    "admit_batch",     # one batched admission dispatch, just before its
                       # rows' admit events in their order (slot: rows,
                       # val: bucket)
    "prefill_device",  # an admitted request's admission dispatch on the
                       # device, read at the fetch of its first token
                       # (slot: the request's rid; val: ns of its batch)
)

# Typed terminal status -> the small int the retire/shed events carry in
# ``val`` (0 is OK, so legacy retire records without a code read as OK).
# Single-sourced here so the engine, spans() and every post-mortem
# consumer decode the same vocabulary.
TERMINAL_CODES = {
    "OK": 0,
    "CANCELLED": 1,
    "SHED_DEADLINE": 2,
    "SHED_OVERLOAD": 3,
    "FAULTED": 4,
}
TERMINAL_NAMES = {v: k for k, v in TERMINAL_CODES.items()}

# The disaggregated handoff lifecycle (prefill worker -> decode loop) as an
# in-order subsequence, single-sourced like the restore sequences below.
HANDOFF_SEQUENCE = (
    "submit", "queue_depart", "prefill_start", "prefill_chunk",
    "first_token", "handoff", "pool_install", "admit", "token", "retire")

# Chrome-trace track id for the prefill-worker lane (far above any real
# request id, which double as per-request track ids)
PREFILL_LANE_TID = 1 << 30

FIELDS = ("seq", "ts_ns", "event", "rid", "slot", "val")

# The lifecycle contracts the two overcommit restore paths must trace as
# (in-order subsequences of a request's event stream), as the reference
# single-sources them.
SWAP_RESTORE_SEQUENCE = (
    "submit", "queue_depart", "admit", "first_token", "token", "park",
    "evict", "swap_out", "resume", "swap_in", "token", "retire")
DROP_RESTORE_SEQUENCE = (
    "submit", "admit", "first_token", "token", "park", "evict", "resume",
    "fault_recompute", "token", "retire")

# Live migration splits one request's lifecycle across TWO engines' traces
# (the destination assigns a fresh rid at install): the source trace ends
# at migrate_out, the destination trace starts at migrate_in and carries
# the stream to its retire.
MIGRATE_SRC_SEQUENCE = (
    "submit", "admit", "first_token", "token", "park", "migrate_out")
MIGRATE_DST_SEQUENCE = ("migrate_in", "resume", "token", "retire")


def subsequence(needle, haystack) -> bool:
    """Is *needle* an in-order (not necessarily contiguous) subsequence
    of *haystack*?"""
    it = iter(haystack)
    return all(k in it for k in needle)


def pct(sorted_vals, q: float):
    """The repo's one percentile convention (the reference's):
    index into the sorted sample at floor(n*q), clamped."""
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


class RequestTrace:
    """Bounded ring of lifecycle events + the latency reservoirs/histograms
    derived views are built over. One instance per ServingEngine."""

    def __init__(self, capacity: int = 16384, itl_window: int = 2048):
        self.capacity = int(capacity)
        self.enabled = self.capacity > 0
        self._buf: list = [None] * max(self.capacity, 1)
        self._ctr = itertools.count()  # next(ctr) is atomic under the GIL
        # the engine loop's own kinds, in a ring of their own
        self._loop_buf: list = [None] * max(self.capacity, 1)
        self._loop_ctr = itertools.count()
        # latency substrate (always on, ring or no ring): bounded
        # reservoirs for percentiles + monotonic histograms for export.
        # One uncontended lock serializes reservoir appends (loop thread)
        # against stats()/export snapshots (client threads).
        self._lat_lock = threading.Lock()
        self._itl: "collections.deque[float]" = collections.deque(
            maxlen=itl_window)
        self._ttft: "collections.deque[float]" = collections.deque(
            maxlen=itl_window)
        self._queue_wait: "collections.deque[float]" = collections.deque(
            maxlen=itl_window)
        self._prefill_exec: "collections.deque[float]" = collections.deque(
            maxlen=itl_window)
        self.itl_hist = BoundedHistogram(LATENCY_BUCKETS_MS)
        self.ttft_hist = BoundedHistogram(LATENCY_BUCKETS_MS)
        self.queue_wait_hist = BoundedHistogram(LATENCY_BUCKETS_MS)
        self.prefill_exec_hist = BoundedHistogram(LATENCY_BUCKETS_MS)

    # ------------------------------------------------------------ recording

    def record(self, event: str, rid: int, slot: int = -1, val: int = 0) -> None:
        """Stamp one lifecycle event. Hot-path cheap; safe from any thread
        (concurrent writers can't collide: the counter hands each its own
        slot; a reader may see a torn WINDOW, never a torn event)."""
        if not self.enabled:
            return
        seq = next(self._ctr)
        self._buf[seq % self.capacity] = (
            seq, time.monotonic_ns(), event, rid, slot, val)

    def record_at(self, ts_ns: int, event: str, rid: int, slot: int = -1,
                  val: int = 0) -> None:
        """record() with an explicit monotonic_ns timestamp. The device-
        loop flush delivery synthesizes per-token stamps by interpolating
        across the flush window (k tokens share ONE host observation);
        callers flag synthesized events via ``val`` so span consumers can
        tell observed from interpolated."""
        if not self.enabled:
            return
        seq = next(self._ctr)
        self._buf[seq % self.capacity] = (seq, ts_ns, event, rid, slot, val)

    def record_loop(self, event: str, slot: int = -1, val: int = 0,
                    ts_ns: Optional[int] = None) -> None:
        """Stamp one of the engine loop's own events (rid -1) into the
        loop's ring, now or at ``ts_ns``."""
        if not self.enabled:
            return
        seq = next(self._loop_ctr)
        self._loop_buf[seq % self.capacity] = (
            seq, time.monotonic_ns() if ts_ns is None else ts_ns, event, -1, slot, val)

    def record_clock(self) -> None:
        """A ``clock`` event: the offset that turns the rings' stamps
        (``time.monotonic_ns``) into the wall clock's, which
        ``torch.profiler`` stamps in. The monotonic stamp is the mean of
        two reads around the wall clock's."""
        if not self.enabled:
            return
        a = time.monotonic_ns()
        wall = time.time_ns()
        mid = (a + time.monotonic_ns()) // 2
        self.record_loop("clock", -1, wall - mid, ts_ns=mid)

    def note_itl(self, gap_s: float) -> None:
        with self._lat_lock:
            self._itl.append(gap_s)
        self.itl_hist.note(gap_s)

    def note_ttft(self, seconds: float) -> None:
        with self._lat_lock:
            self._ttft.append(seconds)
        self.ttft_hist.note(seconds)

    def note_queue_wait(self, seconds: float) -> None:
        with self._lat_lock:
            self._queue_wait.append(seconds)
        self.queue_wait_hist.note(seconds)

    def note_prefill_exec(self, seconds: float) -> None:
        """Queue departure -> first token: the prefill-execution half of
        the TTFT split (queue wait is the other half)."""
        with self._lat_lock:
            self._prefill_exec.append(seconds)
        self.prefill_exec_hist.note(seconds)

    # ------------------------------------------------------------ snapshots

    @property
    def events_recorded(self) -> int:
        """Total events ever recorded (including any the ring dropped)."""
        # peek the counter without consuming: copy it (count objects are
        # cheap value types; __reduce__ exposes the current value)
        return self._ctr.__reduce__()[1][0]

    @property
    def events_dropped(self) -> int:
        return max(0, self.events_recorded - self.capacity) if self.enabled else 0

    def itl_gaps(self) -> list:
        with self._lat_lock:
            return list(self._itl)

    def ttft_samples(self) -> list:
        with self._lat_lock:
            return list(self._ttft)

    def queue_wait_samples(self) -> list:
        with self._lat_lock:
            return list(self._queue_wait)

    def prefill_exec_samples(self) -> list:
        with self._lat_lock:
            return list(self._prefill_exec)

    def snapshot(self) -> list[tuple]:
        """The ring's live events in recording order (oldest first)."""
        evs = [e for e in self._buf if e is not None]
        evs.sort(key=lambda e: e[0])
        return evs

    def loop_snapshot(self) -> list[tuple]:
        """The loop ring's live events in recording order (oldest first)."""
        evs = [e for e in self._loop_buf if e is not None]
        evs.sort(key=lambda e: e[0])
        return evs

    def events(self) -> list[dict]:
        """snapshot() as dicts — the JSONL record shape."""
        return [dict(zip(FIELDS, e)) for e in self.snapshot()]

    # ------------------------------------------------------------- derived

    @staticmethod
    def _span_row(out: dict, rid: int) -> dict:
        """A request's span row, empty; the engine-loop track's also holds
        its loop phases, clock offsets and admission batches."""
        s = out[rid] = {
            "rid": rid, "submit_ns": None, "queue_depart_ns": None,
            "admit_ns": None, "first_token_ns": None,
            "retire_ns": None, "tokens": 0, "prefill_chunks": 0,
            "itl_ms": [], "parks": 0, "parked_ms": 0.0,
            "resume_latency_ms": [], "evicted_blocks": 0,
            "swap_out_bytes": 0, "swap_in_bytes": 0,
            "fault_recomputes": 0,
            "prefill_start_ns": None, "handoff_ns": None,
            "pool_install_ns": None, "handoffs": 0,
            "sheds": 0, "faults": 0, "worker_restarts": 0,
            "migrations": 0,
            "terminal": None,
            # first/last DELIVERED token stamps (first_token OR
            # token — a migrated-in hop has no first_token event,
            # so first_token_ns alone cannot anchor it): the
            # endpoints fleet journey stitching measures blackout
            # windows between
            "first_tok_ns": None, "last_tok_ns": None,
            "_last_tok_ns": None, "_park_ns": None,
            "_resume_ns": None,
        }
        if rid == -1:
            s.update(loop_phases=[], clock=[], admissions=[])
        return s

    def spans(self) -> dict[int, dict]:
        """Per-request derived spans from the event snapshot: queue wait,
        TTFT, the ITL series, parked duration, resume latency. A gap that
        straddles a park..resume window is attributed to ``resume_latency_ms``
        (time from the resume command to the next delivered token), never
        to the ITL series — a parked request's silence is policy, not
        decode latency. Requests whose early events fell off the ring
        yield partial spans (fields None). A request whose admission was
        timed on the device has ``prefill_device_ms``.

        The engine-loop track (rid -1) also carries, from the loop's ring,
        ``loop_phases``, each phase as (phase, start_ns, end_ns);
        ``clock``, each offset to the wall clock as (ts_ns, offset_ns); and
        ``admissions``, each batched admission as (ts_ns, bucket, [rids])
        with the rids of the admit events that follow it."""
        out: dict[int, dict] = {}
        batch: list = []  # the admission batch still taking its rows
        left = 0
        device_ns: dict[int, int] = {}
        loop = self.loop_snapshot()
        at = 0
        for ev in self.snapshot() + [None]:
            # the loop ring's events up to this event's stamp
            while at < len(loop) and (ev is None or loop[at][1] <= ev[1]):
                _, ts, event, _, slot, val = loop[at]
                at += 1
                s = out.get(-1) or self._span_row(out, -1)
                if event == "loop_phase":
                    s["loop_phases"].append((PHASES[slot], ts - val, ts))
                elif event == "clock":
                    s["clock"].append((ts, val))
                elif event == "admit_batch":
                    batch, left = [], slot
                    s["admissions"].append((ts, val, batch))
                elif event == "prefill_device":
                    device_ns[slot] = device_ns.get(slot, 0) + val
            if ev is None:
                break
            seq, ts, event, rid, slot, val = ev
            s = out.get(rid) or self._span_row(out, rid)
            if event == "submit":
                s["submit_ns"] = ts
            elif event == "queue_depart":
                s["queue_depart_ns"] = ts
            elif event == "admit":
                s["admit_ns"] = ts
                if left:
                    batch.append(rid)
                    left -= 1
            elif event == "prefill_start":
                s["prefill_start_ns"] = ts
            elif event == "handoff":
                s["handoff_ns"] = ts
                s["handoffs"] += 1
            elif event == "pool_install":
                s["pool_install_ns"] = ts
            elif event == "prefill_chunk":
                s["prefill_chunks"] += 1
            elif event in ("first_token", "token"):
                if event == "first_token":
                    s["first_token_ns"] = ts
                if s["first_tok_ns"] is None:
                    s["first_tok_ns"] = ts
                s["last_tok_ns"] = ts
                s["tokens"] += 1
                last = s["_last_tok_ns"]
                if s["_resume_ns"] is not None:
                    s["resume_latency_ms"].append(
                        (ts - s["_resume_ns"]) / 1e6)
                    s["_resume_ns"] = None
                elif last is not None and event == "token":
                    s["itl_ms"].append((ts - last) / 1e6)
                s["_last_tok_ns"] = ts
            elif event == "park":
                s["parks"] += 1
                s["_park_ns"] = ts
            elif event == "evict":
                s["evicted_blocks"] += val
            elif event == "swap_out":
                s["swap_out_bytes"] += val
            elif event == "swap_in":
                s["swap_in_bytes"] += val
            elif event == "fault_recompute":
                s["fault_recomputes"] += 1
            elif event == "resume":
                if s["_park_ns"] is not None:
                    s["parked_ms"] += (ts - s["_park_ns"]) / 1e6
                    s["_park_ns"] = None
                s["_resume_ns"] = ts
            elif event == "shed":
                s["sheds"] += 1
            elif event in ("migrate_out", "migrate_in"):
                # a migrated-out request leaves this engine parked: its
                # parked window closes here (the stream continues under a
                # fresh rid on the destination's trace)
                if s["_park_ns"] is not None:
                    s["parked_ms"] += (ts - s["_park_ns"]) / 1e6
                    s["_park_ns"] = None
                s["migrations"] += 1
            elif event == "fault":
                s["faults"] += 1
            elif event == "worker_restart":
                s["worker_restarts"] += 1
            elif event == "retire":
                # cancel-while-parked retires with no resume: the parked
                # window still closes here, or parked_ms would undercount
                if s["_park_ns"] is not None:
                    s["parked_ms"] += (ts - s["_park_ns"]) / 1e6
                    s["_park_ns"] = None
                s["retire_ns"] = ts
                # why the stream ended, straight off the event's typed
                # terminal code — the post-mortem attribution this span
                # exists for (unknown codes read as OK for forward compat)
                s["terminal"] = TERMINAL_NAMES.get(val, "OK")
        for s in out.values():
            sub, adm, ft = s["submit_ns"], s["admit_ns"], s["first_token_ns"]
            dep = s["queue_depart_ns"] or adm
            s["queue_wait_ms"] = (
                (dep - sub) / 1e6 if sub is not None and dep is not None
                else None)
            s["ttft_ms"] = (
                (ft - sub) / 1e6 if sub is not None and ft is not None
                else None)
            # the TTFT split's other half: queue departure (or, on the
            # disagg path, the worker's claim) -> first token. queue_wait
            # + prefill_exec ≈ ttft, the attribution the disagg A/B reads.
            start = (s["prefill_start_ns"] or s["queue_depart_ns"]
                     or s["admit_ns"])
            s["prefill_exec_ms"] = (
                (ft - start) / 1e6
                if start is not None and ft is not None and ft >= start
                else None)
            for k in ("_last_tok_ns", "_park_ns", "_resume_ns"):
                del s[k]
        for rid, ns in device_ns.items():
            if rid in out:
                out[rid]["prefill_device_ms"] = ns / 1e6
        return out

    # -------------------------------------------------------------- export

    def to_jsonl(self, dest: Union[str, IO]) -> int:
        """Dump the event snapshot as JSON Lines (one event per line).
        Returns the number of events written."""
        events = self.events()
        if hasattr(dest, "write"):
            for e in events:
                dest.write(json.dumps(e) + "\n")
        else:
            with open(dest, "w") as fh:
                for e in events:
                    fh.write(json.dumps(e) + "\n")
        return len(events)

    def chrome_trace(self, pid: int = 1, name: str = "vtpu-serving",
                     t0_ns: Optional[int] = None, clock: str = "monotonic") -> dict:
        """The snapshot as a Chrome ``trace_event`` JSON object (the
        "JSON Array Format" wrapped in ``{"traceEvents": [...]}``) that
        loads in Perfetto: one track (tid) per request carrying complete
        ("X") slices for the queued / streaming / parked phases, plus
        instant ("i") markers for every raw lifecycle event, and the
        "engine loop" track (tid -1) with a slice per loop phase.
        Timestamps are microseconds relative to the earliest stamp.

        ``pid``/``name`` tag every event with this trace's process id and
        display name, and ``t0_ns`` overrides the timestamp origin — the
        multi-engine merge hooks: each engine's ring dumps under its OWN
        pid (rids only name tracks within a pid, so equal rids on two
        engines stop colliding) against one shared fleet origin. The
        defaults reproduce the single-engine output byte-identically.

        ``clock="profiler"`` moves every stamp onto the wall clock
        ``torch.profiler`` stamps in, by the nearest ``clock`` event, with
        the origin at 0 of that clock (``t0_ns``, in that clock, overrides
        it), so the dump and a profiler export load into one Perfetto
        timeline. A ring without a ``clock`` event cannot be moved."""
        evs = self.snapshot()
        loop = self.loop_snapshot()
        phases = [e for e in loop if e[2] == "loop_phase"]
        marks = [(e[1], e[5]) for e in loop if e[2] == "clock"]
        instants = [e for e in loop if e[2] not in ("loop_phase", "clock")]
        if clock == "profiler":
            if not marks:
                raise ValueError("the ring holds no clock event to move its stamps by")
            at = [m[0] for m in marks]

            def moved(ns: int) -> int:
                i = bisect.bisect_left(at, ns)
                near = min((j for j in (i - 1, i) if 0 <= j < len(at)),
                           key=lambda j: abs(at[j] - ns))
                return ns + marks[near][1]
        elif clock != "monotonic":
            raise ValueError(f"clock must be 'monotonic' or 'profiler', got {clock!r}")
        out: list[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name},
        }]
        if not evs and not phases and not instants:
            return {"traceEvents": out, "displayTimeUnit": "ms"}
        if t0_ns is not None:
            t0 = t0_ns
        elif clock == "profiler":
            t0 = 0
        else:
            t0 = min([e[1] for e in evs + instants] + [e[1] - e[5] for e in phases])
        if clock == "profiler":
            us = lambda ns: (moved(ns) - t0) / 1e3  # noqa: E731
        else:
            us = lambda ns: (ns - t0) / 1e3  # noqa: E731
        seen: set[int] = set()
        spans = self.spans()
        for seq, ts, event, rid, slot, val in evs:
            if rid not in seen:
                seen.add(rid)
                out.append({"ph": "M", "pid": pid, "tid": rid,
                            "name": "thread_name",
                            "args": {"name": "engine loop" if rid == -1
                                     else f"request {rid}"}})
            out.append({"ph": "i", "pid": pid, "tid": rid, "s": "t",
                        "ts": us(ts), "name": event,
                        "args": {"slot": slot, "val": val, "seq": seq}})
        # phase slices per request, rebuilt from the raw events so a
        # park/resume cycle renders as alternating streaming/parked blocks
        per_rid: dict[int, list] = {}
        for e in evs:
            per_rid.setdefault(e[3], []).append(e)
        for rid, res in per_rid.items():
            open_ns, open_name = None, None
            had_admit = False
            end_ns = res[-1][1]
            for seq, ts, event, slot_, val in (
                    (e[0], e[1], e[2], e[4], e[5]) for e in res):
                if event == "submit":
                    open_ns, open_name = ts, "queued"
                elif event in ("admit", "resume"):
                    if open_ns is not None:
                        out.append({"ph": "X", "pid": pid, "tid": rid,
                                    "ts": us(open_ns),
                                    "dur": max((ts - open_ns) / 1e3, 0.001),
                                    "name": open_name})
                    # a deferred-park request (parked while still waiting)
                    # resumes back into the QUEUE, not a slot: it is not
                    # streaming until its admit closes this slice
                    streaming = event == "admit" or had_admit
                    had_admit = had_admit or event == "admit"
                    open_ns = ts
                    open_name = "streaming" if streaming else "queued"
                elif event in ("park", "retire"):
                    if open_ns is not None:
                        out.append({"ph": "X", "pid": pid, "tid": rid,
                                    "ts": us(open_ns),
                                    "dur": max((ts - open_ns) / 1e3, 0.001),
                                    "name": open_name})
                    open_ns = ts if event == "park" else None
                    open_name = "parked" if event == "park" else None
            if open_ns is not None and end_ns > open_ns:
                out.append({"ph": "X", "pid": pid, "tid": rid,
                            "ts": us(open_ns),
                            "dur": (end_ns - open_ns) / 1e3,
                            "name": open_name or "streaming"})
            span = spans.get(rid)
            if span and span["ttft_ms"] is not None:
                # counter track: TTFT per request, visible as a value
                out.append({"ph": "C", "pid": pid, "ts": us(res[0][1]),
                            "name": "ttft_ms",
                            "args": {"ms": round(span["ttft_ms"], 3)}})
        # the prefill-worker lanes (disaggregated serving): one track PER
        # WORKER (tid = PREFILL_LANE_TID + wid, the wid rides the event's
        # slot field) carrying a slice per request from the worker's claim
        # (prefill_start) to the handoff — the role split made visible
        # next to the per-request queued/streaming/parked tracks. With
        # prefill_workers > 1 concurrent prefills overlap in time; on one
        # shared tid Perfetto would render them as nested frames of a
        # single thread, hiding exactly the concurrency the lane shows.
        lane: list[dict] = []
        lane_tids: set = set()
        for rid, res in per_rid.items():
            start_ns = None
            wid = 0
            for _, ts, event, _, slot, _ in res:
                if event == "prefill_start":
                    start_ns = ts
                    wid = slot if slot is not None and slot >= 0 else 0
                elif start_ns is not None and event in ("handoff", "retire"):
                    # retire closes the slice for budget-1 / cancelled
                    # requests that never produce a handoff
                    tid = PREFILL_LANE_TID + wid
                    lane_tids.add(tid)
                    lane.append({"ph": "X", "pid": pid,
                                 "tid": tid,
                                 "ts": us(start_ns),
                                 "dur": max((ts - start_ns) / 1e3, 0.001),
                                 "name": f"prefill r{rid}",
                                 "args": {"rid": rid, "worker": wid}})
                    start_ns = None
        if lane:
            for tid in sorted(lane_tids):
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name":
                                     f"prefill worker "
                                     f"{tid - PREFILL_LANE_TID}"}})
            out.extend(lane)
        # the engine-loop track: where the loop thread's time went, beside
        # the requests it served, and its admission batches and device times
        if phases or instants:
            if -1 not in seen:
                out.append({"ph": "M", "pid": pid, "tid": -1, "name": "thread_name",
                            "args": {"name": "engine loop"}})
            for _, ts, _, _, slot, val in phases:
                out.append({"ph": "X", "pid": pid, "tid": -1, "ts": us(ts - val),
                            "dur": val / 1e3, "name": PHASES[slot]})
            for seq, ts, event, _, slot, val in instants:
                out.append({"ph": "i", "pid": pid, "tid": -1, "s": "t", "ts": us(ts),
                            "name": event, "args": {"slot": slot, "val": val, "seq": seq}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def to_chrome_trace(self, dest: Union[str, IO]) -> dict:
        doc = self.chrome_trace()
        if hasattr(dest, "write"):
            json.dump(doc, dest)
        else:
            with open(dest, "w") as fh:
                json.dump(doc, fh)
        return doc
