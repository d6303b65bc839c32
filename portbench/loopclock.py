"""The serving loop's timeline on the device trace's clock.

The engine's trace ring stamps ``time.monotonic_ns``; ``torch.profiler``
stamps the card's operations on the wall clock. The ring's engine-loop
track (``spans()[-1]``) carries both what the loop did (``loop_phases``,
each phase as (phase, start, end)) and ``clock`` events, each the wall
clock's offset from the monotonic one at a moment.

The clock events alone do not place the loop on the device trace. The
profiler's device stamps leave the host's clock inside a stretch: on an
H100 (torch 2.11, CUDA 12.8) they ran off it at a steady rate of 0.06 to
35 ms a second from an exact start, a different rate in each stretch,
and fell back onto it about 4 s in (``hack/torch_profiler_clock_probe.py``
launched a marker every 0.2 s; the fetches below saw the same ramps). So ``phases`` moves each phase by what the loop's own fetches
read: a fetch that waits for the card ends when the copy it waits for
ends (the engine stages one pinned device-to-host copy for each fetch, in
order, on one stream). The n-th fetch of the stretch is the n-th such
copy; the first is found by the clock events where the stretch opens.
Each blocked fetch gives the device clock's offset from the clock events'
mapping at its end (a median of five against a fetch woken late), and the
phases move by those offsets, interpolated between fetches and
extrapolated beyond the first and the last.

The stretch's two markers check that mapping, which never reads them:
each is launched on the loop thread and read on the card as it ran
(``run.dev_window``). The host brackets each launch: devtrace stamps the
start marker just before its launch and the end marker just after
(``run.host_trace``), and the loop's ``hook`` phase that holds each stamp
ends just after the start marker's launch returns and begins just before
the end marker's is made. Mapped onto the device's clock, a marker should
start inside its bracket; one that misses it by more than ``REFUSE_NS``
means the mapping is wrong, and it raises. ``split`` then divides the
card's idle time in the stretch by the phase the loop was in.

A program without the loop track (one that predates it) gives ``None``
everywhere: its readers report nothing.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Optional

from portbench.yardstick import idle_gaps

# a marker this far outside its launch's bracket on the mapped clock: the
# mapping is wrong (the markers of sound runs sat within 0.24 ms)
REFUSE_NS = 1_000_000
# a fetch this long waited for its copy: it ended as the copy did
BLOCKED_NS = 200_000
# where the stretch opens the clock events place a fetch within this of its
# copy's end: under half the 25 ms between the ticks' copies, so the nearest
# copy is the fetch's own (the start markers of the benchmark's runs sat
# within 0.24 ms, one probe stretch's 3.4 ms off); a pairing a copy off
# puts the markers a tick off their launches, and the check refuses it
ALIGN_NS = 10_000_000
# the phases in which the loop works on the host with the card free to run
# ahead: what the card's idle time there waits for is the host
HOST_PHASES = ("admission", "dispatch", "deliver", "swap_drain")
# the idle time that falls between two phases: the loop's own bookkeeping
BETWEEN = "between"


def loop_track(run) -> Optional[dict]:
    """The ring's engine-loop track of a traced run, or None where the
    program records no loop phases or clock events, or nothing was traced."""
    if run.spans is None or run.ops is None or run.dev_window is None:
        return None
    loop = run.spans.get(-1)
    if not loop or not loop.get("loop_phases") or not loop.get("clock"):
        return None
    return loop


def to_device(clock: list, ns: int) -> int:
    """A monotonic stamp on the wall clock, by the nearest clock event."""
    at = [t for t, _ in clock]
    i = bisect.bisect_left(at, ns)
    near = min((j for j in (i - 1, i) if 0 <= j < len(at)), key=lambda j: abs(at[j] - ns))
    return ns + clock[near][1]


def copy_ends(run) -> list[int]:
    """The end of every pinned device-to-host copy on the card, in order:
    the copies the engine's fetches wait for."""
    return sorted(e for name, _, e in run.ops
                  if name.startswith("Memcpy DtoH") and "Pinned" in name)


def anchors(run, loop: dict) -> Optional[list[tuple[int, int]]]:
    """Each blocked fetch in the stretch as (its end in monotonic ns, the
    device clock's offset there from the clock events' mapping), the
    offsets a median of five; None where no fetch of the stretch's opening
    finds its copy."""
    clock = sorted(loop["clock"])
    a, b = run.dev_window
    fetches = sorted((s, e) for name, s, e in loop["loop_phases"] if name == "fetch")
    ends = copy_ends(run)
    if not fetches or not ends:
        return None
    mapped = [to_device(clock, e) for _, e in fetches]
    first = next((j for j, (s, e) in enumerate(fetches)
                  if e - s >= BLOCKED_NS and mapped[j] > a + ALIGN_NS), None)
    if first is None:
        return None
    k = bisect.bisect_left(ends, mapped[first])
    i0 = min((i for i in (k - 1, k) if 0 <= i < len(ends)),
             key=lambda i: abs(ends[i] - mapped[first]))
    if abs(ends[i0] - mapped[first]) > ALIGN_NS:
        return None
    raw = [(e, ends[i] - mapped[j]) for j, (s, e) in enumerate(fetches)
           for i in (i0 + j - first,)
           if 0 <= i < len(ends) and e - s >= BLOCKED_NS and a <= ends[i] <= b]
    out = []
    for n, (t, _) in enumerate(raw):
        half = min(2, n, len(raw) - 1 - n)  # centred, so a steady ramp stays itself
        out.append((t, int(statistics.median(o for _, o in raw[n - half:n + half + 1]))))
    return out


def mover(run, loop: dict):
    """A function that moves a monotonic stamp onto the device's clock: by
    the clock events, then by the anchors' offset there (interpolated
    between them, extrapolated from the two nearest beyond them). Raises
    where the stretch's opening finds no anchor."""
    clock = sorted(loop["clock"])
    got = anchors(run, loop)
    if not got:
        raise RuntimeError("no fetch of the traced stretch found the copy it waited for on the "
                           "card: the loop's phases cannot be placed on the device's clock")
    at = [t for t, _ in got]

    def move(ns: int) -> int:
        # between the two nearest anchors, or along them beyond the ends (a
        # ramp runs on to the stretch's markers)
        i = min(max(bisect.bisect_left(at, ns), 1), len(at) - 1)
        if len(at) == 1:
            off = got[0][1]
        else:
            (t0, o0), (t1, o1) = got[i - 1], got[i]
            off = o0 + (o1 - o0) * (ns - t0) // (t1 - t0)
        return to_device(clock, ns) + off

    return move


def brackets(run, loop: dict) -> list[tuple[int, int]]:
    """Each marker's launch on the host, (before, after) in monotonic ns:
    the start marker's stamp and the end of the hook phase holding it, the
    start of the hook phase holding the end marker's stamp and that stamp
    (a stamp in no hook phase brackets its launch alone)."""
    hooks = [(s, e) for name, s, e in loop["loop_phases"] if name == "hook"]

    def hook(ns: int):
        return next(((s, e) for s, e in hooks if s <= ns <= e), (ns, ns))

    h0, h1 = run.host_trace
    return [(h0, hook(h0)[1]), (hook(h1)[0], h1)]


def marker_errors(run, loop: dict, move=None) -> list[int]:
    """How far each marker started on the card outside its launch's
    bracket, mapped onto the device's clock by ``move`` (by default the
    clock events alone) (ns; negative: before the launch began, positive:
    after it returned, 0: inside)."""
    if move is None:
        clock = sorted(loop["clock"])
        move = lambda ns: to_device(clock, ns)  # noqa: E731
    out = []
    for (before, after), dev in zip(brackets(run, loop), run.dev_window):
        lo, hi = move(before), move(after)
        out.append(dev - lo if dev < lo else dev - hi if dev > hi else 0)
    return out


def phases(run) -> Optional[list]:
    """The loop's phases as (phase, start, end) on the device's clock,
    those that overlap the traced stretch, in order; None without a loop
    track. Raises where the fetches find no copies, or where the mapping
    puts a marker more than ``REFUSE_NS`` outside its launch."""
    loop = loop_track(run)
    if loop is None:
        return None
    move = mover(run, loop)
    e0, e1 = marker_errors(run, loop, move)
    if max(abs(e0), abs(e1)) > REFUSE_NS:
        raise RuntimeError(
            f"the loop's fetches put the traced stretch's markers {e0 / 1e6:+.3f} and "
            f"{e1 / 1e6:+.3f} ms outside their launches on the device's clock: the program's "
            "spans and the device trace no longer share a clock")
    a, b = run.dev_window
    out = []
    for name, s, e in loop["loop_phases"]:
        s, e = move(s), move(e)
        if e > a and s < b:
            out.append((name, s, e))
    return sorted(out, key=lambda p: p[1])


def pieces(run) -> Optional[list]:
    """Every stretch of the traced window in which the card ran nothing,
    cut by the loop phases: (phase, ns, the whole idle gap's ns), with
    ``BETWEEN`` for the idle time inside no phase. None without a loop
    track."""
    ph = phases(run)
    if ph is None:
        return None
    a, b = run.dev_window
    out = []
    gaps = sorted((s, s + g) for g, s in idle_gaps([(s, e) for _, s, e in run.ops], a, b))
    i = 0
    for gs, ge in gaps:
        while i < len(ph) and ph[i][2] <= gs:
            i += 1
        covered = 0
        j = i
        while j < len(ph) and ph[j][1] < ge:
            name, s, e = ph[j]
            part = min(e, ge) - max(s, gs)
            if part > 0:
                out.append((name, part, ge - gs))
                covered += part
            j += 1
        if ge - gs > covered:
            out.append((BETWEEN, ge - gs - covered, ge - gs))
    return out


def split(run) -> Optional[dict]:
    """ns of the traced stretch in which the card ran nothing, by the loop
    phase that overlapped it (``BETWEEN``: inside no phase). None without
    a loop track."""
    parts = pieces(run)
    if parts is None:
        return None
    out = {BETWEEN: 0}
    for name, ns, _ in parts:
        out[name] = out.get(name, 0) + ns
    return out


def share(run, names) -> Optional[float]:
    """Percent of the traced stretch in which the card was idle while the
    loop was in one of ``names``."""
    parts = split(run)
    if parts is None:
        return None
    a, b = run.dev_window
    return 100.0 * sum(parts.get(n, 0) for n in names) / (b - a)


def covered(run) -> Optional[float]:
    """Share of the traced stretch that the loop's phases cover: the loop
    thread's time the spans account for."""
    ph = phases(run)
    if ph is None:
        return None
    a, b = run.dev_window
    return sum(min(e, b) - max(s, a) for _, s, e in ph) / (b - a)
