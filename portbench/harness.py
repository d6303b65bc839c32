"""One run of one cell: load, warm up, measure, compare, report.

``run_cell`` builds the weights from the seed and the engine from the
configuration, warms every admission shape the mix forms and then the
mix itself, measures for ``seconds``, drains the requests due in the
window, reads the cell's metrics (each by its own reader), frees the
engine and compares a sample of what it served with the plain reference.
It returns the result line's object. ``run.py`` is its command line; the
tests call it on the CPU at a tiny size.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import gc
import sys
import threading
import time
from typing import Optional

import torch

from portbench import catalog, check, system, traffic
from portbench import yardstick as ys
from portbench.client import Clients, Record

# the trace ring of a --trace 1 run holds every event of a window (one a
# token): the engine's default (16384) wraps within seconds
TRACE_EVENTS = 1 << 21
# the stretch of the window a --trace 1 run hands to the profiler: from a
# quarter into it, this long at most (every kernel is an event to read
# back, about 10^5 a second at these sizes). The profiler slows the loop
# and leaves a backlog behind it, so the spans and counters are read over
# the window before it (``quiet``). Started at the window's last seconds
# instead, the profiler recorded a fraction of the kernels or none, and
# once never returned (H100, torch 2.11)
TRACE_SPAN_S = 5.0
# a traced run's span metrics take the requests due this long before the
# profiler starts at the latest (admitted before it)
QUIET_MARGIN_NS = 1_000_000_000
# a traced token counts to the paged kernel's bytes when it was delivered
# this long after the stretch opened (the tick that made it ran inside)
PAGED_MARGIN_NS = 100_000_000
# a closed loop's requests still running at the window's close are
# cancelled and must end within this
CANCEL_S = 60.0
# names the result may not find loaded: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "vtpu")


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads."""

    workload: str
    seed: int
    seconds: float
    cfg: dict
    mix: dict
    t0: int  # the window, monotonic ns
    t1: int
    setup_s: float
    records: list
    admissions: list
    stats0: dict
    stats1: dict
    prof0: dict
    prof1: dict
    lateness_ns: list
    quiet_end: int  # the window's end, or where a traced run's profiler starts
    spans: Optional[dict] = None
    ops: Optional[list] = None  # device operations (name, start, end) of the traced stretch
    dev_window: Optional[tuple] = None  # the stretch in the device's clock
    host_trace: Optional[tuple] = None  # the stretch in monotonic ns

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def quiet_s(self) -> float:
        """The window's seconds before the profiler (all of it untraced);
        ``stats1`` and ``prof1`` are read at its end."""
        return (self.quiet_end - self.t0) / 1e9

    def quiet_sample(self) -> list[Record]:
        """``sample()`` less the requests due close to or inside the traced
        stretch."""
        if self.quiet_end >= self.t1:
            return self.sample()
        return [r for r in self.sample() if r.due_ns < self.quiet_end - QUIET_MARGIN_NS]

    def sample(self) -> list[Record]:
        """The requests the latency metrics are taken over: the open loop's
        due in the window, the closed loop's submitted in it."""
        return [r for r in self.records if r.kind == "mix" and r.in_window]

    def ttft_ms(self) -> list[float]:
        return [(r.q.stamps[0] - r.due_ns) / 1e6 for r in self.sample() if r.q.stamps]

    def itl_ms(self) -> list[float]:
        out = []
        for r in self.sample():
            s = r.q.stamps
            out.extend((b - a) / 1e6 for a, b in zip(s, s[1:]))
        return out

    def tokens_between(self, a: int, b: int):
        """(record, index) of every token delivered in [a, b)."""
        for r in self.records:
            for i, t in enumerate(r.q.stamps):
                if a <= t < b:
                    yield r, i

    def delta(self, key: str) -> float:
        return self.stats1[key] - self.stats0[key]

    def phase_ms(self, phases) -> float:
        return sum(self.prof1[p]["total_ms"] - self.prof0[p]["total_ms"] for p in phases)

    def quiet_flops(self) -> float:
        """Model FLOPs of the steps of the window before the profiler: every
        admission dispatched in it (its real prompt tokens) and every
        decoded token delivered in it (a request's first token is its
        admission's)."""
        total = 0.0
        for t, _, _, lens in self.admissions:
            if self.t0 <= t < self.quiet_end:
                total += sum(ys.prompt_flops(self.cfg, n) for n in lens)
        for r, i in self.tokens_between(self.t0, self.quiet_end):
            if i > 0:
                total += ys.decode_flops(self.cfg, len(r.prompt) + i)
        return total

    def kernel_s(self, match) -> float:
        return sum(e - s for name, s, e in self.ops if match(name)) / 1e9


def is_flash(name: str) -> bool:
    return "flash_fwd" in name


def is_paged(name: str) -> bool:
    return ("decode_split" in name or "split_combine" in name) and "DenseSrc" not in name


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace noise, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ").strip()
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.strip()[:80] or "?"


def breakdown(ops, window) -> dict:
    """The ten device operations that took most time, by name, and the ten
    longest idle gaps, named by the operation before each."""
    a, b = window
    inside = ys.clip([(s, e) for _, s, e in ops], a, b)
    by_name: dict[str, int] = {}
    for name, s, e in ops:
        s, e = max(s, a), min(e, b)
        if e > s:
            by_name[_short(name)] = by_name.get(_short(name), 0) + e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ends = sorted((e, _short(name)) for name, s, e in ops)
    gaps = []
    for g, at in ys.idle_gaps(inside, a, b)[:10]:
        before = [n for e, n in ends if e <= at]
        gaps.append([f"after {before[-1]}" if before else "window start", g / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in top], "idle_gaps": gaps}


def mix_buckets(cfg: dict, mix: dict) -> list[int]:
    """The admission buckets the mix's prompt lengths fall into."""
    lo, hi = traffic.size_range(mix["prompt_tokens"])
    buckets = sorted(cfg["serving"]["prefill_buckets"])
    return sorted({system.bucket_of(n, buckets) for n in (lo, hi)}
                  | {b for b in buckets if lo <= b <= hi})


def _sleep_until(ns: int) -> None:
    left = (ns - time.monotonic_ns()) / 1e9
    if left > 0:
        time.sleep(left)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start_ns: int,
             device="cuda", log=None, control: bool = False,
             watchdog_s: Optional[float] = None) -> dict:
    """One run of ``cell`` (``catalog.cell``'s dict) from process start
    ``t_start_ns`` (monotonic). Returns the result object. ``control``
    also reads the control's gap (portbench/control.py; never in a run of
    the benchmark). ``watchdog_s``: once the engine is built, a run that
    has not returned this many seconds later prints every thread's stack
    to standard error and ends the process with exit code 1 (a hang
    inside the profiler or a kernel holds the interpreter, so this is a C
    thread's timer)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))

    def stage(what: str) -> None:
        log(f"{(time.monotonic_ns() - t_start_ns) / 1e9:8.2f} s  {what}")

    cfg, mix, cp = cell["cfg"], cell["mix"], cell["params"]
    cuda = torch.device(device).type == "cuda"
    stage("start")
    params = system.make_params(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    stage("weights made")
    eng = system.build_engine(cfg, params, device, TRACE_EVENTS if trace else None)
    stage("engine built (kernels, graphs)")
    if watchdog_s is not None:
        faulthandler.dump_traceback_later(watchdog_s, exit=True)
    clients = Clients(eng)
    try:
        sizes = [n for n in cfg["serving"]["prefill_batch_sizes"] if n <= eng.serving.slots]
        warm = traffic.warm_shapes(mix_buckets(cfg, mix), sizes, seed, cfg["vocab_size"])
        clients.warm_shapes(warm)
        eng.start()
        if not clients.wait(clients.records, time.monotonic_ns() + int(300e9)):
            raise RuntimeError("the shape warm-up did not finish")
        stage(f"admission shapes warmed ({len(warm)} prompts)")
        if mix["loop"] == "open":
            plan = traffic.open_loop(mix, cp["rate_per_s"], seconds, seed, cfg["vocab_size"])
        else:
            plan = traffic.closed_loop(mix, seed, cfg["vocab_size"])
        stop = threading.Event()
        start = time.monotonic_ns() + 50_000_000
        t0 = start + int(mix["warmup_s"] * 1e9)
        t1 = t0 + int(seconds * 1e9)
        if mix["loop"] == "open":
            feeder = clients.open_loop(plan, start, stop)
        else:
            _sleep_until(start)
            feeder = clients.closed_loop(plan, mix["clients"], (t0, t1), stop)
        _sleep_until(t0)
        setup_s = (time.monotonic_ns() - t_start_ns) / 1e9
        stage("window opens (the mix warmed)")
        stats0, prof0 = eng.stats(), eng.tick_profile.snapshot()
        traced = trace and cuda
        _sleep_until(t0 + (t1 - t0) // 4 if traced else t1)
        stats1, prof1 = eng.stats(), eng.tick_profile.snapshot()
        quiet_end = min(time.monotonic_ns(), t1)
        if clients.lateness_ns:
            late = clients.lateness_ns
            stage(f"the generator's lateness: p95 {ys.percentile(late, 95) / 1e6:.3f} ms, "
                  f"max {max(late) / 1e6:.3f} ms over {len(late)} requests")
        dtrace = None
        if traced:
            from portbench.devtrace import DeviceTrace

            dtrace = DeviceTrace(eng)
            dtrace.start()
            time.sleep(min(TRACE_SPAN_S, seconds / 2))
            dtrace.stop()
            stage(f"traced on the loop thread (the profiler's start {dtrace.start_s:.3f} s, "
                  f"stop {dtrace.stop_s:.3f} s)")
            _sleep_until(t1)
        if mix["loop"] == "open":
            feeder.join()
            mine = [r for r in clients.records if r.kind == "mix"]
            clients.wait(mine, t1 + int(mix["drain_s"] * 1e9))
        else:
            stop.set()
            feeder.join()
            mine = [r for r in clients.records if r.q.status is None]
            for r in mine:
                r.req.cancel()
            clients.wait(mine, time.monotonic_ns() + int(CANCEL_S * 1e9))
        unfinished = [r for r in clients.records if r.q.status is None]
        for r in unfinished:
            r.req.cancel()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        end = eng.stats()
        stage(f"drained; KV blocks in use at most {end['kv_pool_used_hwm']} of "
              f"{end['kv_pool_blocks']}")
        spans = eng.trace.spans() if trace else None
    finally:
        eng.stop()
        clients.close()
    run = RunData(cell["name"], seed, seconds, cfg, mix, t0, t1, setup_s,
                  clients.records, clients.admissions, stats0, stats1, prof0, prof1,
                  clients.lateness_ns, quiet_end, spans)
    if dtrace is not None:
        run.ops, run.dev_window, run.host_trace = dtrace.ops, dtrace.window, dtrace.host
        stage(f"{len(run.ops)} device operations traced")
        raw: dict[str, int] = {}
        for name, s0, e0 in run.ops:
            raw[name] = raw.get(name, 0) + e0 - s0
        for name, ns in sorted(raw.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  {ns / 1e9:.4f} s  {name[:160]}")
    metrics = {}
    for m in catalog.metrics(cell["name"], trace, cell.get("bench")):
        value = catalog.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    judged = _judged(run, mix)
    result = {"correct": False, "attempted": len(judged),
              "failed": sum(not r.ok for r in judged), "metrics": metrics}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if dtrace is not None:
        a, b = run.dev_window
        device_info["busy_s"] = ys.union_ns(ys.clip([(s, e) for _, s, e in run.ops], a, b)) / 1e9
        device_info["window_s"] = (b - a) / 1e9
        result["breakdown"] = breakdown(run.ops, run.dev_window)
    result["device"] = device_info
    # the program's state goes before the reference runs beside the weights
    del eng, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cands = [r for r in run.records if r.kind == "mix" and r.ok
             and (r.in_window or mix["loop"] == "closed")]
    picked = check.sample(cands, cp["sample_requests"], seed)
    t_ref = time.monotonic()
    got = check.widest_gaps(cfg, params, picked, run.admissions,
                            {r.rid: r for r in run.records}, device, control=control)
    log(f"reference: {len(picked)} requests, {got['tokens']} served tokens, widest gap "
        f"{got['max_logit_gap']:.4f}, mean gap {got['mean_logit_gap']:.5f}, "
        f"{got['dropped']} of {got['claims']} expert choices dropped at admission, "
        f"{time.monotonic() - t_ref:.1f} s")
    checks = {name: {"value": got[name], "limit": limit}
              for name, limit in cp["limits"].items()}
    checks["failed_requests"] = {"value": result["failed"], "limit": 0}
    checks["served_tokens_compared"] = {"value": got["tokens"], "limit": cp["min_tokens"]}
    result["correct"] = (all(got[name] <= limit for name, limit in cp["limits"].items())
                         and result["failed"] == 0 and got["tokens"] >= cp["min_tokens"])
    if control:
        for name in ("max_logit_gap", "mean_logit_gap", "control_max_logit_gap",
                     "control_mean_logit_gap"):
            checks[name] = {"value": got[name], "limit": cp["limits"].get(
                name.removeprefix("control_"))}
    result["checks"] = checks
    if watchdog_s is not None:
        faulthandler.cancel_dump_traceback_later()
    return result


def _judged(run: RunData, mix: dict) -> list:
    """The requests ``attempted`` counts: the open loop's due in the
    window; the closed loop's that ended inside it (those still running at
    its close are cut by the run, not failed)."""
    if mix["loop"] == "open":
        return run.sample()
    return [r for r in run.records if r.kind == "mix" and r.q.end_ns is not None
            and run.t0 <= r.q.end_ns < run.t1]
