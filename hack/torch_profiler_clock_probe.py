#!/usr/bin/env python3
"""Where torch.profiler's device stamps leave the host's clock: the
measurement behind ``portbench/loopclock.py``'s mapping by the fetches.

    python3 hack/torch_profiler_clock_probe.py [CYCLES]

On a CUDA card. A loop thread like the serving engine's: each tick
replays a CUDA graph, stages a device->host copy into pinned memory with
an event behind it, and waits for the previous tick's copy (the pipelined
fetch). Every 10th tick it launches a spin marker on a high-priority
stream, bracketed by wall-clock stamps. The profiler (CUDA activity)
starts and stops on the loop thread for 5-s stretches, CYCLES of them
(default 10), every other one with the host's cores oversubscribed by 12
spinning processes. Per stretch it prints each marker's start against its
launch bracket and each blocked fetch's return against the end of the
copy it waited for, all on the wall clock, and the whole series where a
marker misses its bracket by more than 0.3 ms.
"""
import multiprocessing as mp
import os
import sys
import threading
import time

os.environ["TEARDOWN_CUPTI"] = "0"  # as portbench/run.py: set before torch loads

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

STRETCH = 5.0


def spinner(stop):
    x = 0
    while not stop.is_set():
        x += 1


def main():
    cycles = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16)
    s = torch.cuda.Stream()
    hi = torch.cuda.Stream(priority=-1)
    out = torch.zeros(64, dtype=torch.int32, device=dev)
    with torch.cuda.stream(s):
        for _ in range(3):
            y = a
            for _ in range(150):
                y = (y @ a) * 0.001 + a
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            y = a
            for _ in range(150):
                y = (y @ a) * 0.001 + a
            out.copy_(y[0, :64].to(torch.int32))
    torch.cuda.synchronize()
    cmd = {"prof": None, "quit": False}
    rec = []  # (kind, mono, wall, extra)
    done_cmd = threading.Event()

    def loop():
        torch.cuda.set_stream(s)
        prev = None
        tick = 0
        while not cmd["quit"]:
            act = cmd.get("act")
            if act is not None:
                cmd["act"] = None
                act()
                done_cmd.set()
            if tick % 10 == 0 and cmd["prof"] is not None:
                m0, w0 = time.monotonic_ns(), time.time_ns()
                with torch.cuda.stream(hi):
                    torch.cuda._sleep(1000)
                m1, w1 = time.monotonic_ns(), time.time_ns()
                rec.append(("mark", m0, w0, (m1, w1)))
            for _ in range(3):
                g.replay()
            host = torch.empty(64, dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                f0 = time.monotonic_ns()
                prev.synchronize()
                f1m, f1w = time.monotonic_ns(), time.time_ns()
                rec.append(("fetch", f1m, f1w, f1m - f0))
            prev = ev
            tick += 1
            # host work between ticks
            np.sort(np.random.rand(20000))

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    time.sleep(2)
    cuda = torch.autograd.DeviceType.CUDA
    for cyc in range(cycles):
        loaded = cyc % 2 == 1
        ctx = mp.get_context("spawn")
        stop = ctx.Event()
        procs = []
        if loaded:
            procs = [ctx.Process(target=spinner, args=(stop,)) for _ in range(12)]
            for q in procs:
                q.start()
        time.sleep(8.0 if loaded else 0.5)  # the spawned spinners import torch first
        p = profile(activities=[ProfilerActivity.CUDA])
        rec.clear()

        def start():
            p.start()
            cmd["prof"] = p
        done_cmd.clear()
        cmd["act"] = start
        done_cmd.wait()
        time.sleep(STRETCH)
        stamps = {}

        def stop_():
            m0, w0 = time.monotonic_ns(), time.time_ns()
            with torch.cuda.stream(hi):
                torch.cuda._sleep(1000)
            m1, w1 = time.monotonic_ns(), time.time_ns()
            rec.append(("mark", m0, w0, (m1, w1)))
            cmd["prof"] = None
            t = time.monotonic()
            p.stop()
            stamps["stop_s"] = time.monotonic() - t
        done_cmd.clear()
        cmd["act"] = stop_
        done_cmd.wait()
        stop.set()
        for q in procs:
            q.join()
        ev = [(e.name(), int(e.start_ns()), int(e.end_ns()))
              for e in p.profiler.kineto_results.events() if e.device_type() == cuda]
        spins = sorted(st for n, st, _ in ev if "spin" in n)
        d2h = sorted(en for n, _, en in ev if "DtoH" in n or "Device -> Pinned" in n)
        marks = [r for r in list(rec) if r[0] == "mark"]
        fetches = [r for r in list(rec) if r[0] == "fetch"]
        w_first = marks[0][2]
        errs = []
        for (_, m0, w0, (m1, w1)), d in zip(marks, spins):
            e = (d - w0) if d < w0 else (d - w1) if d > w1 else 0
            errs.append(((w0 - w_first) / 1e9, e / 1e6, (d - w0) / 1e6))
        res = []
        arr = np.array(d2h) if d2h else np.array([0])
        for _, fm, fw, wait in fetches:
            if wait < 1_000_000:
                continue
            i = np.searchsorted(arr, fw)
            cands = [arr[j] for j in (i - 1, i) if 0 <= j < len(arr)]
            d = min(cands, key=lambda x: abs(x - fw))
            res.append(((fw - w_first) / 1e9, (fw - d) / 1e6))
        r = np.array([x[1] for x in res]) if res else np.zeros(1)
        print(f"cycle {cyc} loaded={loaded} ops={len(ev)} stop_s={stamps['stop_s']:.2f} "
              f"marks={len(marks)}/{len(spins)} max|marker miss| "
              f"{max(abs(e[1]) for e in errs):.3f} ms (first {errs[0][1]:.3f}, last {errs[-1][1]:.3f}); "
              f"fetch F-D ms: n={len(res)} min {r.min():.3f} p50 {np.median(r):.3f} max {r.max():.3f}",
              flush=True)
        if max(abs(e[1]) for e in errs) > 0.3 or r.min() < -0.05 or r.max() > 1.0:
            print("  markers (t s, miss ms, dev-launch ms):",
                  [(round(t, 3), round(m, 3), round(x, 3)) for t, m, x in errs], flush=True)
            print("  fetch residuals (t s, ms):",
                  [(round(t, 3), round(x, 3)) for t, x in res[::max(1, len(res) // 60)]], flush=True)
            print("  last fetch residuals:", [(round(t, 3), round(x, 3)) for t, x in res[-8:]])
    cmd["quit"] = True
    th.join()


if __name__ == "__main__":
    main()
