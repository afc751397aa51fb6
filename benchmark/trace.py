"""The device trace of a window: ``torch.profiler`` over CPU and CUDA
activity, exported as a Chrome trace and reduced to what the per-layer
readers take: device busy time (the union of every kernel, copy and
set), time and count by kernel name, copy time, and the device's idle
gaps named by the host work that spans them."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Callable, NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def kernel_name(raw: str) -> str:
    """The profiler's kernel name without its return type, arguments or
    spaces: ``window_kernel<false,false,false>``."""
    name = re.sub(r"^void\s+", "", raw.strip())
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].replace(", ", ",").strip()


class Trace(NamedTuple):
    window_s: float          # the traced window by the host clock
    busy_s: float            # union of device activity
    by_kernel: dict          # name -> [seconds, count]
    copy_s: float            # device memcpy seconds
    launches: int            # kernels run
    gaps: list               # [[host work, seconds]], longest first

    def kernel(self, prefix: str) -> tuple[float, int]:
        """Seconds and count of the kernels whose name starts with
        ``prefix``."""
        s = n = 0
        for name, (sec, cnt) in self.by_kernel.items():
            if name.startswith(prefix):
                s += sec
                n += cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(([k, v[0]] for k, v in self.by_kernel.items()),
                     key=lambda kv: -kv[1])[:top]
        return {"device_ops": ops, "idle_gaps": self.gaps[:top]}


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, window_s: float) -> Trace:
    """A Trace of Chrome-trace events (µs timestamps)."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if cat in DEVICE_CATS:
            dev.append((cat, e.get("name", ""), span))
        elif cat in HOST_CATS:
            host.append((e.get("name", ""), span))
    by_kernel: dict = {}
    copy_us = 0.0
    launches = 0
    for cat, name, (s, t) in dev:
        if cat == "kernel":
            launches += 1
            row = by_kernel.setdefault(kernel_name(name), [0.0, 0])
            row[0] += (t - s) * 1e-6
            row[1] += 1
        elif cat == "gpu_memcpy":
            copy_us += t - s
    merged = _union([span for _, _, span in dev])
    busy_us = sum(e - s for s, e in merged)
    # each gap is named by the longest host event that spans its middle
    # (a sweep over the host events in order of their start)
    gaps: dict = {}
    host.sort(key=lambda h: h[1][0])
    active, i = [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        while i < len(host) and host[i][1][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1][1] >= mid]
        label = max(active, key=lambda h: h[1][1] - h[1][0])[0] \
            if active else "host, outside any traced op"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return Trace(window_s=window_s, busy_s=busy_us * 1e-6,
                 by_kernel=by_kernel, copy_s=copy_us * 1e-6,
                 launches=launches,
                 gaps=sorted(([k, v] for k, v in gaps.items()),
                             key=lambda kv: -kv[1]))


def traced(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """``fn()`` ended by ``sync()`` under ``torch.profiler``; the Chrome
    trace goes to a temporary directory under ``TMPDIR`` and is removed
    once read."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, window_s)
