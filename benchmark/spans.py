"""The program's own spans and counters in a benchmark run: a pass with
the port's tracer on (``traffic_env_tpu_torch/utils/trace.py``) under
``torch.profiler``, after a cell's traced pass, and the readings of it.

:func:`traced_spans` returns the tracer's ``snapshot()`` with the
device's idle seconds put down to the program's spans
(:func:`idle_by_span`).  The functions below it read the eight
per-layer numbers from that (:data:`READINGS`); each returns None, never
0, when the pass has nothing to read (a program without the tracer gives
no pass).
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time

from .trace import DEVICE_CATS, HOST_CATS, _union

OUTSIDE = "outside the program"


def idle_by_span(events: list, names) -> dict:
    """The device's idle seconds of Chrome-trace ``events`` (µs
    timestamps) by the innermost program span (a ``user_annotation``
    named in ``names``) that covers each gap's middle; a gap no program
    span covers goes to OUTSIDE.  The gaps are those between the
    device's busy intervals and, at the edges, between them and the
    first and last host event."""
    dev, host, spans = [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        t = s + float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((s, t))
        elif cat in HOST_CATS:
            host.append((s, t))
            if cat == "user_annotation" and e.get("name") in names:
                spans.append((s, t, e["name"]))
    busy = _union(dev)
    if not busy:
        return {}
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    first, last = min(s for s, _ in host), max(t for _, t in host)
    if first < busy[0][0]:
        gaps.insert(0, (first, busy[0][0]))
    if last > busy[-1][1]:
        gaps.append((busy[-1][1], last))
    out: dict = {}
    spans.sort()
    active, i = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[1] >= mid]
        name = min(active, key=lambda sp: sp[1] - sp[0])[2] if active \
            else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def traced_spans(fn, sync, gather: bool = False):
    """``fn()`` ended by ``sync()`` with the tracer on under
    ``torch.profiler``: ``{"snapshot": the tracer's snapshot (a list over
    the dp ranks with ``gather``), "idle_s": this process's idle seconds
    by span, "window_s", "busy_s"}``, or None when the program has no
    tracer."""
    try:
        from traffic_env_tpu_torch.utils import trace as tracer
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile
    tracer.reset()
    tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            window_s = time.perf_counter() - t0
    finally:
        tracer.disable()
    with tempfile.TemporaryDirectory(prefix="bench_spans_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    snap = tracer.snapshot(gather=gather)
    mine = snap[0] if gather else snap
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X" and "ts" in e
                   and e.get("cat") in DEVICE_CATS])
    return {"snapshot": snap,
            "idle_s": idle_by_span(events, set(mine["spans"])),
            "window_s": window_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-6}


# ------------------------------------------------------------ readings
def _snap(sp):
    """This process's snapshot of a pass (rank 0's of a gathered one)."""
    if not sp:
        return None
    s = sp["snapshot"]
    return s[0] if isinstance(s, list) else s


def _device(snap, name: str):
    """The device seconds of each instance of the span ``name``."""
    s = snap["spans"].get(name) if snap else None
    return s["device_s"] if s and s["device_s"] else None


def _cycles(sp, phases):
    snap = _snap(sp)
    if snap is None:
        return None
    ticks = snap["counters"].get("window.block_ticks")
    cyc = snap["phase_cycles"]
    if not ticks or not cyc:
        return None
    return sum(cyc[p] for p in phases) / ticks


def window_idm_cycles(sp):
    """Cycles of the window's IDM phase a block-tick."""
    return _cycles(sp, ("idm",))


def window_stage_cycles(sp):
    """Cycles of the window's staging phases (stage, store) a
    block-tick."""
    return _cycles(sp, ("stage", "store"))


def mean_ms(sp, name: str):
    """The mean device ms of an instance of the span ``name``."""
    d = _device(_snap(sp), name)
    return sum(d) / len(d) * 1e3 if d else None


def shape_ms(sp):
    """Device ms of ``env.shape`` a step: its first to last shaping
    kernel, the gaps between its launches included."""
    return mean_ms(sp, "env.shape")


def update_fwd_ms(sp):
    """Device ms of an update's loss replay, the forward."""
    return mean_ms(sp, "a3c.update.loss")


def update_bwd_ms(sp):
    """Device ms of an update's ``loss.backward()``."""
    return mean_ms(sp, "a3c.update.backward")


def teacher_ms(sp):
    """Device ms of the teacher's actions summed over a rollout."""
    snap = _snap(sp)
    d = _device(snap, "a3c.teacher")
    n = snap["spans"].get("a3c.rollout", {}).get("count") if snap else None
    return sum(d) / n * 1e3 if d and n else None


def idle_program_ms(sp):
    """Device-idle ms a step while the host was inside an ``env.*``
    span (the innermost program span over the gap)."""
    snap = _snap(sp)
    steps = snap["spans"].get("env.step", {}).get("count") if snap else None
    if not steps or not sp["idle_s"]:
        return None
    return sum(v for k, v in sp["idle_s"].items()
               if k.startswith("env.")) / steps * 1e3


def allreduce_wait_ms(sp):
    """Per update, the slowest rank's ``a3c.update.allreduce`` device
    time less the fastest rank's, averaged over the updates, in ms: the
    last rank to arrive does not wait, so the least is the transfer and
    the rest the wait.  Needs two ranks or more."""
    snaps = sp["snapshot"] if sp else None
    if not isinstance(snaps, list) or len(snaps) < 2:
        return None
    per = [_device(s, "a3c.update.allreduce") for s in snaps]
    if not all(per) or len({len(d) for d in per}) != 1:
        return None
    return statistics.fmean(max(u) - min(u) for u in zip(*per)) * 1e3


READINGS = {"window_idm_cycles.sim": window_idm_cycles,
            "window_stage_cycles.sim": window_stage_cycles,
            "shape_ms.sim": shape_ms,
            "idle_program_ms.hostloop": idle_program_ms,
            "update_fwd_ms.a3c": update_fwd_ms,
            "update_bwd_ms.a3c": update_bwd_ms,
            "teacher_ms.a3c": teacher_ms,
            "allreduce_wait_ms.a3c": allreduce_wait_ms}
