"""The port's tracer: named spans and counters over its layers, off by
default::

    from traffic_env_tpu_torch.utils import trace
    trace.enable()
    ...                       # the program runs
    snap = trace.snapshot()   # gather=True: a list of every dp rank's
    trace.disable()

``span(name)`` is a context manager.  Off, it returns one shared no-op
object, and a module-level flag check is the whole cost of a span site.
On, a span opens ``torch.profiler.record_function(name)`` (any
``torch.profiler`` trace shows the program's spans on the clock of the
device's kernels), takes ``time.perf_counter_ns`` at its edges, keeps
its parent from a stack for self time, and, once CUDA is in use, records
a pair of CUDA events on the current stream, taken from a pool.  The
events are read only by :func:`snapshot`: nothing waits on the device
in between.  ``count(name, n)`` adds to a counter.  Everything stays in
memory until :func:`snapshot`; :func:`reset` clears it.

The spans and counters, and what reads them (``PERF.md`` §3):

* ``env.step`` (``envs/env.py:shaped_step``), ``env.window`` (its
  window wrapper, lazy reset and kernel launch), ``env.shape`` (the
  rest: window obs, remi, localize, squish, history roll).
* ``a3c.rollout`` with ``a3c.act`` (the policy's forward and the
  sampling of a step) and ``a3c.teacher`` (the expert's actions);
  ``a3c.update`` with ``a3c.update.loss``, ``a3c.update.backward``,
  ``a3c.update.allreduce`` (the dp gradient all-reduce) and
  ``a3c.update.step`` (clip and Adam); the bootstrap and GAE are
  ``a3c.update``'s self time.
* ``convgru.input`` (``models/nets.py:ConvGRUA3CNet``: the cell's
  input terms of a whole sequence, before the recurrence) and the
  counter ``convgru.input_steps`` (the steps they cover: over the
  span's count, T of the loss replay against 1 of a rollout step).
* ``qlearn.act``, ``qlearn.insert`` (the replay ring), ``qlearn.sgd``
  (a sample and the TD step).
* ``window.launches``: the window kernels launched since the last
  :func:`reset`, from ``ops/window_cuda.launches`` (the launch counter
  ``chip_smoke.py`` and the tests read).
* ``window.block_ticks`` and the phase cycles: while the tracer is on,
  every window launched without a caller's own ``clocks`` adds its
  blocks' cycles of each phase (``window_cuda.PHASES``) to the tracer's
  tensor and blocks x W to this counter, so cycles read per block-tick.

``benchmark/spans.py`` and ``python -m traffic_env_tpu_torch.profiler
--trace=DIR`` (:func:`table`) read them.
"""

from __future__ import annotations

import collections
import time

import torch

_on = False
_stack: list = []
_spans: dict = {}               # name -> [count, host ns, self ns]
_device_s: dict = {}            # name -> [seconds of each instance read]
_pending: list = []             # (name, start event, end event) unread
_pool: list = []                # CUDA events to reuse
_counters: collections.Counter = collections.Counter()
_clocks: dict = {}              # device -> int64 (len(PHASES),) cycles
_launch_base = 0


class _Null:
    """The span of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "rf", "events", "child_ns", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.child_ns = 0
        _stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (_event(), _event())
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
            _pending.append((self.name, *self.events))
        self.rf.__exit__(*exc)
        _stack.pop()
        if _stack:
            _stack[-1].child_ns += dt
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self.child_ns
        return False


def span(name: str):
    """A context manager timing ``name`` while the tracer is on; the
    shared no-op object while it is off."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _on:
        _counters[name] += n


def enable() -> None:
    """Turn the tracer on."""
    global _on
    _on = True


def disable() -> None:
    """Turn the tracer off; what it holds stays until :func:`reset`."""
    global _on
    _on = False


def _launches() -> int:
    from ..ops import window_cuda
    return sum(window_cuda.launches.values())


def reset() -> None:
    """Clear the spans, the counters and the phase cycles, and count
    window launches from here."""
    global _launch_base
    _spans.clear()
    _device_s.clear()
    _pool.extend(e for _, a, b in _pending for e in (a, b))
    _pending.clear()
    _counters.clear()
    for t in _clocks.values():
        t.zero_()
    _launch_base = _launches()


def phase_clocks(device: torch.device, n: int):
    """The tracer's int64 (n,) phase-cycle tensor on ``device`` while the
    tracer is on, else None (``window_cuda.window``)."""
    if not _on:
        return None
    t = _clocks.get(device)
    if t is None:
        t = _clocks[device] = torch.zeros(n, dtype=torch.int64,
                                          device=device)
    return t


def _read_events() -> None:
    """Move the recorded events' times into ``_device_s`` (one wait for
    the device) and the events back to the pool."""
    if not _pending:
        return
    torch.cuda.synchronize()
    for name, a, b in _pending:
        _device_s.setdefault(name, []).append(a.elapsed_time(b) * 1e-3)
        _pool.extend((a, b))
    _pending.clear()


def snapshot(gather: bool = False):
    """What the tracer holds: ``{"spans": {name: {"count", "host_s",
    "self_s", "device_s"}}, "counters": {...}, "phase_cycles": {phase:
    cycles}}``, ``device_s`` each instance's seconds between its events
    (empty without CUDA), a counter only where it is not 0, the phase
    cycles only where a window kept them.  With ``gather`` a list of
    every dp rank's snapshot in rank order (one all-gather; ``[snap]``
    unsharded)."""
    _read_events()
    spans = {name: {"count": c, "host_s": h * 1e-9, "self_s": s * 1e-9,
                    "device_s": list(_device_s.get(name, ()))}
             for name, (c, h, s) in _spans.items()}
    counters = dict(_counters)
    launches = _launches() - _launch_base
    if launches:
        counters["window.launches"] = launches
    cycles = {}
    if _clocks:
        from ..ops.window_cuda import PHASES
        total = sum(t.cpu() for t in _clocks.values())
        if int(total.sum()):
            cycles = dict(zip(PHASES, (int(c) for c in total)))
    snap = {"spans": spans, "counters": counters, "phase_cycles": cycles}
    if not gather:
        return snap
    from .. import parallel
    return parallel.all_gather_object(snap)


def table(snap: dict) -> str:
    """A snapshot as text: a line a span (count, host ms, self ms and
    device ms, all summed), then the counters and the phase cycles (a
    block-tick's with ``window.block_ticks``)."""
    lines = [f"{'span':<24}{'count':>8}{'host ms':>12}{'self ms':>12}"
             f"{'device ms':>12}"]
    for name in sorted(snap["spans"]):
        s = snap["spans"][name]
        dev = f"{sum(s['device_s']) * 1e3:12.3f}" if s["device_s"] \
            else f"{'-':>12}"
        lines.append(f"{name:<24}{s['count']:>8}{s['host_s'] * 1e3:12.3f}"
                     f"{s['self_s'] * 1e3:12.3f}{dev}")
    for name, n in sorted(snap["counters"].items()):
        lines.append(f"{name:<24}{n:>8}")
    cycles = snap["phase_cycles"]
    ticks = snap["counters"].get("window.block_ticks")
    total = sum(cycles.values())
    for phase, c in cycles.items():
        per = f"{c / ticks:12.1f} a block-tick" if ticks else ""
        lines.append(f"cycles {phase:<17}{c / total * 100:7.1f}%{per}")
    return "\n".join(lines)
