"""The arithmetic of the per-layer metrics, over the readings a driver
hands back from a ``--trace 1`` run: ``trace`` (``benchmark/trace.py``),
the agent ``steps`` traced and, per driver, the counted bytes and
operations of the traced windows or the learner's spans and FLOPs.
Each returns None when the run has nothing to read, never 0 for a
share."""

from __future__ import annotations

from .roofline import PEAK_F32_PER_S, least_seconds

WINDOW_KERNEL = "window_kernel"


def _trace(r: dict):
    """The run's trace, or None when it saw nothing run on the device."""
    t = r.get("trace")
    return t if t is not None and t.busy_s > 0 else None


def window_ms(r: dict):
    """Device ms of the window kernel a launch."""
    t = _trace(r)
    if t is None:
        return None
    sec, n = t.kernel(WINDOW_KERNEL)
    return sec / n * 1e3 if n else None


def window_roofline(r: dict):
    """The traced windows' least time (their counted bytes at the
    bandwidth, or their IDM operations at the float32 peak) over the
    window kernel's device time, in %."""
    t = _trace(r)
    if t is None or "window_bytes" not in r:
        return None
    sec, n = t.kernel(WINDOW_KERNEL)
    if not n or sec <= 0:
        return None
    return least_seconds(r["window_bytes"], r["window_ops"]) / sec * 100


def sim_step_mfu(r: dict):
    """The traced windows' least time over the traced window's seconds,
    in %."""
    t = _trace(r)
    if t is None or "window_bytes" not in r:
        return None
    return least_seconds(r["window_bytes"], r["window_ops"]) \
        / t.window_s * 100


def launches_per_step(r: dict):
    t = _trace(r)
    return t.launches / r["steps"] if t is not None and r.get("steps") \
        else None


def copy_ms(r: dict):
    """Device memcpy ms an agent step."""
    t = _trace(r)
    return t.copy_s / r["steps"] * 1e3 if t is not None and r.get("steps") \
        else None


def idle_share(r: dict):
    """The part of the traced window in which nothing ran on the
    device, in %."""
    t = _trace(r)
    if t is None or t.window_s <= 0:
        return None
    return max(0.0, 1.0 - t.busy_s / t.window_s) * 100


def span_ms(name: str):
    """The mean of a learner span's seconds, in ms."""
    def read(r: dict):
        spans = r.get(name)
        return sum(spans) / len(spans) * 1e3 if spans else None
    return read


def learner_step_mfu(r: dict):
    """The timed windows' model FLOPs over their seconds at the peak of
    the precision the nets run in, in %."""
    if not r.get("flops") or not r.get("timed_s"):
        return None
    return r["flops"] / (r["timed_s"] * r.get("peak", PEAK_F32_PER_S)) * 100
