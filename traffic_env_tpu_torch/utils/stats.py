"""Streaming episode statistics and validation artifacts (counterpart of
``traffic_env_tpu/utils/stats.py``, numpy only: the hist.png plot of
the JAX package is not drawn; the telemetry series are saved as .npy).

Output format kept verbatim so that log parsers read either package:

    Reward %2f\t Mean %2f\t Std %2f
    One prob: %2f,\t Zero prob: %2f
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np


def forever(f):
    while True:
        yield f()


@dataclasses.dataclass
class _Telemetry:
    """Validate-mode accumulators drained from episode info dicts."""
    light_times: list = dataclasses.field(default_factory=list)
    trip_times: list = dataclasses.field(default_factory=list)
    unfinished: list = dataclasses.field(default_factory=list)

    def absorb(self, info: dict) -> None:
        self.light_times.extend(info.get("light_times", ()))
        self.trip_times.extend(info.get("trip_times", ()))
        if "unfinished" in info:
            self.unfinished.append(info["unfinished"])

    def as_tuple(self):
        return (self.light_times, self.trip_times, self.unfinished)


class Welford:
    """Online mean and variance (Welford 1962)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def push(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self._m2 += delta * (x - self.mean)

    @property
    def std(self) -> float:
        return math.sqrt(self._m2 / (self.n - 1)) if self.n > 1 else 0.0


def print_running_stats(episodes, max_iterations=None):
    """Consume an iterator of (reward, info) pairs, printing the
    streaming reward statistics after each episode, until the iterator
    ends, ``max_iterations`` is reached, or the user interrupts.
    Returns the accumulated (light_times, trip_times, unfinished)
    telemetry (empty lists outside validate mode)."""
    stats = Welford()
    telemetry = _Telemetry()
    try:
        for reward, info in episodes:
            stats.push(reward)
            print("Reward %2f\t Mean %2f\t Std %2f"
                  % (reward, stats.mean, stats.std))
            if info:
                print("One prob: %2f,\t Zero prob: %2f"
                      % (info["onep"], info["zerop"]))
                telemetry.absorb(info)
            if max_iterations is not None and stats.n >= max_iterations:
                break
    except (KeyboardInterrupt, StopIteration):
        print("Interrupted")
    return telemetry.as_tuple()


def write_data(cfg, light_times, trip_times, unfinished, outdir="."):
    """Persist the validation telemetry, one .npy per series."""
    series = {"light_times": light_times, "trip_times": trip_times,
              "unfinished": unfinished}
    for name, data in series.items():
        np.save(os.path.join(outdir, name + ".npy"), data)
