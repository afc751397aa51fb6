"""Streaming episode statistics and validation artifacts (counterpart of
``traffic_env_tpu/utils/stats.py``): the validate-mode telemetry series
saved as .npy beside ``hist.png``, the JAX package's three stacked
histograms.  matplotlib is imported only to draw, with the Agg backend;
where it does not import, the .npy files are still written and one line
says that the plot was not drawn.

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


def make_plot(cfg, light_times, trip_times, unfinished):
    """Three stacked histograms with dashed mean markers, titled by
    trainer (the JAX package's hist.png layout).  Raises ImportError
    without matplotlib."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(6.4, 4.8))
    fig.suptitle("Stats for " + cfg.trainer, fontweight="bold",
                 fontsize=14)
    fig.subplots_adjust(hspace=0.5)
    panels = [("Light Times", light_times), ("Trip Times", trip_times),
              ("Unfinished", unfinished)]
    for ax, (title, data) in zip(axes, panels):
        ax.set_title(title)
        if len(data):
            ax.hist(data, color="c")
            ax.axvline(float(np.mean(data)), color="b",
                       linestyle="dashed", linewidth=2)
    return fig


def _plot_or_none(cfg, light_times, trip_times, unfinished):
    """``make_plot``'s figure, or None with one line saying why, where
    matplotlib does not import."""
    try:
        return make_plot(cfg, light_times, trip_times, unfinished)
    except ImportError as e:
        print(f"hist.png not drawn: matplotlib does not import ({e})")
        return None


def write_data(cfg, light_times, trip_times, unfinished, outdir="."):
    """Persist the validation artifacts: one .npy per telemetry series,
    and hist.png where matplotlib imports."""
    series = {"light_times": light_times, "trip_times": trip_times,
              "unfinished": unfinished}
    for name, data in series.items():
        np.save(os.path.join(outdir, name + ".npy"), data)
    fig = _plot_or_none(cfg, light_times, trip_times, unfinished)
    if fig is not None:
        import matplotlib.pyplot as plt
        fig.savefig(os.path.join(outdir, "hist.png"))
        plt.close(fig)


def display_data(cfg, light_times, trip_times, unfinished):
    """Interactive summary: the histogram figure (Agg, returned rather
    than shown; None without matplotlib) and a mean/mode/std line per
    telemetry series."""
    fig = _plot_or_none(cfg, light_times, trip_times, unfinished)
    for name, data in (("Light times", light_times),
                       ("Trip times", trip_times),
                       ("Unfinished", unfinished)):
        if not len(data):
            continue
        arr = np.asarray(data)
        vals, counts = np.unique(arr, return_counts=True)
        mode = float(vals[np.argmax(counts)])
        print("%s mean %2f, mode %2f, std %2f"
              % (name, float(np.mean(arr)), mode, float(np.std(arr))))
    return fig
