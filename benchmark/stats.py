"""The arithmetic of the end-to-end metrics: rates over a whole window
and the nearest-rank percentile over every sample."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work per second over all the work and all the seconds of a
    window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value that at least ``q`` % of them do not exceed."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]

