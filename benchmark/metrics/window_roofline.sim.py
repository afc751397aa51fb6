"""The window kernel's share of its roofline: the counted bytes of the traced windows at 3.35 TB/s over its device time."""

from benchmark.readers import window_roofline as read  # noqa: F401
