"""Kernels run on the device an agent step, from the trace."""

from benchmark.readers import launches_per_step as read  # noqa: F401
