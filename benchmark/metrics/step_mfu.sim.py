"""The traced windows' least time on the chip over the traced window's seconds."""

from benchmark.readers import sim_step_mfu as read  # noqa: F401
