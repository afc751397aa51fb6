"""The learner's model FLOPs over its seconds at the float32 peak."""

from benchmark.readers import learner_step_mfu as read  # noqa: F401
