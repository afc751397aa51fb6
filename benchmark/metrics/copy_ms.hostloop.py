"""Device memcpy ms an agent step, host to device and back."""

from benchmark.readers import copy_ms as read  # noqa: F401
