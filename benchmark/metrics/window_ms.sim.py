"""Device ms of the window kernel a launch, in the dispatch loop."""

from benchmark.readers import window_ms as read  # noqa: F401
