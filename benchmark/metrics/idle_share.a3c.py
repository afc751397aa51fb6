"""The part of the traced window with nothing on the device."""

from benchmark.readers import idle_share as read  # noqa: F401
