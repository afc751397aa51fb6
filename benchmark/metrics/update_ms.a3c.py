"""ms of one update, by CUDA events around it."""

from benchmark.readers import span_ms

read = span_ms("update_s")
