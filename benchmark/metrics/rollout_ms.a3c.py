"""ms of one 30-step rollout, by the host clock after a synchronise."""

from benchmark.readers import span_ms

read = span_ms("rollout_s")
