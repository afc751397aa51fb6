"""ms of one update's dp gradient all-reduce, by CUDA events around each
``torch.distributed.all_reduce`` call, the slowest rank's."""

from benchmark.readers import span_ms

read = span_ms("allreduce_s")
