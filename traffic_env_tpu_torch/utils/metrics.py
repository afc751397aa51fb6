"""Training metrics: a JSONL scalar log (always) and TensorBoard events
when ``torch.utils.tensorboard`` can be imported (counterpart of
``traffic_env_tpu/utils/metrics.py``).  Every learner logs its scalars
under the JAX package's names, so dashboards read either package."""

from __future__ import annotations

import json
import os
import time


class MetricWriter:
    def __init__(self, logdir: str, subdir: str = ""):
        self.dir = os.path.join(logdir, subdir) if subdir else logdir
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:     # tensorboard is not installed
            return
        self._tb = SummaryWriter(self.dir)

    def scalar(self, name: str, value, step: int):
        self._f.write(json.dumps({"t": time.time(), "step": int(step),
                                  "name": name, "value": float(value)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), int(step))

    def histogram(self, name: str, values, step: int):
        if self._tb is not None:
            self._tb.add_histogram(name, values, int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """The writer of a rank other than 0 on a sharded run: rank 0 owns
    the metrics, the others write nothing."""

    def scalar(self, name: str, value, step: int):
        pass

    def histogram(self, name: str, values, step: int):
        pass

    def close(self):
        pass
