"""GSpace: multi-agent tensor spaces (counterpart of
``traffic_env_tpu/spaces.py``).

A GSpace is an integer tensor of a given shape with a per-element
exclusive limit; algorithms size their nets from ``size`` and ``limit``,
and wrappers prepend history axes with ``replicated``.  It describes one
env: the batched env's tensors add the env batch as their last axis.
Samples come from a ``torch.Generator`` where the JAX package takes a
PRNG key.
"""

from __future__ import annotations

import numpy as np
import torch


class GSpace:
    def __init__(self, shape, limit, dtype=torch.int32):
        self.shape = tuple(int(s) for s in shape)
        self.limit = limit
        self.dtype = dtype
        self.size = int(np.prod(self.shape)) if self.shape else 1

    def sample(self, generator: torch.Generator | None = None,
               device="cpu"):
        """A uniform sample on ``device`` (the generator's device when a
        generator is given)."""
        if generator is not None:
            device = generator.device
        return torch.randint(0, int(self.limit), self.shape,
                             generator=generator,
                             device=device).to(self.dtype)

    def sample_np(self, rng: np.random.RandomState):
        """Host-side sample with the reference's RandomState semantics."""
        return rng.randint(self.limit, size=self.shape, dtype=np.int32)

    def empty(self, device="cpu"):
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    def to_action(self, a):
        return torch.as_tensor(a).reshape(self.shape).to(self.dtype)

    def contains(self, x):
        return tuple(x.shape) == self.shape

    def replicated(self, n: int) -> "GSpace":
        return GSpace([n, *self.shape], self.limit, self.dtype)

    def __repr__(self):
        return f"GSpace(shape={self.shape}, limit={self.limit})"
