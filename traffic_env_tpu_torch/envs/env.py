"""Env-layer state and reward mixing (counterparts of
``traffic_env_tpu/envs/env.py:43-90``).

Rewards and observations are batch-trailing: ``(I, B)`` and
``(obs_dim, B)``.  The ordered sums and the clamp between the two
reciprocal multiplies keep the JAX package's rounding bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .structs import SimState

FMAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class EnvState:
    sim: SimState
    history: torch.Tensor   # f32 (history, obs_dim, B) rolling window
    # schedule-mode arrival window carried in the state (None when the
    # schedule is passed explicitly or spawns are drawn on the device)
    sched: object = None

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "EnvState":
        """A copy whose simulator state and history share no tensor with
        this one (the read-only schedule is shared)."""
        return self.replace(sim=self.sim.clone(), history=self.history.clone())


def _ordered_mean(vec: torch.Tensor, n: int) -> torch.Tensor:
    """Left-to-right float32 mean over the leading axis of length ``n``,
    the division defined as a reciprocal multiply."""
    s = vec[0]
    for j in range(1, n):
        s = s + vec[j]
    return s * float(np.float32(1.0 / n))


def localize_reward(rew: torch.Tensor, weight: int, n: int) -> torch.Tensor:
    """Reward mixing: ((w-1)*r_self + sum(r)) * (1/n) * (1/w) per
    intersection, as the diagonal construction with ordered summation.
    ``rew`` (n, B)."""
    fin = lambda p: torch.clamp(p, -FMAX, FMAX)
    eye = torch.eye(n, dtype=torch.bool, device=rew.device)[:, :, None]
    diag = torch.where(eye, rew[:, None, :], 0.0)
    d = fin(diag * float(np.float32(weight - 1)))
    m = d + rew[None, :, :]
    s = m[:, 0]
    for j in range(1, n):
        s = s + m[:, j]
    return fin(s * float(np.float32(1.0 / n))) \
        * float(np.float32(1.0 / weight))
