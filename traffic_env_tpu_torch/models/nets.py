"""Q networks (counterpart of ``traffic_env_tpu/models/nets.py``).

``QNet`` is the double-DQN trunk with a residual block: obs -> 200 relu
-> 200 -> +resid(200) -> relu -> per-intersection Q values of shape
(heads, choices).  Its dense layers are ``nn.Linear`` (the JAX package
leaves them to XLA; no kernel of its own).  ``ConvQNet`` (5x5 grids) is
not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

WIDTH = 200


def _lecun_normal_(weight: torch.Tensor, generator=None) -> None:
    """flax's default Dense kernel init: variance 1/fan_in, normal
    truncated at two standard deviations."""
    fan_in = weight.shape[1]
    # 0.8796... is the std of the unit normal truncated to (-2, 2)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class QNet(nn.Module):
    """Returns (batch, n_actions, n_choices) Q values from a batch-first
    observation of any trailing shape (flattened).  ``n_choices=2`` is
    the per-intersection phase pair; ``--single_agent`` uses one head
    with 2^I choices.  The weights are drawn from ``generator`` as flax
    initialises Dense layers (lecun normal, zero bias)."""

    def __init__(self, obs_size: int, n_actions: int, n_choices: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_actions, self.n_choices = n_actions, n_choices
        self.dense = nn.ModuleList([
            nn.Linear(obs_size, WIDTH), nn.Linear(WIDTH, WIDTH),
            nn.Linear(WIDTH, WIDTH),
            nn.Linear(WIDTH, n_actions * n_choices)])
        for layer in self.dense:
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1)
        d0, d1, d2, d3 = self.dense
        h0 = torch.relu(d0(x))
        h1 = d1(h0)
        resid = d2(torch.relu(h1))
        h2 = torch.relu(h1 + resid)
        return d3(h2).reshape(-1, self.n_actions, self.n_choices)
