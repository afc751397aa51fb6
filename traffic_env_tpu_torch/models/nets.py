"""Q networks (counterpart of ``traffic_env_tpu/models/nets.py``).

``QNet`` is the double-DQN trunk with a residual block: obs -> 200 relu
-> 200 -> +resid(200) -> relu -> per-intersection Q values of shape
(heads, choices).  ``ConvQNet`` (``--conv_gru`` with qlearn) is the same
residual structure with 3x3 convolutions over the (m, n) intersection
grid in place of the dense layers, on the grid maps of
``obs_grid_channels``.  Their layers are ``nn.Linear`` and ``nn.Conv2d``
(the JAX package leaves them to XLA; no kernel of its own), in float32:
the trainer turns TF32 off (``algorithms/qlearn.py:make_state``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

WIDTH = 200


def _lecun_normal_(weight: torch.Tensor, generator=None) -> None:
    """flax's default Dense and Conv kernel init: variance 1/fan_in
    (inputs times kernel area), normal truncated at two standard
    deviations."""
    fan_in = weight[0].numel()
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


def _frame_width(d: int, v: int) -> int:
    """Observation columns per intersection in one history frame of a
    ``d``-wide flat obs over ``v`` intersections: 13 with
    --occupancy_obs, else 9, preferring 13 when both divide; 0 when
    neither does."""
    return 13 if d % (13 * v) == 0 else 9 if d % (9 * v) == 0 else 0


def obs_grid_channels(flat: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Batch-first flat observation (..., d) -> (..., m, n, C) grid maps.

    A frame is the per-road passed and detected counts (4 directions
    each), the per-intersection phase feature and, with
    --occupancy_obs, four occupancy blocks: 9 or 13 blocks of m * n
    columns, a road's id within a block row * n + col.  With
    --history=k the flat obs is k frames, oldest first, and each frame
    is a channel group: C = 9k or 13k.  When no frame width divides
    ``d`` the maps are 9 channels of zeros, as in the JAX package."""
    v = m * n
    lead = tuple(flat.shape[:-1])
    width = _frame_width(flat.shape[-1], v)
    if not width:
        return flat.new_zeros(lead + (m, n, 9))
    k = flat.shape[-1] // (width * v)
    g = flat.reshape(lead + (k, width, m, n))
    return torch.movedim(g, (-4, -3), (-2, -1)).reshape(
        lead + (m, n, k * width))


class ConvQNet(nn.Module):
    """Grid-native double-DQN trunk: QNet's residual structure with
    weight-shared 3x3 convolutions (``channels`` wide, zero padding 1,
    flax's ``SAME``) over the (m, n) intersection grid and a 1x1 head.
    Flat obs of ``obs_size`` columns in, (batch, m * n, n_choices) Q
    values out.  The weights are drawn from ``generator`` as flax
    initialises Conv layers (lecun normal over kh * kw * C_in, zero
    bias)."""

    def __init__(self, m: int, n: int, obs_size: int, n_choices: int = 2,
                 channels: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.m, self.n, self.n_choices = m, n, n_choices
        width = _frame_width(obs_size, m * n)
        c_in = obs_size // (m * n) if width else 9
        conv3 = lambda c: nn.Conv2d(c, channels, 3, padding=1)
        self.conv = nn.ModuleList([conv3(c_in), conv3(channels),
                                   conv3(channels),
                                   nn.Conv2d(channels, n_choices, 1)])
        for layer in self.conv:
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        b = obs.shape[0]
        g = obs_grid_channels(obs.reshape(b, -1), self.m, self.n)
        x = g.permute(0, 3, 1, 2)                   # NHWC -> NCHW
        c0, c1, c2, c3 = self.conv
        h0 = torch.relu(c0(x))
        h1 = c1(h0)
        resid = c2(torch.relu(h1))
        h2 = torch.relu(h1 + resid)
        q = c3(h2).permute(0, 2, 3, 1)              # (b, m, n, choices)
        return q.reshape(b, self.m * self.n, self.n_choices)
