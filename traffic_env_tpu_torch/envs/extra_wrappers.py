"""Strobe / Last action-repeat wrappers and the single-agent adapter
(counterpart of ``traffic_env_tpu/envs/extra_wrappers.py``).

``make_strobe`` and ``make_last`` are the reference's StrobeWrapper and
LastWrapper over the per-tick core (``fast_core.make_sim_fast``): an
action held for ``repeat_count`` ticks on a batched state, a finished
lane frozen from its done tick on.  As in the JAX package, Strobe
returns the full ``(num_samples, obs_dim, B)`` history with the rows
after ``done`` frozen, where the reference truncates it.
``ungspace_actions`` is the ``--single_agent`` adapter (UnGSpace): one
integer in [0, 2^n) per env for n binary phase heads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spaces import GSpace
from .fast_core import select

F32 = torch.float32
I32 = torch.int32


def make_strobe(fns, repeat_count: int, num_samples: int, obs_dim: int,
                sum_indices=()):
    """Action repeat with ``num_samples`` evenly spaced obs snapshots;
    indices in ``sum_indices`` accumulate within each sample window, all
    others keep the latest value.  ``step(sim, action, sched=None) ->
    (sim, history, reward_sum, done)``."""
    sample_size = repeat_count // num_samples
    if sample_size * num_samples != repeat_count:
        raise ValueError(f"repeat_count {repeat_count} is not a multiple "
                         f"of num_samples {num_samples}")
    mask = np.zeros(obs_dim, np.float32)
    if len(sum_indices):
        mask[np.asarray(sum_indices)] = 1

    def step(sim, action, sched=None):
        action = action.to(I32)
        dev, B = sim.done.device, sim.done.shape[-1]
        m = torch.as_tensor(mask, device=dev)[:, None]
        done = sim.done
        rows = [torch.zeros((obs_dim, B), dtype=F32, device=dev)
                for _ in range(num_samples)]
        tot = torch.zeros_like(sim.rewards)
        for i in range(repeat_count):
            nxt = fns.tick(sim, action, sched)
            live = ~done
            sim = select(live, nxt, sim)
            obs = fns.obs(sim).to(F32)
            tot = tot + torch.where(live, nxt.rewards, 0.0)
            row = i // sample_size
            upd = obs if i % sample_size == 0 else rows[row] * m + obs
            # frozen lanes keep their history rows
            rows[row] = torch.where(live, upd, rows[row])
            done = done | (live & nxt.done)
        return sim, torch.stack(rows), tot, done

    return step


def make_last(fns, repeat_count: int):
    """Action repeat returning the final tick's obs and the summed
    reward.  ``step(sim, action, sched=None) -> (sim, obs, reward_sum,
    done)``."""

    def step(sim, action, sched=None):
        action = action.to(I32)
        done = sim.done
        tot = torch.zeros_like(sim.rewards)
        for _ in range(repeat_count):
            nxt = fns.tick(sim, action, sched)
            live = ~done
            sim = select(live, nxt, sim)
            tot = tot + torch.where(live, nxt.rewards, 0.0)
            done = done | (live & nxt.done)
        return sim, fns.obs(sim).to(F32), tot, done

    return step


def ungspace_actions(n_heads: int):
    """The --single_agent adapter: ``(space, decode, encode)``.
    ``decode`` maps joint actions (..., 1) to n binary phase heads
    (..., n), int32; ``encode`` maps heads (..., n) back to (..., 1)."""
    space = GSpace([1], 2 ** n_heads)

    def decode(a):
        a = torch.as_tensor(a).to(I32)
        return (a[..., :1] >> torch.arange(n_heads, dtype=I32,
                                           device=a.device)) & 1

    def encode(bits):
        bits = torch.as_tensor(bits).to(I32)
        w = 1 << torch.arange(n_heads, dtype=I32, device=bits.device)
        return torch.sum(bits * w, dim=-1, keepdim=True, dtype=I32)

    return space, decode, encode
