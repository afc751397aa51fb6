"""Exploration policies and annealing (counterpart of
``traffic_env_tpu/algorithms/exploration.py``; the sigmoid helpers of
the policy-gradient learners are not ported yet).

* ``anneal``: linear decay from start to end over annealing_episodes,
  stepped once per episode, floored at end, in float32.
* ``softmax_decision``: per-agent argmax over the last axis of a score
  tensor; e-greedy replaces each agent's action with a uniform draw
  with probability eps; boltzman samples softmax(scores / temperature).

Random draws come from an explicit ``torch.Generator`` on the scores'
device.
"""

from __future__ import annotations

import numpy as np
import torch


def anneal(start: float, end: float, annealing_episodes: float,
           episode: int) -> float:
    """Value after ``episode`` per-episode decay steps, computed in
    float32 as the JAX package computes it."""
    step = np.float32((start - end) / annealing_episodes)
    val = np.float32(start) - step * np.float32(episode)
    return float(np.maximum(np.float32(end), val))


def exploration_param(cfg, episode: int) -> float:
    """The annealed exploration knob: the epsilon schedule for
    e_greedy/proportional, the temperature schedule (start_temp ->
    end_temp) for boltzman."""
    if cfg.exploration == "boltzman":
        return anneal(cfg.start_temp, cfg.end_temp,
                      cfg.annealing_episodes, episode)
    return anneal(cfg.start_eps, cfg.end_eps, cfg.annealing_episodes,
                  episode)


def greedy_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """argmax over the trailing action axis (the first maximum on
    ties, as jnp.argmax)."""
    return torch.argmax(scores, dim=-1).to(torch.int32)


def softmax_decision(generator: torch.Generator, scores: torch.Tensor,
                     eps: float, mode: str = "e_greedy") -> torch.Tensor:
    """Explore action (int32) from a (..., n_choices) score tensor."""
    greedy = greedy_from_scores(scores)
    n = scores.shape[-1]
    dev = scores.device
    if mode == "e_greedy":
        rand = torch.randint(0, n, greedy.shape, generator=generator,
                             device=dev, dtype=torch.int32)
        cond = torch.rand(greedy.shape, generator=generator,
                          device=dev) < eps
        return torch.where(cond, rand, greedy)
    if mode == "boltzman":
        # Gumbel-max sampling of softmax(scores / temperature)
        u = torch.rand(scores.shape, generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(scores / eps + gumbel, dim=-1).to(torch.int32)
    raise ValueError(f"Unknown exploration type {mode}")
