"""Exploration policies and annealing (counterpart of
``traffic_env_tpu/algorithms/exploration.py``).

* ``anneal``: linear decay from start to end over annealing_episodes,
  stepped once per episode, floored at end, in float32.
* ``softmax_decision``: per-agent argmax over the last axis of a score
  tensor; e-greedy replaces each agent's action with a uniform draw
  with probability eps; boltzman samples softmax(scores / temperature).
* ``sigmoid_decision``: independent Bernoulli heads; e-greedy mixes the
  probabilities toward 0.5, proportional samples the raw sigmoids.
  ``sigmoid_greedy`` rounds them (half to even, as ``jnp.round``), and
  ``entropy`` is the mean Bernoulli score entropy summary.

Random draws come from an explicit ``torch.Generator`` on the scores'
device.  On the ranks of a sharded run (``shard = (env_base,
n_global)``) each rank draws the global batch's shape from a generator
seeded alike on every rank and keeps its own rows, so its envs draw
what they draw in one batch.
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


def sharded_draw(draw, shape, shard: tuple[int, int] | None = None):
    """``draw(shape)``, or on a rank's shard ``(env_base, n_global)``
    of the leading (batch) axis, rows ``env_base ..`` of ``draw`` of the
    global shape."""
    shape = tuple(shape)
    if shard is None or shard[1] == shape[0]:
        return draw(shape)
    base, n_global = shard
    return draw((n_global,) + shape[1:])[base:base + shape[0]]


def softmax_decision(generator: torch.Generator, scores: torch.Tensor,
                     eps: float, mode: str = "e_greedy",
                     shard: tuple[int, int] | None = None) -> torch.Tensor:
    """Explore action (int32) from a (B, ..., n_choices) score tensor;
    ``shard`` as ``sharded_draw``'s."""
    greedy = greedy_from_scores(scores)
    n = scores.shape[-1]
    dev = scores.device
    if mode == "e_greedy":
        rand = sharded_draw(lambda sh: torch.randint(
            0, n, sh, generator=generator, device=dev, dtype=torch.int32),
            greedy.shape, shard)
        cond = sharded_draw(lambda sh: torch.rand(
            sh, generator=generator, device=dev), greedy.shape, shard) < eps
        return torch.where(cond, rand, greedy)
    if mode == "boltzman":
        # Gumbel-max sampling of softmax(scores / temperature)
        u = sharded_draw(lambda sh: torch.rand(
            sh, generator=generator, device=dev), scores.shape, shard)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(scores / eps + gumbel, dim=-1).to(torch.int32)
    raise ValueError(f"Unknown exploration type {mode}")


def sigmoid_decision(generator: torch.Generator, scores: torch.Tensor,
                     eps: float, mode: str = "e_greedy",
                     uniform: torch.Tensor | None = None,
                     shard: tuple[int, int] | None = None) -> torch.Tensor:
    """Bernoulli per-agent heads: int32 0/1, 1 where a uniform draw from
    ``generator`` (or the given ``uniform``) is below the probability,
    for e_greedy ``eps * 0.5 + (1 - eps) * sigmoid(scores)``; ``shard``
    as ``sharded_draw``'s."""
    probs = torch.sigmoid(scores)
    if mode == "e_greedy":
        probs = eps * 0.5 + (1 - eps) * probs
    elif mode != "proportional":
        raise ValueError(f"Unknown exploration type {mode}")
    if uniform is None:
        uniform = sharded_draw(lambda sh: torch.rand(
            sh, generator=generator, device=scores.device), probs.shape,
            shard)
    return (uniform < probs).to(torch.int32)


def sigmoid_greedy(scores: torch.Tensor) -> torch.Tensor:
    """round(sigmoid(scores)) as int32."""
    return torch.round(torch.sigmoid(scores)).to(torch.int32)


def entropy(probs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """-mean(p * log(p + eps))."""
    return -torch.mean(probs * torch.log(probs + eps))
