"""Batched lockstep envs (counterpart of
``traffic_env_tpu/envs/rollout.py``).

Thousands of envs step in lockstep: one agent step is one light period
(``cfg.light_iterations`` ticks) over the whole batch.  ``core="window"``
runs the period as one window call, the CUDA kernel ``csrc/window.cu``
on the card and its plain PyTorch version on the CPU, with the lazy
autoreset folded into the window (the counterpart of
``make_pallas_batched_env``); ``core="fast"`` runs it as W calls of the
per-tick core ``envs/fast_core.py:tick`` in plain torch ops on the same
device (the JAX package's fast core), which also gives the state after
each tick.  Reward shaping and history stacking are plain torch ops on
the small ``(I, B)`` / ``(obs_dim, B)`` outputs (``envs/env.py``).

A CUDA env never falls back to the CPU: it raises when there is no card
or, on the window core, no kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import Config
from ..topology import GridRoad
from .env import EnvFns, EnvState, make_env


class BatchedEnv(NamedTuple):
    """The batched env's functions (``env`` holds them with the spaces).
    On the window core they are not pure: ``reset`` and every lazy step
    update the state's simulator tensors in place (see
    ``make_batched_env``)."""
    env: EnvFns
    n_envs: int
    init: Callable          # generator -> EnvState
    reset: Callable         # (state[, sched, phase, actions]) -> (state, obs)
    step: Callable          # (state, action[, sched]) -> (state, obs, r, d, _)
    step_autoreset: Callable
    step_autoreset_lazy: Callable
    step_autoreset_lazy_noh: Callable
    n_intersections: int
    obs_dim: int
    device: torch.device
    # --exact: the host ScheduleStream behind EnvState.sched
    # (algorithms/common.py:attach_schedule_stream), else None
    sched_stream: object = None
    # the per-tick core's lazy step with its tick stack; None on the
    # window core
    step_autoreset_lazy_ticks: Callable | None = None


def _device(device, core: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "plain PyTorch window")
        if core == "window":
            from ..ops import window_cuda
            window_cuda.load()
    elif dev.type != "cpu":
        raise RuntimeError(f"the batched env runs on cpu or cuda, not {dev}")
    return dev


def make_batched_env(topo: GridRoad, cfg: Config, n_envs: int,
                     on_device_spawns: bool = True,
                     max_spawns_per_tick: int | None = None,
                     device="cuda", archetypes=None,
                     core: str = "window") -> BatchedEnv:
    """The batched env of ``envs/env.py:make_env`` on ``core``.
    ``max_spawns_per_tick`` defaults to 4 with device spawns and 8 with
    schedule rows; ``archetypes`` is a float32 (k, NPARAMS) car table.

    In-place contract of the window core: the window writes the new
    simulator state into the tensors of the state it is given (cars,
    leading, lastcar, phase, elapsed, detected, the spawn stream, steps,
    global tick, done), while ``passed`` and ``rewards`` come back as new
    tensors, and with Remi shaping ``waiting`` and ``passed_dst`` too.
    So after ``step(state, a)`` the old ``state`` holds a mix of old and
    new leaves: a caller that needs the state from before a step (a
    learner that keeps the previous state, a validation that must not
    advance the training env) clones it first.  ``step_autoreset``
    clones for itself.  The per-tick core writes nothing in place."""
    dev = _device(device, core)
    env = make_env(topo, cfg, n_envs, on_device_spawns, max_spawns_per_tick,
                   core, dev, archetypes)
    return BatchedEnv(
        env=env, n_envs=n_envs, init=env.init, reset=env.reset,
        step=env.step, step_autoreset=env.step_autoreset,
        step_autoreset_lazy=env.step_autoreset_lazy,
        step_autoreset_lazy_noh=env.step_autoreset_lazy_noh,
        n_intersections=topo.intersections, obs_dim=env.obs_dim,
        device=dev, step_autoreset_lazy_ticks=env.step_autoreset_lazy_ticks)


def random_rollout(benv: BatchedEnv, state: EnvState,
                   generator: torch.Generator, n_agent_steps: int):
    """Step a uniformly random policy over the batch with lazy
    autoreset; returns (state, generator, mean reward per step, done
    count per step).  One agent step = one light period."""
    I, B = benv.n_intersections, benv.n_envs
    rews, dones = [], []
    for _ in range(n_agent_steps):
        action = torch.randint(0, 2, (I, B), dtype=torch.int32,
                               generator=generator, device=benv.device)
        state, obs, rew, done, _ = benv.step_autoreset_lazy(state, action)
        rews.append(rew.mean())
        dones.append(done.sum())
    return state, generator, torch.stack(rews), torch.stack(dones)


def bind_schedule(benv: BatchedEnv, sched) -> BatchedEnv:
    """Close a host-precomputed SpawnSchedule over every step/reset fn,
    so schedule-driven envs present the no-schedule call surface."""
    pick = lambda s: s if s is not None else sched
    bind = lambda fn: None if fn is None else \
        (lambda st, a, s=None: fn(st, a, pick(s)))
    return benv._replace(
        reset=lambda state, s=None, phase=None, actions=None: benv.reset(
            state, pick(s), phase, actions),
        step=bind(benv.step), step_autoreset=bind(benv.step_autoreset),
        step_autoreset_lazy=bind(benv.step_autoreset_lazy),
        step_autoreset_lazy_noh=bind(benv.step_autoreset_lazy_noh),
        step_autoreset_lazy_ticks=bind(benv.step_autoreset_lazy_ticks))
